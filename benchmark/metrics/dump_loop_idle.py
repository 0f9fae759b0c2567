"""dump_loop_idle: the card's idle share inside the engine loop of the
traced fit of a cell whose fits write their dumps, read as loop_idle reads
it (the `vampomi.iteration` annotations of iterations 2..); nothing where
the trace holds no `vampomi.dump.stage` annotation (a program from before
the output pipeline's spans)."""

from benchmark.metrics.loop_idle import read as loop_idle

SPAN = "vampomi.dump.stage"


def read(run):
    if not run.events or not any(e.get("cat") == "user_annotation" and e.get("name") == SPAN
                                 for e in run.events):
        return None
    return loop_idle(run)
