"""loop_idle: the card's idle share inside the engine loop of the traced
fit: over the program's `vampomi.iteration` annotations of iterations
2.., the time no kernel, copy or set ran (the union of the profiler's
device intervals, trace.py's helpers, each cut to the spans) over the
spans' time; nothing where the trace holds fewer than two iterations."""

import bisect

from benchmark.trace import busy_intervals, device_spans

SPAN = "vampomi.iteration"


def read(run):
    if not run.events:
        return None
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in run.events
                   if e.get("cat") == "user_annotation" and e.get("name") == SPAN)[1:]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    busy = busy_intervals(device_spans(run.events))  # disjoint, sorted
    starts = [t0 for t0, _ in busy]
    covered = 0.0
    for a, b in spans:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return 100.0 * (1.0 - covered / total)
