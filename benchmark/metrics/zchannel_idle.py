"""zchannel_idle: the card's idle share inside the probit z-channel of the
traced fit: over the program's `vampomi.zdenoise` and `vampomi.zlmmse`
annotations from the start of its second `vampomi.iteration` on, the time
no kernel, copy or set ran (the union of the profiler's device intervals,
trace.py's helpers, each cut to the annotations) over the annotations'
time; nothing where the trace holds no such annotation past the first
iteration."""

import bisect

from benchmark.trace import busy_intervals, device_spans

SPANS = ("vampomi.zdenoise", "vampomi.zlmmse")


def _annotations(events, names):
    return sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") in names)


def read(run):
    if not run.events:
        return None
    iterations = _annotations(run.events, ("vampomi.iteration",))
    if len(iterations) < 2:
        return None
    spans = [s for s in _annotations(run.events, SPANS) if s[0] >= iterations[1][0]]
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
