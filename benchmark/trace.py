"""Reading the profiler's Chrome trace of a window: the card's busy time,
the kernels that read the design, and the breakdown of where the time went.

The busy time is the union of the card's kernel, copy and set intervals,
so overlapping streams count once (as the port's chip_smoke.py
device_busy computes it).  An idle gap is named after the innermost host
operation running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
TOP = 10
WALK = 10_000  # host operations looked back over for the one running in a gap


def device_spans(events: list) -> list[tuple[float, float, str]]:
    """(start, end, name) in microseconds of every device operation."""
    return sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                  for e in events if e.get("cat") in DEVICE_CATS)


def busy_intervals(spans) -> list[tuple[float, float]]:
    """The union of the spans, as disjoint sorted intervals."""
    out = []
    for a, b, _ in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def window_us(events: list) -> tuple[float, float]:
    """First and last microsecond of the trace's timed events."""
    timed = [e for e in events if e.get("ph") == "X"]
    return (min(e["ts"] for e in timed), max(e["ts"] + e.get("dur", 0) for e in timed))


def busy_and_window_s(events: list) -> tuple[float, float]:
    """(seconds the card ran an operation, seconds of the traced window)."""
    busy = sum(b - a for a, b in busy_intervals(device_spans(events)))
    t0, t1 = window_us(events)
    return busy / 1e6, (t1 - t0) / 1e6


def matches(name: str, kernel: dict) -> bool:
    """The kernel's name holds every substring of the file's "match"."""
    return all(s in name for s in kernel["match"])


def xpass_launches(events: list, kernels: list[dict]) -> tuple[int, float]:
    """(passes over the design, seconds of the kernels that make them) in
    the trace: a kernel named by a pattern file adds its duration, and its
    file's x_reads passes a launch."""
    passes, secs = 0, 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in kernels:
            if matches(e.get("name", ""), k):
                passes += int(k["x_reads"])
                secs += e.get("dur", 0) / 1e6
                break
    return passes, secs


def top_device_ops(events: list) -> list:
    """The device operations that took most time: [[name, seconds], ...]."""
    total = defaultdict(float)
    for a, b, name in device_spans(events):
        total[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(events: list) -> list:
    """The card's idle time within the window by the host operation it
    waited on: [[name, seconds], ...], the largest first."""
    busy = busy_intervals(device_spans(events))
    t0, t1 = window_us(events)
    gaps = [(a, b) for a, b in zip([t0] + [e for _, e in busy], [s for s, _ in busy] + [t1])
            if b > a]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("ph") == "X")
    starts = [h[0] for h in host]
    total = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "no host operation"
        # nested operations: the latest to start of those still running
        # is the innermost
        hi = bisect.bisect_right(starts, mid)
        for i in range(hi - 1, max(-1, hi - 1 - WALK), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        total[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
