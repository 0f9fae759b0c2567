# Copied from vampomi_tpu/utils/telemetry.py, its rank check on torch.distributed's rank (sharding.is_writer);
# the spans and the counted passes are the port's own.
"""Per-iteration tracing: spans over the engines' phases, and the passes
over the design counted where they happen.

The reference instruments each phase with MPI_Wtime prints and a
total_comp_time accumulator (src/vamp.cpp:154-174, 285-333, 395-403; SURVEY
§5.1).  Here a `span` names a phase: it always takes the phase's host wall
on the monotonic clock, into the record of the iteration in progress or
into a dict the caller gives; while torch.profiler records, it also enters
`record_function("vampomi.<name>")`, so the phase shows in the profiler's
Chrome trace as a user annotation on the clock of the kernels it launches.
With the profiler off a span is one flag test and two clock reads.  Spans
never synchronise.

Each engine iteration records an `IterationTelemetry`: its wall, its CG
steps, the passes over X that `ops/operator.py` counted during it and the
bytes they read, its phases' walls, and what the engine's own counters
counted during it (the probe draws).  The engine stops the clock after
the iteration's one batched host fetch of its scalars, which waits for the
device, so `seconds` is wall time of finished work.  Records are printed
humanely and optionally appended to `<out>_trace.jsonl`.

A span on another thread (the IO thread writing an iteration's artifacts)
is given the record of its own iteration as `into`, never the iteration in
progress on the main thread, and the engine folds those records into the
iterations' phases once that thread is done (`Tracer.fold`).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field

import torch.autograd.profiler as _prof

from ..sharding import is_writer

# ns walls, by span name, of the iteration in progress in this process
# (Tracer.start opens it, Tracer.stop closes it); None outside iterations
_open: dict | None = None


class span:
    """`with span(name[, into]):` times a phase.  Its seconds go to
    `into[name]` when `into` is given, else are added to `name` in the
    record of the iteration in progress (a span entered several times an
    iteration sums), else nowhere; `.seconds` holds them after the block."""

    __slots__ = ("name", "into", "seconds", "_t0", "_rf")

    def __init__(self, name: str, into: dict | None = None):
        self.name = name
        self.into = into
        self._rf = None

    def __enter__(self):
        if _prof._is_profiler_enabled:
            self._rf = _prof.record_function("vampomi." + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.seconds = ns * 1e-9
        if self.into is not None:
            self.into[self.name] = self.seconds
        elif _open is not None:
            _open[self.name] = _open.get(self.name, 0) + ns
        return False


@dataclass
class IterationTelemetry:
    iteration: int
    seconds: float
    cg_iters: int
    matrix_passes: int      # full reads of the design, counted at the operator
    bytes_moved: int        # those passes times the stored design's bytes
    extra: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)  # {span: seconds}, "passes" and the counters


class Tracer:
    """The iterations of one engine run.  `passes()` reads the process's
    count of passes over the design, `x_bytes` is what one pass reads;
    each of `counters` ({name: a function reading a running count}) puts
    the iteration's increase of its count in the phases under its name."""

    def __init__(self, path: str | None, passes, x_bytes: int, counters: dict | None = None):
        self.path = path if is_writer() else None  # rank 0 writes the trace
        self.passes = passes
        self.x_bytes = int(x_bytes)
        self.counters = counters or {}
        self.records: list[IterationTelemetry] = []
        self.total_comp_time = 0.0
        self._iteration = None
        if self.path and os.path.exists(self.path):
            os.remove(self.path)

    def start(self):
        """Open an iteration: its record and its `iteration` span."""
        global _open
        _open = {}
        self._p0 = self.passes()
        self._c0 = {name: read() for name, read in self.counters.items()}
        self._iteration = span("iteration").__enter__()

    def stop(self, iteration: int, cg_iters: int, **extra) -> IterationTelemetry:
        global _open
        it, self._iteration = self._iteration, None
        it.__exit__(None, None, None)
        walls, _open = _open, None
        passes = self.passes() - self._p0
        phases = {name: ns * 1e-9 for name, ns in walls.items()}  # "iteration" among them
        phases["passes"] = passes
        for name, read in self.counters.items():
            phases[name] = read() - self._c0[name]
        self.total_comp_time += phases["iteration"]
        rec = IterationTelemetry(
            iteration=iteration,
            seconds=phases["iteration"],
            cg_iters=cg_iters,
            matrix_passes=passes,
            bytes_moved=passes * self.x_bytes,
            extra=extra,
            phases=phases,
        )
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(asdict(rec)) + "\n")
        return rec

    def fold(self, late: dict) -> None:
        """Add to each iteration's phases what another thread recorded for
        it, `late` {iteration: {name: value}}, once that thread is done;
        the trace file is written again with them."""
        if not late:
            return
        for rec in self.records:
            rec.phases.update(late.get(rec.iteration, {}))
        if self.path:
            with open(self.path, "w") as f:
                f.writelines(json.dumps(asdict(rec)) + "\n" for rec in self.records)

    def close(self):
        """End an iteration left open by a raise, recording nothing."""
        global _open
        if self._iteration is not None:
            self._iteration.__exit__(None, None, None)
            self._iteration, _open = None, None

    def line(self, rec: IterationTelemetry) -> str:
        """The log line of an iteration: its wall, passes and phases."""
        walls = ", ".join(f"{k} {1e3 * v:.2f}" for k, v in rec.phases.items()
                          if k not in ("iteration", "passes", *self.counters))
        return (f"iteration time = {rec.seconds:.3f}s  ({rec.matrix_passes} matrix passes; "
                f"ms: {walls})  total = {self.total_comp_time:.3f}s")
