# Copied from vampomi_tpu/utils/telemetry.py, without the jax rank check: the port is single-process.
"""Per-iteration tracing: phase wall-clock + matvec-throughput counters.

The reference instruments each phase with MPI_Wtime prints and a
total_comp_time accumulator (src/vamp.cpp:154-174, 285-333, 395-403; SURVEY
§5.1).  Here each engine iteration records a structured
`IterationTelemetry`: wall time, CG iteration count, estimated device-memory
bytes moved over the design matrix, and the implied GB/s.  Records are
printed humanely and optionally appended to `<out>_trace.jsonl` for machine
consumption.

The engine stops the clock after the iteration's one batched host fetch of
its scalars, which waits for the device, so `seconds` is wall time of
finished work.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field


@dataclass
class IterationTelemetry:
    iteration: int
    seconds: float
    cg_iters: int
    matrix_passes: int      # full reads of the M×N design matrix
    bytes_moved: int
    gbps: float
    extra: dict = field(default_factory=dict)


def estimate_passes(cg_iters: int, model: str = "linear", solver: str = "cg") -> int:
    """Full passes over the M×N matrix per engine iteration.

    Multi-RHS CG: each body step is one ax_batch + one atx_batch = 2 passes
    (shared by both RHS columns), plus 2 for the initial residual.  Around
    the solve: atx(y) [1], ax(x1) [1], ax(x2) + atx(ax(invq)) [3], metrics
    ax [1] (linear) or the probit engine's extra Ax calls [4].

    Spectral solver (linear): ax_batch([x1, v]) [1] + atx(q) [1] — two
    passes per iteration, period (ops/spectral.py; z2 is algebraic).
    Probit: ax_batch([z1_pred, v]) [1] + atx(p2) [1] + atx(q) [1].
    """
    if solver in ("spectral", "eigen"):
        # eigen shares the spectral pass structure: the dense work moves
        # from a per-iteration factor to the eigenbasis, X passes unchanged
        return 2 if model == "linear" else 3
    around = 6 if model == "linear" else 8
    return 2 * (cg_iters + 1) + around


class Tracer:
    def __init__(self, path: str | None = None, model: str = "linear",
                 solver: str = "cg"):
        self.path = path
        self.model = model
        self.solver = solver
        self.records: list[IterationTelemetry] = []
        self.total_comp_time = 0.0
        self._t0 = None
        if self.path and os.path.exists(self.path):
            os.remove(self.path)

    def start(self):
        self._t0 = time.time()

    def stop(self, iteration: int, cg_iters: int, m: int, n: int, itemsize: int,
             **extra) -> IterationTelemetry:
        dt = time.time() - self._t0
        self.total_comp_time += dt
        passes = estimate_passes(cg_iters, self.model, self.solver)
        bytes_moved = passes * m * n * itemsize
        rec = IterationTelemetry(
            iteration=iteration,
            seconds=dt,
            cg_iters=cg_iters,
            matrix_passes=passes,
            bytes_moved=bytes_moved,
            gbps=bytes_moved / dt / 1e9 if dt > 0 else 0.0,
            extra=extra,
        )
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(asdict(rec)) + "\n")
        return rec

    def summary(self) -> dict:
        if not self.records:
            return {}
        return dict(
            iterations=len(self.records),
            total_seconds=self.total_comp_time,
            mean_gbps=sum(r.gbps for r in self.records) / len(self.records),
            total_cg_iters=sum(r.cg_iters for r in self.records),
        )
