"""The comparison that decides `correct`.

Each fit checked is held against the plain reference (reference/gvamp.py),
run from the same codes, phenotype, prior and probes.  The numbers, each
the largest over the fits checked, of gaps |program - reference| / max(1,
|reference|) (`gap`), of which a cell compares those its limits file lists:

  * `head_gap`: the metrics rows of the first `head_iterations` iterations
    (the limits file's) against the reference's.  At these designs' M/N
    (~100) the EM recursion collapses at iteration 4, and from there the
    trajectory moves with the last bits of its arithmetic, so no reference
    follows the float32 program far past it.  The first rows depend on
    every layer of the step: A^T y, the Gram and its eigenbasis (or CG),
    the passes over the design, the denoiser, the EM update of the prior
    (from iteration 2) and the noise precision.
  * `tail_gap`: the last iteration's row against what the returned x1 gives
    (gvamp.tail_row: R2 and correlation of A x1 with y, correlation of x1
    with the true signal), which holds at any iteration: the returned x1
    and the last pass over the design.
  * `state_gap`: where the reference follows every iteration of the fits
    (head_iterations = the fit's iterations, as in a fit cut to the
    iterations before the collapse), the returned state against the
    reference's: the relative distance of x1 and of r1, and the relative
    gaps of gam1 and gamw.

A fit that raised, returned values that are not finite, or stopped before
its iterations, failed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference import gvamp

TAIL = [0, 1, 4]  # the entries of a metrics row that gvamp.tail_row works out


class Inputs(NamedTuple):
    """What a fit was given, and so the reference too."""
    y: np.ndarray
    beta: np.ndarray
    probs: list
    vars: list
    probe_seed: int | None  # the engine's probes, where CG ran


def gap(prog_row, ref_row) -> float:
    p = np.asarray(prog_row, dtype=np.float64)
    r = np.asarray(ref_row, dtype=np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(1.0, np.abs(r))))


def answer_of(res) -> gvamp.Answer:
    """The engine's LinearResult as the reference's Answer."""
    return gvamp.Answer(rows=np.asarray(res.metrics_history),
                        x1=torch.as_tensor(res.x1_hat_scaled), r1=torch.as_tensor(res.r1_scaled),
                        gam1=float(res.gam1), gamw=float(res.gamw))


def _distance(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / (den if den > 0 else 1.0)


def state_gap(a: gvamp.Answer, r: gvamp.Answer) -> float:
    return max(_distance(a.x1, r.x1), _distance(a.r1, r.r1),
               abs(a.gam1 - r.gam1) / abs(r.gam1), abs(a.gamw - r.gamw) / abs(r.gamw))


class Reference:
    """The reference (precision "f64") or the control ("tf32") over a
    design: its Gram diagonalized once, then the first iterations of each
    fit."""

    def __init__(self, codes: torch.Tensor, packed: bool, precision: str = "f64"):
        self.design = gvamp.Design(codes, packed, precision)
        self.eig = gvamp.eigen_of(self.design.gram())

    def fits(self, inputs: list, h2: float, k: int) -> list:
        """The Answer after the first k iterations of each fit in `inputs`."""
        return [gvamp.run(self.design, self.eig, torch.as_tensor(i.y), torch.as_tensor(i.beta),
                          gvamp.Prior(i.probs, i.vars), iterations=k, h2=h2,
                          probe_seed=i.probe_seed)
                for i in inputs]

    def tail(self, a: gvamp.Answer, i: Inputs) -> list:
        return gvamp.tail_row(self.design, a.x1, torch.as_tensor(i.y), torch.as_tensor(i.beta))


def per_iteration(answers: list, follow: list, k: int) -> list:
    """The largest row gap over the fits of each of the first k iterations."""
    return [max(gap(a.rows[i], f.rows[i]) for a, f in zip(answers, follow)) for i in range(k)]


def readings(answers: list, inputs: list, ref: Reference, h2: float, k: int,
             follow: list | None = None) -> dict:
    """The compared numbers of the fits `answers` (program's or control's)
    of `inputs`; `follow`, the reference's first k iterations of them, is
    worked out where not given."""
    if follow is None:
        follow = ref.fits(inputs, h2, k)
    out = {"head_gap": max(per_iteration(answers, follow, k)),
           "tail_gap": max(gap(np.asarray(a.rows[-1])[TAIL], ref.tail(a, i))
                           for a, i in zip(answers, inputs))}
    if all(len(a.rows) == k for a in answers):
        out["state_gap"] = max(state_gap(a, f) for a, f in zip(answers, follow))
    return out


def finite_and_whole(res, iterations: int) -> bool:
    """The fit ran all its iterations and returned finite values."""
    vals = [res.x1_hat_scaled, res.r1_scaled, np.asarray(res.metrics_history),
            np.asarray([res.gam1, res.gamw])]
    return res.iterations_run == iterations and all(bool(np.all(np.isfinite(v))) for v in vals)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {name: {"value": values.get(name, math.nan), "limit": lim}
           for name, lim in limits["limits"].items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
