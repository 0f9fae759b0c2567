"""The linear model: what a run of a configuration with `"model": "linear"`
does that depends on the model.

The pool: a phenotype plants one causal marker per `markers_per_causal`
(the traffic's) with effects N(0, h2/causal) in file units, adds N(0, 1 -
h2) noise and scales y to unit sample variance (as the port's phenotype
reader does), so that y = A beta + e holds for the standardized design.
Every phenotype has its own causal set and noise.

The fit: one call of the port's entry, `vampomi_tpu_torch.engine.linear.
infere_linear(dm, y, cfg, true_signal=beta, write_outputs=False)`: A^T y,
the LMMSE factor (the Gram, and under eigen its eigh) and the fit's
iterations, with no files written.

The reference: the plain gVAMP of reference/gvamp.py, run from the same
codes, phenotype, prior and probes.  The compared numbers, each the largest
over the fits checked, of gaps |program - reference| / max(1, |reference|)
(`check.gap`), of which a cell compares those its limits file lists:

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

from benchmark.check import gap, per_iteration
from benchmark.design import subseed
from benchmark.reference import gvamp
from benchmark.reference.gvamp import unpack_codes

TAIL = [0, 1, 4]  # the entries of a metrics row that gvamp.tail_row works out


class Phenotype(NamedTuple):
    y: np.ndarray       # (N,) file units, unit sample variance
    beta: np.ndarray    # (M,) the planted effects, file units
    probs: list         # the prior at the planted truth: [1 - c/M, c/M]
    vars: list          # [0, h2/c]


def phenotype(codes: torch.Tensor, packed: bool, n: int, seed: int, index: int,
              config: dict, traffic: dict) -> Phenotype:
    """Phenotype `index` of the pool of run `seed` on the design of `codes`."""
    h2 = float(config["run_config"]["h2"])
    m = codes.shape[0]
    causal = max(1, m // int(traffic["markers_per_causal"]))
    rng = np.random.default_rng(subseed(seed, 2, index))
    idx = np.sort(rng.choice(m, causal, replace=False))
    effects = rng.normal(0.0, math.sqrt(h2 / causal), causal)
    rows = codes[torch.as_tensor(idx, device=codes.device)]
    c = unpack_codes(rows, torch.float64) if packed else rows.double()
    mean = c.mean(dim=1, keepdim=True)
    sd = torch.sqrt(((c - mean) ** 2).sum(dim=1, keepdim=True) / (n - 1))
    g = (((c - mean) / sd) * torch.as_tensor(effects, device=c.device)[:, None]).sum(dim=0)
    y = g.cpu().numpy() + rng.normal(0.0, math.sqrt(1.0 - h2), n)
    y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))
    beta = np.zeros(m)
    beta[idx] = effects
    return Phenotype(y=y, beta=beta, probs=[1.0 - causal / m, causal / m],
                     vars=[0.0, h2 / causal])


class Inputs(NamedTuple):
    """What a fit was given, and so the reference too."""
    y: np.ndarray
    beta: np.ndarray
    probs: list
    vars: list
    probe_seed: int | None  # the engine's probes, where CG ran


def inputs(ph: Phenotype, probe_seed: int, traffic: dict) -> Inputs:
    probes = probe_seed if traffic["lmmse_solver"] == "cg" else None
    return Inputs(y=ph.y, beta=ph.beta, probs=ph.probs, vars=ph.vars, probe_seed=probes)


def fit(dm, ph: Phenotype, iterations: int, probe_seed: int, config: dict, traffic: dict):
    """The engine's LinearResult of a fit of `ph` on the DesignMatrix `dm`."""
    from vampomi_tpu_torch.config import RunConfig
    from vampomi_tpu_torch.engine.linear import infere_linear
    cfg = RunConfig(iterations=iterations, lmmse_solver=traffic["lmmse_solver"],
                    device=str(dm.device), seed=probe_seed, probs=ph.probs,
                    vars=ph.vars, **config["run_config"])
    return infere_linear(dm, ph.y, cfg, true_signal=ph.beta, write_outputs=False)


def answer_of(res) -> gvamp.Answer:
    """The engine's LinearResult as the reference's Answer."""
    return gvamp.Answer(rows=np.asarray(res.metrics_history),
                        x1=torch.as_tensor(res.x1_hat_scaled), r1=torch.as_tensor(res.r1_scaled),
                        gam1=float(res.gam1), gamw=float(res.gamw))


def finite_and_whole(res, iterations: int) -> bool:
    """The fit ran all its iterations and returned finite values."""
    vals = [res.x1_hat_scaled, res.r1_scaled, np.asarray(res.metrics_history),
            np.asarray([res.gam1, res.gamw])]
    return res.iterations_run == iterations and all(bool(np.all(np.isfinite(v))) for v in vals)


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

    def fits(self, inputs: list, config: dict, k: int) -> list:
        """The Answer after the first k iterations of each fit in `inputs`."""
        h2 = float(config["run_config"]["h2"])
        return [gvamp.run(self.design, self.eig, torch.as_tensor(i.y), torch.as_tensor(i.beta),
                          gvamp.Prior(i.probs, i.vars), iterations=k, h2=h2,
                          probe_seed=i.probe_seed)
                for i in inputs]

    def tail(self, a: gvamp.Answer, i: Inputs) -> list:
        return gvamp.tail_row(self.design, a.x1, torch.as_tensor(i.y), torch.as_tensor(i.beta))


def readings(answers: list, inputs: list, ref: Reference, config: dict, k: int,
             follow: list | None = None) -> dict:
    """The compared numbers of the fits `answers` (program's or control's)
    of `inputs`; `follow`, the reference's first k iterations of them, is
    worked out where not given."""
    if follow is None:
        follow = ref.fits(inputs, config, k)
    out = {"head_gap": max(per_iteration(answers, follow, k)),
           "tail_gap": max(gap(np.asarray(a.rows[-1])[TAIL], ref.tail(a, i))
                           for a, i in zip(answers, inputs))}
    if all(len(a.rows) == k for a in answers):
        out["state_gap"] = max(state_gap(a, f) for a, f in zip(answers, follow))
    return out
