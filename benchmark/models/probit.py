"""The probit model (case/control labels, the port's `--model bin_class`):
what a run of a configuration with `"model": "probit"` does that depends on
the model.

The pool: a label vector plants one causal marker per `markers_per_causal`
(the traffic's) with effects N(0, h2/causal) in file units (h2 the
configuration's), so that the genetic liability g = A beta of the
standardized design has variance about h2, and sets y = 1[g + e > 0] with
e ~ N(0, probit_var): the liability-threshold model that the engine's
likelihood assumes, about half of the samples cases.  Every label vector
has its own causal set and noise.  The prior starts at the planted truth.

The fit: one call of the port's entry, `vampomi_tpu_torch.engine.probit.
infere_bin_class(dm, y, cfg, true_signal=beta, write_outputs=False)`: the
LMMSE factor (the Gram, and under eigen its eigh) and the fit's iterations,
with no files written.  The fit's seed draws its starting p1 under every
solver, so the reference is always given it.

The reference: the plain probit GLM-VAMP of reference/gvamp_probit.py, run
from the same codes, labels, prior, seed and settings.  The compared
numbers, each the largest over the fits checked of gaps |program -
reference| / max(1, |reference|) (`check.gap`), of which a cell compares
those its limits file lists:

  * `head_gap`: the rows of the first `head_iterations` iterations (the
    limits file's), each the params row [alpha1, beta1, gam1, tau1,
    alpha2, beta2, gam2, tau2] and the correlations of x1 and x2 with the
    true signal, against the reference's: every layer of the step, the
    Gram and its eigenbasis, the three passes over the design, both
    denoisers, both LMMSE steps and EM (from iteration 2).  The confusion
    counts and accuracies are not compared here: a sample near z = 0 flips
    on rounding.
  * `tail_gap`: the last iteration's accuracy of A x1 and x1 correlation
    against what the returned x1 gives (gvamp_probit.tail_row): the
    returned x1 and the last pass over the design.

A fit that raised, returned values that are not finite, or stopped before
its iterations, failed.  A program whose result records no params rows
cannot be checked, and its run stops in the set-up.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.check import gap, per_iteration
from benchmark.design import subseed
from benchmark.reference import gvamp, gvamp_probit
from benchmark.reference.gvamp import unpack_codes


class Phenotype(NamedTuple):
    y: np.ndarray       # (N,) 0/1 labels
    beta: np.ndarray    # (M,) the planted effects, file units
    probs: list         # the prior at the planted truth: [1 - c/M, c/M]
    vars: list          # [0, h2/c]


def phenotype(codes: torch.Tensor, packed: bool, n: int, seed: int, index: int,
              config: dict, traffic: dict) -> Phenotype:
    """Label vector `index` of the pool of run `seed` on the design of `codes`."""
    h2 = float(config["h2"])
    noise_sd = math.sqrt(float(config["run_config"]["probit_var"]))
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
    y = (g.cpu().numpy() + rng.normal(0.0, noise_sd, n) > 0).astype(np.float64)
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
    seed: int           # the fit's seed: its starting p1 (and CG's probes)


def inputs(ph: Phenotype, probe_seed: int, traffic: dict) -> Inputs:
    return Inputs(y=ph.y, beta=ph.beta, probs=ph.probs, vars=ph.vars, seed=probe_seed)


def fit(dm, ph: Phenotype, iterations: int, probe_seed: int, config: dict, traffic: dict):
    """The engine's ProbitResult of a fit of `ph` on the DesignMatrix `dm`."""
    from vampomi_tpu_torch.config import RunConfig
    from vampomi_tpu_torch.engine.probit import infere_bin_class
    cfg = RunConfig(iterations=iterations, lmmse_solver=traffic["lmmse_solver"],
                    device=str(dm.device), seed=probe_seed, probs=ph.probs,
                    vars=ph.vars, **config["run_config"])
    return infere_bin_class(dm, ph.y, cfg, true_signal=ph.beta, write_outputs=False)


def _params(res) -> np.ndarray:
    """The result's params rows; a program that records none cannot be
    checked, and says so by raising (its run then stops in the set-up)."""
    rows = getattr(res, "params_history", None)
    if rows is None:
        raise RuntimeError("the engine's ProbitResult records no params_history: the "
                           "probit cell cannot check this program")
    return np.asarray(rows, dtype=np.float64).reshape(len(rows), 8)


def answer_of(res) -> gvamp_probit.Answer:
    """The engine's ProbitResult as the reference's Answer: each metrics
    row is [tp1, tn1, fp1, fn1, acc1, x1 corr, tp2, tn2, fp2, fn2, acc2,
    x2 corr]."""
    mh = np.asarray(res.metrics_history, dtype=np.float64)
    rows = np.concatenate([_params(res), mh[:, [5, 11]]], axis=1)
    return gvamp_probit.Answer(rows=rows, last=mh[-1, [4, 5]].tolist(),
                               x1=torch.as_tensor(res.x1_hat_scaled),
                               r1=torch.as_tensor(res.r1_scaled))


def finite_and_whole(res, iterations: int) -> bool:
    """The fit ran all its iterations and returned finite values."""
    vals = [res.x1_hat_scaled, res.r1_scaled, _params(res), np.asarray(res.metrics_history),
            np.asarray([res.gam1, res.tau1])]
    return res.iterations_run == iterations and all(bool(np.all(np.isfinite(v))) for v in vals)


def settings(config: dict) -> gvamp_probit.Settings:
    """The configuration's run settings as the reference reads them."""
    rc = config["run_config"]
    return gvamp_probit.Settings(rho=float(rc["rho"]), gam1=float(rc["gam1"]),
                                 probit_var=float(rc["probit_var"]),
                                 learn_vars=bool(rc["learn_vars"]))


class Reference:
    """The reference (precision "f64") or the control ("tf32") over a
    design: its Gram diagonalized once, then the first iterations of each
    fit."""

    def __init__(self, codes: torch.Tensor, packed: bool, precision: str = "f64"):
        self.design = gvamp.Design(codes, packed, precision)
        self.eig = gvamp.eigen_of(self.design.gram())

    def fits(self, inputs: list, config: dict, k: int) -> list:
        """The Answer after the first k iterations of each fit in `inputs`."""
        s = settings(config)
        return [gvamp_probit.run(gvamp, self.design, self.eig, torch.as_tensor(i.y),
                                 torch.as_tensor(i.beta), gvamp.Prior(i.probs, i.vars),
                                 gvamp_probit.start_p1(i.seed, self.design.n), s, iterations=k)
                for i in inputs]

    def tail(self, a: gvamp_probit.Answer, i: Inputs) -> list:
        return gvamp_probit.tail_row(self.design, a.x1, torch.as_tensor(i.y),
                                     torch.as_tensor(i.beta))


def readings(answers: list, inputs: list, ref: Reference, config: dict, k: int,
             follow: list | None = None) -> dict:
    """The compared numbers of the fits `answers` (program's or control's)
    of `inputs`; `follow`, the reference's first k iterations of them, is
    worked out where not given."""
    if follow is None:
        follow = ref.fits(inputs, config, k)
    return {"head_gap": max(per_iteration(answers, follow, k)),
            "tail_gap": max(gap(a.last, ref.tail(a, i)) for a, i in zip(answers, inputs))}
