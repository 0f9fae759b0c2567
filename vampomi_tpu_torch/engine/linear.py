"""Linear-model gVAMP engine (port of vampomi_tpu/engine/linear.py;
reference `vamp::infere_linear`, src/vamp.cpp:110-438).

A host loop writes the per-iteration artifacts around these phases:

  * `_em_phase`                 — EM prior update + merge + signal budget
                                  (reference src/vamp.cpp:531-643)
  * `_iteration_phase`          — denoising + CG LMMSE + Hutchinson Onsager +
                                  noise-precision update + error measures
  * `_iteration_phase_exact`    — the same with an exact LMMSE solve: one
                                  two-column ax_batch pass and one atx pass
                                  over X per iteration, the N x N step by the
                                  factor's `solve` (ops/spectral.py
                                  GramFactor: a per-iteration factor of
                                  S = gam2 I + gamw K; ops/eigen.py
                                  EigenFactor: K's once-per-dataset eigenbasis)

PyTorch runs eagerly, so the phases are plain functions; each iteration's
O(1) outputs reach the host in ONE batched copy, which is also the
iteration's synchronisation point.  The Python numbers an iteration reads
on the device are made once a fit (ops/operator.py Consts), so nothing
else in an iteration waits for the card.  Under the eigen factor on one
card, from the iteration whose work stops changing on, the iteration (EM,
the exact phase, the outputs' stack) runs as replays of one CUDA graph
(engine/graph.py; `_graphable` says which fits).  Tensors handed to the IO
thread are never updated in place.

Scaling conventions (must match the reference to reproduce its numbers):
  * internal x-vectors carry a sqrt(N) factor (A has 1/sqrt(N) baked in);
  * saved estimates are divided by sqrt(N) (src/vamp.cpp:237-239);
  * prior variances were multiplied by N at init (src/vamp.cpp:87-88);
  * gamma clamps [1e-11, 1e11] (src/vamp.hpp:33-34);
  * gam1 is damped with rho after the LMMSE step (src/vamp.cpp:346), x1_hat
    is damped after denoising for it > 1 (src/vamp.cpp:208-211).

The solver is chosen with the JAX engine's rule (`choose_lmmse_solver`), and
the eigen solver falls back to spectral where the JAX engine's does (eigen
residual above tolerance, eigen build over budget).  Covariates (--C > 0)
are fitted once before the loop by the probit Newton solver
(glm/probit.newton_method_cov, as src/vamp.cpp:153-169 does) and taken out
of y for the constant A^T y; gamw and the metrics keep the raw y.

`--checkpoint-file` saves the exact state after every iteration, on the IO
thread (engine/checkpoint.py), and `--resume-file` continues from one,
appending to the CSVs; the probe stream (`_ProbeStream`) advances one probe
an iteration under every solver, so a checkpoint taken under one solver
resumes under another with the same stream.  An exact solver reads no
probe: its draws are owed, and made only before the generator's state is
read, so a run that writes no checkpoint draws none.  `--eigen-cache`
keeps K's eigenbasis on disk (ops/eigen.py build_eigen_cached), and a warm
cache makes "auto" pick eigen where it would pick spectral, as in the JAX
engine.

Sharded over markers (`dm.shard`, sharding.py), each rank runs this loop on
its slab.  Every sum over markers goes through the sharding helpers, batched
into as few all_reduces as the data flow allows: an exact iteration makes
three (alpha1; the two-column ax_batch pass; the error measures at its end)
and one more with the EM update on.  Everything a branch reads is
replicated, so every rank takes it alike.  Rank 0 alone writes the CSVs,
the trace, checkpoints and the eigen cache and narrates; each rank writes
its own slab of the per-iteration dumps.  A checkpoint holds the full Mt
vectors (gathered on the main thread, never on the IO thread), so it does
not depend on the rank count.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import RunConfig
from ..glm.probit import newton_method_cov
from ..io.bin_io import HostCopy, HostStager, iteration_file, write_marker_file
from ..io.csv_writer import PositionalCSV
from ..ops.cg import cg_solve
from ..ops.eigen import EigenFactor, build_eigen, build_eigen_cached, cache_plausible
from ..ops.operator import Consts, DesignMatrix, atx, ax, ax_batch, f64, x_passes
from ..ops.spectral import build_spectral
from ..prior.mixture import (
    MixturePrior, em_update, g1, g1d, init_prior, merge_components_device,
)
from ..sharding import (
    Shard, all_reduce_, all_reduce_many, broadcast_, broadcast_from0, gather_m, is_writer,
    local_rows,
)
from ..utils.async_writer import AsyncWriter
from ..utils.telemetry import Tracer, span
from .checkpoint import load_resume, save_checkpoint
from .graph import IterationGraph
from .metrics import prediction_metrics, signal_from_sums, signal_sums

GAMMA_MIN = 1e-11  # reference src/vamp.hpp:33
GAMMA_MAX = 1e11   # reference src/vamp.hpp:34
EIGEN_RESID_TOL = 1e-3  # the JAX engine's fallback threshold (linear.py:803)

METRICS_HEADER = [
    "iteration",
    "R2 denoising",
    "x1 correlation denoising",
    "R2 LMMSE",
    "x2 correlation LMMSE",
    "z1 correlation denoising",
    "z2 correlation LMMSE",
]
PARAMS_HEADER = ["iteration", "alpha1", "gam1", "alpha2", "gam2", "gamw"]


def _clamp(x):
    return torch.clamp(x, GAMMA_MIN, GAMMA_MAX)


class LinearResult(NamedTuple):
    x1_hat_scaled: np.ndarray   # (Mt,) estimate in file units (x1_hat/sqrt(N))
    iterations_run: int
    gam1: float
    gamw: float
    probs: np.ndarray
    vars: np.ndarray            # internal (×N) scale
    metrics_history: list
    r1_scaled: np.ndarray | None = None
    iter_seconds: list | None = None
    # collectives each iteration ran (sharded runs; sharding.Shard.counts)
    iter_collectives: list | None = None
    # wall seconds of the once-per-run setup, and the eigen residual:
    # {"cov", "aty", "gram", "eigh" (of it "eigen_solve", the eigh alone),
    # "eigen_resid"} as far as the run needed them; with the outputs on,
    # "dump.flush", the wait for the IO thread's backlog after the loop
    setup: dict | None = None
    # the LMMSE solver that ran: auto resolved, after the eigen fallbacks
    solver: str | None = None
    # each iteration's {span: host seconds} (utils/telemetry.py),
    # "passes", the passes over X counted at the operator, "probe_draws"
    # and "graph_replays" (1 where the iteration was a graph's replay);
    # with the outputs on (`dump_iteration`), also "dump.stage", "csv",
    # "dump.wait" where the submit waited, the IO thread's "dump.copy" and
    # "dump.write", and the counters "dump_bytes" and "dump_waited"
    iter_phases: list | None = None


def _em_phase(dm: DesignMatrix, r1, gam1, prior: MixturePrior,
              em_max_iter, em_err_thr, learn_vars, merge_vars_thr,
              signal_budget, debug: bool = False,
              consts: Consts | None = None) -> MixturePrior:
    """EM prior update + component merge + truth-free signal budget
    (reference src/vamp.cpp:531-643; JAX engine/linear.py:92-129).

    `signal_budget` (f64, 0 = off = reference parity) caps the slab's total
    second moment mt·Σ_{j≥1} p_j v_j at N·h2_max by rescaling the slab
    variances after each EM call — the stabilizer for wide M/N.  `consts`:
    the fit's numbers on the device (ops/operator.py), else made here."""
    dev = dm.device
    consts = consts or Consts(dev)
    prior = em_update(
        r1, gam1, prior, dm.mmask, dm.mt,
        em_max_iter=em_max_iter, em_err_thr=em_err_thr, learn_vars=learn_vars,
        debug=debug, shard=dm.shard, consts=consts,
    )
    prior = merge_components_device(prior, merge_vars_thr, consts)
    slab = prior.active & (torch.arange(prior.L, device=dev) >= 1)
    total = dm.mt * torch.where(slab, prior.probs * prior.vars, 0.0).sum()
    budget = consts(signal_budget)
    over = (budget > 0.0) & (total > budget)
    scale = torch.where(over, budget / torch.where(total > 0.0, total, 1.0), 1.0)
    return MixturePrior(
        probs=prior.probs,
        vars=torch.where(slab, prior.vars * scale, prior.vars),
        active=prior.active,
    )


def _denoise(dm, r1, gam1, prior, x1_hat_prev, damp, rho, c):
    """The denoising half shared by both iteration phases
    (src/vamp.cpp:176-272): x1_hat, alpha1, eta1, gam2, r2."""
    x1_new = g1(r1, gam1, prior)
    x1_hat = c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev if damp else x1_new
    g1d_sum = all_reduce_((g1d(r1, gam1, prior) * dm.mmask).sum(), dm.shard)
    alpha1 = g1d_sum.to(torch.float64) / dm.mt
    eta1 = gam1 / alpha1
    gam2 = _clamp(eta1 - gam1)
    r2 = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)
    return x1_hat, alpha1, eta1, gam2, r2


def _nmse_sums(x1_hat, x1_hat_prev) -> torch.Tensor:
    """The NMSE's two inner products over markers, [dx·dx, prev·prev]."""
    dx = x1_hat - x1_hat_prev
    return torch.stack([torch.dot(dx, dx), torch.dot(x1_hat_prev, x1_hat_prev)])


def _nmse_from(s: torch.Tensor):
    """Stopping-criterion NMSE (src/vamp.cpp:409-423) from _nmse_sums' two
    (summed) inner products; inf on a zero previous iterate."""
    num, denom = s[0].to(torch.float64), s[1].to(torch.float64)
    return torch.where(denom > 0.0, torch.sqrt(num / torch.where(denom > 0.0, denom, 1.0)),
                       math.inf)


def _late_sums(dm: DesignMatrix, n, dev2, dev1, x1_hat, x2_hat, x1_hat_prev, ts, *extra):
    """The error measures over markers an iteration reports, summed over
    the ranks in one all_reduce at its end with the `extra` partial sums
    (work dtype) nothing inside the iteration reads: (gam2_true, gam1_true,
    the x1 and x2 correlations, the NMSE, *extra summed).  `n`: N, as the
    fit's f64 tensor."""
    g2, g1, s1, s2, nm, *more = all_reduce_many(
        [torch.dot(dev2, dev2), torch.dot(dev1, dev1), signal_sums(x1_hat, ts, n),
         signal_sums(x2_hat, ts, n), _nmse_sums(x1_hat, x1_hat_prev), *extra], dm.shard)
    return (dm.mt / g2.to(torch.float64), dm.mt / g1.to(torch.float64),
            signal_from_sums(s1)[0], signal_from_sums(s2)[0], _nmse_from(nm), *more)


def _iteration_phase(
    dm: DesignMatrix,
    aty_adj,          # A^T y_adj, cached across iterations (src/vamp.cpp:303)
    y_raw,            # original phenotype (gamw + metrics; src/vamp.cpp:506,817)
    r1,
    gam1,
    prior: MixturePrior,
    x1_hat_prev,
    damp: bool,       # apply rho-damping (it > 1)
    rho,
    gamw,
    mu_warm,
    bern,             # Rademacher probe, +-1/sqrt(Mt)
    true_signal,      # file units (beta); zeros if unknown
    cg_max_iter,
    cg_err_tol,
    debug: bool = False,   # --verbosity 1 per-CG-iteration prints
    consts: Consts | None = None,  # the fit's numbers on the device
) -> dict:
    """One linear-VAMP iteration with the CG LMMSE solver and the
    Hutchinson Onsager estimate (JAX engine/linear.py:132-251)."""
    wd = dm.wd
    dev = dm.device
    consts = consts or Consts(dev)
    c = lambda s: consts(s, wd)  # noqa: E731 — scalar → work dtype
    gam1 = f64(gam1, dev)
    gamw = f64(gamw, dev)
    r1 = r1.to(wd)
    x1_hat_prev = x1_hat_prev.to(wd)
    aty_adj = aty_adj.to(wd)
    y_raw = y_raw.to(wd)
    mu_warm = mu_warm.to(wd)
    bern = bern.to(wd)
    ts = true_signal.to(wd)
    sqrt_n_c = c(math.sqrt(dm.n))

    with span("denoise"):
        x1_hat, alpha1, eta1, gam2, r2 = _denoise(
            dm, r1, gam1, prior, x1_hat_prev, damp, rho, c)
    z1 = ax(dm, x1_hat)

    # diagnostic "true" gam2 against the known signal (src/vamp.cpp:263-270)
    dev2 = r2 - sqrt_n_c * ts
    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    # ---------------- LMMSE (src/vamp.cpp:287-362) ----------------
    v = c(gamw) * aty_adj + c(gam2) * r2
    V = torch.stack([v, bern], dim=1)
    MU0 = torch.stack([mu_warm, torch.zeros_like(mu_warm)], dim=1)
    res = cg_solve(
        dm, V, MU0, gamw, gam2,
        max_iter=int(cg_max_iter), tol=float(cg_err_tol),
        onsager_cols=torch.tensor([False, True], device=dev),
        debug=debug,
    )
    x2_hat = res.mu[:, 0]
    invq_bern = res.mu[:, 1]

    # Hutchinson Onsager (src/vamp.cpp:494-501)
    alpha2 = gam2 * all_reduce_(torch.dot(bern, invq_bern), dm.shard).to(torch.float64)
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1    # damping (src/vamp.cpp:346)
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts

    # noise precision EM update (src/vamp.cpp:504-529)
    z2 = ax(dm, x2_hat)
    resid = z2 - y_raw
    trace_vec = atx(dm, ax(dm, invq_bern))
    gam2_true, gam1_true, x1_corr, x2_corr, nmse, bern_tr = _late_sums(
        dm, consts(dm.n), dev2, dev1, x1_hat, x2_hat, x1_hat_prev, ts, torch.dot(bern, trace_vec))
    trace_corr = bern_tr.to(torch.float64) * dm.mt
    gamw_new = dm.n / (torch.dot(resid, resid).to(torch.float64) + trace_corr)

    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)
    metrics = torch.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse])

    return dict(
        nmse=nmse,
        x1_hat=x1_hat,
        alpha1=alpha1,
        eta1=eta1,
        z1=z1,
        gam2=gam2,
        r2=r2,
        x2_hat=x2_hat,
        alpha2=alpha2,
        eta2=eta2,
        gam1=gam1_new,
        r1=r1_new,
        gamw=gamw_new,
        cg_iters=res.iters,
        cg_rel_err=res.rel_err,
        metrics=metrics,
        gam1_true=gam1_true,
        gam2_true=gam2_true,
    )


def _iteration_phase_exact(
    dm: DesignMatrix,
    fac,              # GramFactor (spectral) or EigenFactor (eigen)
    aty_adj,
    y_raw,
    r1,
    gam1,
    prior: MixturePrior,
    x1_hat_prev,
    damp: bool,
    rho,
    gamw,
    true_signal,
    consts: Consts | None = None,  # the fit's numbers on the device
) -> dict:
    """One linear-VAMP iteration with an exact LMMSE solve (JAX
    engine/linear.py:255-365 spectral, 368-482 eigen): X is read twice — one
    two-column ax_batch pass for z1 = A x1 and A v, one atx pass for A^T q —
    and the N x N step, q = S^{-1} A v with both traces in closed form, is
    `fac.solve`, the one place the two solvers differ."""
    wd = dm.wd
    dev = dm.device
    consts = consts or Consts(dev)
    c = lambda s: consts(s, wd)  # noqa: E731
    gam1 = f64(gam1, dev)
    gamw = f64(gamw, dev)
    r1 = r1.to(wd)
    x1_hat_prev = x1_hat_prev.to(wd)
    y_raw = y_raw.to(wd)
    aty_adj = aty_adj.to(wd)
    ts = true_signal.to(wd)
    sqrt_n_c = c(math.sqrt(dm.n))

    with span("denoise"):
        x1_hat, alpha1, eta1, gam2, r2 = _denoise(
            dm, r1, gam1, prior, x1_hat_prev, damp, rho, c)

    dev2 = r2 - sqrt_n_c * ts

    # ---------------- LMMSE, exact (src/vamp.cpp:287-362) ----------------
    v = c(gamw) * aty_adj + c(gam2) * r2
    Z = ax_batch(dm, torch.stack([x1_hat, v], dim=1))
    z1 = Z[:, 0]
    av = Z[:, 1]
    with span("dense"):
        q, tr_qinv, tr_ata_qinv = fac.solve(av, gamw, gam2, dm.mt)  # q == A x2_hat
    x2_hat = (v - c(gamw) * atx(dm, q)) / c(gam2)
    z2 = q

    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    alpha2 = gam2 * tr_qinv / dm.mt
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam2_true, gam1_true, x1_corr, x2_corr, nmse = _late_sums(
        dm, consts(dm.n), dev2, dev1, x1_hat, x2_hat, x1_hat_prev, ts)

    resid = z2 - y_raw
    gamw_new = dm.n / (torch.dot(resid, resid).to(torch.float64) + tr_ata_qinv)

    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)
    metrics = torch.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse])

    return dict(
        nmse=nmse,
        x1_hat=x1_hat,
        alpha1=alpha1,
        eta1=eta1,
        z1=z1,
        gam2=gam2,
        r2=r2,
        x2_hat=x2_hat,
        alpha2=alpha2,
        eta2=eta2,
        gam1=gam1_new,
        r1=r1_new,
        gamw=gamw_new,
        cg_iters=0,
        cg_rel_err=torch.zeros(2, dtype=torch.float64, device=dev),
        metrics=metrics,
        gam1_true=gam1_true,
        gam2_true=gam2_true,
    )


def choose_lmmse_solver(cfg: RunConfig, mt: int, n: int, shard: Shard | None = None) -> str:
    """Resolve cfg.lmmse_solver with the JAX engine's rule
    (engine/linear.py:485-521): "auto" picks the spectral path when the
    one-time Gram build is clearly amortized (2048 <= N <= spectral_max_n
    and Mt >= 4N), else CG; there, a warm --eigen-cache (a readable cache of
    this package for this N, ops/eigen.py cache_plausible, rank 0's verdict
    on every rank) upgrades it to eigen, whose dense work is two N^2
    matvecs an iteration against the spectral factor's 2N^3/3, once the
    eigh is a file load.  Over several ranks a cold auto keeps spectral and
    rank 0 prints the JAX engine's hint.  An unknown name raises."""
    s = cfg.lmmse_solver
    if s not in ("auto", "cg", "eigen", "spectral"):
        raise ValueError(f"unknown LMMSE solver {s!r}")
    if s != "auto":
        return s
    if n <= cfg.spectral_max_n and n >= 2048 and mt >= 4 * n:
        if cfg.eigen_cache and cache_plausible(cfg.eigen_cache, n, shard):
            return "eigen"
        if shard is not None and shard.world > 1 and shard.rank == 0:
            print(f"auto LMMSE solver: picked spectral on a cold {shard.world}-device run — "
                  "warm an --eigen-cache (or pass --lmmse-solver eigen) to switch the "
                  "per-iteration dense work from the replicated 2N^3/3 factor to two N^2 "
                  "matvecs", flush=True)
        return "spectral"
    return "cg"


def warn_em_stability(cfg: RunConfig, mt: int, n: int) -> bool:
    """One-line stderr warning when the EM hyperparameter updates are on in
    a regime where they are measured to collapse (EM_STABILITY.json: every
    M/N >= 16 case except the smallest N diverged, engine and f64 numpy
    oracle alike — inherited from the reference's EM, src/vamp.cpp:531-643).
    Returns True when the warning fired."""
    risky = bool(cfg.learn_vars) and n > 0 and mt >= 16 * n
    if risky and is_writer():
        print(
            f"WARNING: EM prior/noise learning is ON at M/N = {mt / n:.0f} "
            "(>= 16), where the EM recursion is measured to collapse "
            "(EM_STABILITY.json) — consider --em-h2-budget 0.9 (truth-free "
            "signal-budget stabilizer), a longer --learn-prior-delay, "
            "or --learn-vars 0 with known variances",
            file=sys.stderr, flush=True,
        )
    return risky


def build_eigen_budgeted(fac, cfg: RunConfig, shard: Shard | None = None):
    """build_eigen, through the cache of cfg.eigen_cache when it is set,
    under cfg.eigen_build_budget wall seconds (0 = unlimited).  Returns
    (EigenFactor, diagnostics), or (None, None) over budget: the caller then
    falls back to the per-iteration spectral solver, as the JAX engine does
    (engine/linear.py:622-641).  cuSOLVER's eigh cannot be interrupted, so
    the budget is checked when it returns; with a shard, rank 0's verdict
    holds on every rank."""
    t0 = time.perf_counter()
    if cfg.eigen_cache:
        ef, diag = build_eigen_cached(fac, cfg.eigen_cache, seed=cfg.seed, shard=shard)
    else:
        ef, diag = build_eigen(fac, shard)
    over = cfg.eigen_build_budget > 0 and broadcast_from0(
        [time.perf_counter() - t0 > cfg.eigen_build_budget], shard)[0]
    if over:
        _log(f"eigen build exceeded --eigen-build-budget "
             f"{cfg.eigen_build_budget:.0f}s — falling back to the "
             f"per-iteration spectral factor path")
        return None, None
    return ef, diag


def fit_covariates(y, covariates: np.ndarray, cfg: RunConfig,
                   shard: Shard | None = None) -> np.ndarray:
    """The covariates' effects, fitted once by the probit Newton solver
    (glm/probit.newton_method_cov; src/vamp.cpp:153-169,
    src/vamp_probit.cpp:525-617).  With a shard, rank 0 fits them and
    broadcasts the C values: a host BLAS may round a product differently
    from one process to the next, and every rank must hold the same bits.
    The caller broadcasts the N-vector it makes of them for the same
    reason."""
    cov_eff = np.zeros(covariates.shape[1])
    if shard is None or shard.rank == 0:
        cov_eff = newton_method_cov(
            np.asarray(y), np.zeros(len(y)), covariates, np.zeros(cfg.C),
            probit_var=cfg.probit_var, verbosity=cfg.verbosity,
        )
    return np.asarray(broadcast_from0(cov_eff, shard), dtype=np.float64)


def _probe_count(dm: DesignMatrix) -> int:
    """The entries of a probe draw: every marker's, the whole Mt on every
    rank of a sharded run (which then keeps its own slab), so the draws are
    those of one process whatever the rank count."""
    return dm.m_pad if dm.shard is None else int(dm.mt)


def _skip_probe(gen: torch.Generator, dm: DesignMatrix) -> None:
    """Advance the generator past one probe an exact solver does not use:
    the same random numbers `_draw_probe` consumes, nothing copied to the
    device.  `_ProbeStream` makes these draws only when the generator's
    state is read."""
    torch.randint(0, 2, (_probe_count(dm),), generator=gen)


def _draw_probe(gen: torch.Generator, dm: DesignMatrix) -> torch.Tensor:
    """Fresh Rademacher trace probe ±1/sqrt(Mt) (seeded; fixes reference
    quirk Q4).  Drawn from a CPU generator and copied to the run's device,
    so one seed gives the same probes on the CPU and on a card, and on any
    number of ranks."""
    signs = local_rows(torch.randint(0, 2, (_probe_count(dm),), generator=gen) * 2 - 1,
                       dm.shard)
    scale = torch.tensor(1.0 / math.sqrt(dm.mt), dtype=dm.wd)
    return (signs.to(dm.wd) * scale).to(dm.device) * dm.mmask


class _ProbeStream:
    """A run's trace probes from its CPU generator, one an iteration under
    every solver, so the generator's state after k iterations is the same
    whatever the solver (the JAX engines split their key every iteration
    for the same reason).  An exact solver reads no probe: `skip` only owes
    it.  The owed draws are made (`_skip_probe`, one at a time) before
    anything reads the generator: a CG `draw`, or `state` for a checkpoint.
    `draws` counts the probe-sized draws made.  `draw_probe` is the engine
    module's `_draw_probe`, looked up by the engine when the run starts."""

    def __init__(self, gen: torch.Generator, dm: DesignMatrix, draw_probe):
        self.gen, self.dm, self._draw_probe = gen, dm, draw_probe
        self.owed = 0
        self.draws = 0

    def skip(self) -> None:
        self.owed += 1

    def _settle(self) -> None:
        for _ in range(self.owed):
            _skip_probe(self.gen, self.dm)
        self.draws += self.owed
        self.owed = 0

    def draw(self) -> torch.Tensor:
        self._settle()
        self.draws += 1
        return self._draw_probe(self.gen, self.dm)

    def state(self) -> torch.Tensor:
        """The generator's state with every probe so far drawn."""
        self._settle()
        return self.gen.get_state()


def _log(msg: str):
    """The engines' narration, on rank 0 alone."""
    if is_writer():
        print(msg, flush=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_lmmse_factor(dm: DesignMatrix, cfg: RunConfig, solver: str, setup: dict):
    """The once-per-run state of an exact LMMSE solver: the Gram factor K
    (spectral) or K's eigenbasis (eigen), with the JAX engines' fallbacks
    from eigen to the per-iteration spectral solver (eigen build over
    budget, eigen residual above tolerance; JAX engine/linear.py:792-806,
    engine/probit.py:416-431) and their log lines.  Returns (the solver
    that runs, its GramFactor, EigenFactor or None for cg); the wall seconds
    go to `setup` ("gram", "eigh", and as parts of "eigh" "eigen_solve", the
    eigh alone where this process ran it, and with --eigen-cache
    "eigen_cache_load" or "eigen_cache_write") with the eigen residual and
    the eigenvalues' sum."""
    if solver == "cg":
        return solver, None
    if cfg.lmmse_solver == "auto" and solver == "eigen":
        _log(f"auto LMMSE solver: eigen, upgraded from spectral by the warm --eigen-cache "
             f"{cfg.eigen_cache} (the eigh is a file load)")
    with span("gram", into=setup):
        fac = build_spectral(dm)
        _sync(dm.device)
    _log(f"spectral LMMSE factor built in {setup['gram']:.3f}s "
         f"(N={int(dm.n)}; exact solves + exact Onsager from here on)")
    if solver == "spectral":
        return solver, fac
    with span("eigh") as eigh:
        ef, eig_diag = build_eigen_budgeted(fac, cfg, dm.shard)
    if ef is None:
        return "spectral", fac
    setup["eigh"] = eigh.seconds
    setup["eigen_resid"] = eig_diag["resid"]
    setup["eigen_lam_sum"] = float(ef.lam.sum())  # trace(K): the same on every rank
    if "solve_s" in eig_diag:
        setup["eigen_solve"] = eig_diag["solve_s"]
    for key in ("load_s", "write_s"):  # the eigen cache's file, within "eigh"
        if key in eig_diag:
            setup[f"eigen_cache_{key[:-2]}"] = eig_diag[key]
    _log(f"eigenbasis of K {'loaded' if eig_diag.get('loaded') else 'built'} "
         f"in {setup['eigh']:.3f}s "
         f"(residual {eig_diag['resid']:.2e}, "
         f"orthogonality {eig_diag['ortho']:.2e}, torch.linalg.eigh f64)")
    if eig_diag["resid"] > EIGEN_RESID_TOL:
        _log("eigen residual above tolerance — falling back "
             "to the per-iteration factor path")
        return "spectral", fac
    return solver, ef  # the eigenbasis replaces K


def trace_of(dm: DesignMatrix, cfg: RunConfig, write_outputs: bool,
             probes: _ProbeStream, writer: AsyncWriter,
             graph: IterationGraph | None = None) -> Tracer:
    """The run's Tracer: <out>_trace.jsonl with the outputs on and
    cfg.trace, each pass over X reading the stored design's bytes, the
    probe draws an iteration made counted as "probe_draws", as
    "graph_replays" 1 for an iteration `graph` replayed, else 0, and with
    the outputs on, as "dump_waited" the submits to the IO thread that
    waited for its backlog."""
    path = f"{cfg.out_dir}/{cfg.out_name}_trace.jsonl" if write_outputs and cfg.trace else None
    counters = {"probe_draws": lambda: probes.draws,
                "graph_replays": lambda: graph.replays if graph else 0}
    if write_outputs:
        counters["dump_waited"] = lambda: writer.waits
    return Tracer(path, x_passes, dm.X.numel() * dm.X.element_size(), counters=counters)


def _graphable(dm: DesignMatrix, fac, cfg: RunConfig) -> bool:
    """Whether a fit runs its steady iterations as replays of one CUDA
    graph (engine/graph.py): under the eigen factor, on a card, in one
    process, with nothing in the iteration that reads the device on the
    host (--verbosity 1's EM prints; EM's convergence test past one EM
    step).  The Gram factor reads its Cholesky leaves' infos on the host,
    and CG its residual every step."""
    return (dm.device.type == "cuda" and isinstance(fac, EigenFactor) and dm.shard is None
            and cfg.verbosity != 1 and int(cfg.EM_max_iter) <= 1)


def _first_steady(cfg: RunConfig) -> int:
    """The iteration from which on each does the work of the one before:
    damped, and with the EM update on if any iteration of the run has it."""
    return 2 if cfg.learn_prior_delay >= cfg.iterations else max(2, cfg.learn_prior_delay + 1)


def _outputs(gam1_pre, out: dict, prior: MixturePrior) -> torch.Tensor:
    """An iteration's O(1) outputs as one f64 device vector, which the
    loop fetches in one copy: the params and error measures, the metrics
    row, the prior."""
    return torch.cat([
        torch.stack([gam1_pre, out["alpha1"], out["alpha2"], out["gam2"], out["gam1"],
                     out["gamw"], out["gam1_true"], out["gam2_true"], out["nmse"]]),
        out["metrics"], prior.probs, prior.vars, prior.active.to(torch.float64),
    ])


def open_csvs(cfg: RunConfig) -> tuple[PositionalCSV, PositionalCSV, PositionalCSV]:
    """The per-iteration metrics, params and prior CSVs of a run (the
    reference's headers; the probit engine writes its own rows under them).
    A resumed run appends to the files it finds: the rows written before
    the interruption stay (vampomi_tpu/engine/linear.py:763-768)."""
    prior_header = (
        ["iteration", "number of components"]
        + [f"prob{i}" for i in range(len(cfg.probs))]
        + [f"var{i}" for i in range(len(cfg.vars))]
    )
    base = f"{cfg.out_dir}/{cfg.out_name}"

    def csv(path, header):
        return PositionalCSV(path, header,
                             create=not (cfg.resume_file and os.path.exists(path)))

    return (csv(base + "_metrics.csv", METRICS_HEADER),
            csv(base + "_params.csv", PARAMS_HEADER),
            csv(base + "_prior.csv", prior_header))


def dump_iteration(cfg: RunConfig, mt: int, sqrt_n: float, k: int, copy, start: int,
                   into: dict) -> None:
    """The per-iteration artifacts (src/vamp.cpp:234-252): x1_hat/sqrt(N)
    and the r1 denoised in iteration k, from a HostStager copy of the
    markers from `start` on (a rank's slab); run on the IO thread.  Its
    spans, "dump.copy" (the wait for the copy to land) and "dump.write"
    (the widening, the division and both writes), and "dump_bytes", the
    bytes written, go to `into`, the record of iteration k that the engine
    folds into its phases (Tracer.fold)."""
    with span("dump.copy", into):
        x1_host, r1_host = copy.wait()
    with span("dump.write", into):
        written = write_marker_file(iteration_file(cfg.out_dir, cfg.out_name, k),
                                    x1_host, mt, sqrt_n, start)
        written += write_marker_file(iteration_file(cfg.out_dir, cfg.out_name, k, kind="r1_"),
                                     r1_host, mt, sqrt_n, start)
    into["dump_bytes"] = written


def flush_timed(writer: AsyncWriter, setup: dict, write_outputs: bool) -> None:
    """Close the run's writer; with the outputs on, the wait for its
    backlog is the span "dump.flush" of the run's `setup`."""
    with span("dump.flush", setup) if write_outputs else contextlib.nullcontext():
        writer.close()


def checkpoint_iteration(cfg: RunConfig, model: str, dm: DesignMatrix, k: int, copy,
                         names, host_arrays: dict, scalars: dict, prior_h: dict,
                         rng_state: torch.Tensor) -> None:
    """Save iteration k's exact state to cfg.checkpoint_file; run on the IO
    thread.  `copy` is a HostStager copy of the device vectors `names`,
    widened to f64 here; `host_arrays` are f64 host arrays already (y_adj,
    fetched once a run); the scalars and the prior are host values of the
    iteration's one batched copy."""
    arrays = {name: v.numpy().astype(np.float64) for name, v in zip(names, copy.wait())}
    save_checkpoint(
        cfg.checkpoint_file, iteration=k, arrays={**arrays, **host_arrays},
        scalars=scalars, prior=prior_h, rng_state=rng_state.numpy(),
        meta=dict(model=model, mt=int(dm.mt), n=int(dm.n), m_pad=_m_global(dm)),
    )


def _m_global(dm: DesignMatrix) -> int:
    """The M-vectors' length in a checkpoint: m_pad of one process, the
    global Mt of a sharded run (whose checkpoints hold full vectors)."""
    return dm.m_pad if dm.shard is None else int(dm.mt)


def restore_vectors(ck: dict, names, device: torch.device, wd: torch.dtype,
                    shard: Shard | None = None) -> list:
    """The checkpoint's f64 arrays `names` as work-dtype tensors on `device`
    (exact: the state was saved widened from the work dtype); with a shard,
    the rank's rows of the M-vectors `names`."""
    a = ck["arrays"]
    return [torch.as_tensor(local_rows(np.asarray(a[k], dtype=np.float64), shard)).to(
        device=device, dtype=wd) for k in names]


def restore_prior(ck: dict, device: torch.device) -> MixturePrior:
    p = ck["prior"]
    return MixturePrior(
        probs=torch.as_tensor(np.asarray(p["probs"], dtype=np.float64)).to(device),
        vars=torch.as_tensor(np.asarray(p["vars"], dtype=np.float64)).to(device),
        active=torch.as_tensor(np.asarray(p["active"], dtype=bool)).to(device),
    )


def restore_generator(gen: torch.Generator, ck: dict, resume_file: str) -> None:
    """The generator state of a checkpoint; a JAX-written one has none the
    port can use, and the run keeps its seeded generator (convert.py
    checkpoint_from_jax allows that only where nothing drawn feeds a
    result)."""
    if ck["rng_state"] is not None:
        gen.set_state(torch.as_tensor(np.asarray(ck["rng_state"], dtype=np.uint8)))
    else:
        _log(f"{resume_file}: a JAX-written checkpoint; its PRNG key is not replayed "
             f"(the exact solver draws nothing that feeds a result)")


def infere_linear(
    dm: DesignMatrix,
    y: np.ndarray,
    cfg: RunConfig,
    true_signal: np.ndarray | None = None,
    x1hat_init: np.ndarray | None = None,
    covariates: np.ndarray | None = None,
    write_outputs: bool = True,
) -> LinearResult:
    """Run linear gVAMP.  `y`, `true_signal`, `x1hat_init` are host arrays in
    file units (the global Mt markers; a sharded `dm` takes its slab of
    them); `dm` is the design operator on the run's device."""
    M_pad = dm.m_pad
    Mt = int(dm.mt)
    N = int(dm.n)
    sqrt_n = float(np.sqrt(N))
    wd = dm.wd
    dev = dm.device
    shard = dm.shard
    lo = 0 if shard is None else shard.lo
    # the reference narrates hyperparameters unconditionally; --verbosity 1
    # adds the per-CG / per-EM residual prints (the phases' debug flag)

    def pad_m(vec):
        out = np.zeros(M_pad, dtype=np.float64)
        if vec is not None:
            vec = local_rows(vec, shard)
            out[: len(vec)] = vec
        return torch.as_tensor(out).to(device=dev, dtype=wd)

    ts = pad_m(true_signal)
    # warm start: x1_hat = r1 = x1hat_init / sqrt(N) (src/vamp.cpp:70-79)
    init_vec = pad_m(np.asarray(x1hat_init) / sqrt_n if x1hat_init is not None else None)
    x1_hat = init_vec
    r1 = init_vec

    y_raw = torch.as_tensor(np.asarray(y, dtype=np.float64)).to(device=dev, dtype=wd)
    y_adj = y_raw

    prior = init_prior(cfg.probs, cfg.vars, N, device=dev)
    gam1 = f64(float(cfg.gam1), dev)
    gamw = f64(1.0 / (1.0 - cfg.h2), dev)  # src/main_meth.cpp:52
    rho = float(cfg.rho)
    mu_warm = torch.zeros(M_pad, dtype=wd, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(cfg.seed))
    it_start = 1

    solver = choose_lmmse_solver(cfg, Mt, N, shard)
    warn_em_stability(cfg, Mt, N)

    setup = {}
    # covariate adjustment, once (src/vamp.cpp:153-169; JAX engine/linear.py:718-727)
    if cfg.C > 0 and covariates is not None and covariates.shape[1] > 0:
        with span("cov", into=setup):
            cov_eff = fit_covariates(y, covariates, cfg, shard)
            y_adj = broadcast_(torch.as_tensor(np.asarray(y) - covariates @ cov_eff).to(
                device=dev, dtype=wd), shard)

    # exact-state resume (vampomi_tpu/engine/linear.py:729-750)
    if cfg.resume_file:
        ck = load_resume(cfg.resume_file, model="linear", solver=solver,
                         mt=Mt, n=N, m_pad=_m_global(dm))
        x1_hat, r1, mu_warm = restore_vectors(ck, ("x1_hat", "r1", "mu_warm"), dev, wd, shard)
        if "y_adj" in ck["arrays"]:
            (y_adj,) = restore_vectors(ck, ("y_adj",), dev, wd)
        gam1 = f64(ck["scalars"]["gam1"], dev)
        gamw = f64(ck["scalars"]["gamw"], dev)
        prior = restore_prior(ck, dev)
        restore_generator(gen, ck, cfg.resume_file)
        it_start = ck["iteration"] + 1
        _log(f"...resumed exact state from {cfg.resume_file} at iteration {it_start}")

    if write_outputs:
        out_metrics, out_params, out_prior = open_csvs(cfg)

    with span("aty", into=setup):
        aty_adj = atx(dm, y_adj)  # constant across iterations
        _sync(dev)
    solver, fac = build_lmmse_factor(dm, cfg, solver, setup)

    probes = _ProbeStream(gen, dm, _draw_probe)
    graph = IterationGraph(dev) if _graphable(dm, fac, cfg) else None
    first_steady = _first_steady(cfg)
    consts = Consts(dev)  # the numbers the iterations read on the device

    # device→host artifact IO overlaps the next iteration's compute: the
    # copies run on a side stream (HostStager), the f64 scaling and the
    # writes on the IO thread, whose spans go to io_phases[iteration]
    writer = AsyncWriter()
    stager = HostStager(dev)
    io_phases = {}
    tracer = trace_of(dm, cfg, write_outputs, probes, writer, graph)
    # y_adj is constant across iterations: fetched once, not per checkpoint
    y_adj_host = (y_adj.cpu().numpy().astype(np.float64)
                  if cfg.checkpoint_file else None)

    metrics_history = []
    iter_collectives = [] if shard is not None else None
    it_done = 0
    L = prior.L

    def em(r1, gam1, prior):
        """EM prior update + merge of iteration `it`, on the device
        (src/vamp.cpp:186-187)."""
        with span("em"):
            if it > cfg.learn_prior_delay:
                prior = _em_phase(
                    dm, r1, gam1, prior, cfg.EM_max_iter, cfg.EM_err_thr,
                    bool(cfg.learn_vars), cfg.merge_vars_thr,
                    cfg.em_signal_budget(N), debug=cfg.verbosity == 1, consts=consts,
                )
        return prior

    def exact_step(r1, gam1, gamw, probs, vars_, active, x1_prev):
        """EM and the exact phase of iteration `it`: (the next state, the
        outputs with "host", the vector the loop fetches)."""
        prior = em(r1, gam1, MixturePrior(probs, vars_, active))
        with span("solve"):
            out = _iteration_phase_exact(
                dm, fac, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                it > 1, rho, gamw, ts, consts,
            )
        out["host"] = _outputs(gam1, out, prior)
        return (out["r1"], out["gam1"], out["gamw"], *prior, out["x1_hat"]), out

    try:
        for it in range(it_start, cfg.iterations + 1):
            tracer.start()
            coll0 = shard.collectives() if shard is not None else 0
            _log(f"\n********************\niteration = {it}\n********************")

            if fac is None:
                prior = em(r1, gam1, prior)
                with span("probe"):
                    bern = probes.draw()
                with span("solve"):
                    out = _iteration_phase(
                        dm, aty_adj, y_raw, r1, gam1, prior, x1_hat,
                        it > 1, rho, gamw, mu_warm, bern, ts,
                        cfg.CG_max_iter, cfg.CG_err_tol,
                        debug=cfg.verbosity == 1, consts=consts,
                    )
                out["host"] = _outputs(gam1, out, prior)
                r1_in = r1  # the r1 this iteration denoises; dumped to _r1_it_<k>.bin
                r1, gam1, gamw, x1_hat = out["r1"], out["gam1"], out["gamw"], out["x1_hat"]
            else:
                state = (r1, gam1, gamw, *prior, x1_hat)
                if graph is not None and it >= first_steady:
                    state, nxt, out = graph.run(exact_step, state)
                else:
                    nxt, out = exact_step(*state)
                r1_in = state[0]
                r1, gam1, gamw, *p, x1_hat = nxt
                prior = MixturePrior(*p)
                with span("probe"):
                    probes.skip()
            mu_warm = out["x2_hat"]  # CG warm start (src/vamp.cpp:308-311, 753-754)
            # a replay's tensors are rewritten by the next replay, which the
            # side stream's copies to the host do not hold back: copy first
            own = ((lambda v: v.clone()) if graph is not None and graph.graph is not None
                   else (lambda v: v))

            # ONE batched host copy of every O(1) output; it also waits for
            # the iteration's device work
            with span("fetch"):
                host = out["host"].cpu().numpy()
            with span("report"):
                (gam1_denoise, alpha1_h, alpha2_h, gam2_h, gam1_h, gamw_h,
                 gam1_true_h, gam2_true_h, nmse) = host[:9].tolist()
                metrics = host[9:15]
                probs_h, vars_h = host[15:15 + L], host[15 + L:15 + 2 * L]
                act = host[15 + 2 * L:] > 0.5
                cg_iters = int(out["cg_iters"])

                # per-iteration artifacts (src/vamp.cpp:234-252): x1_hat/sqrt(N)
                # and the r1 denoised this iteration, written on the IO thread
                if write_outputs:
                    with span("dump.stage"):
                        writer.submit(dump_iteration, cfg, Mt, sqrt_n, it,
                                      stager.copy((own(x1_hat), own(r1_in))), lo,
                                      io_phases.setdefault(it, {}))

                metrics_history.append(metrics)
                params_row = [alpha1_h, gam1_denoise, alpha2_h, gam2_h, gamw_h]
                if write_outputs:
                    with span("csv"):
                        out_params.write_row(it, params_row)
                        out_metrics.write_row(it, metrics.tolist())
                        pr = probs_h[act]
                        vr = vars_h[act] / N
                        out_prior.write_row(it, [float(len(pr))] + pr.tolist() + vr.tolist())

                _log(f"alpha1 = {alpha1_h}")
                _log(f"gam1 = {gam1_denoise}")
                _log(f"gam2 = {gam2_h}  (true {gam2_true_h})")
                _log(f"alpha2 = {alpha2_h}")
                _log(f"new gam1 = {gam1_h}  (true {gam1_true_h})")
                _log(f"gamw = {gamw_h}")
                _log(f"CG iters = {cg_iters}")
                _log(f"metrics [R2_den, x1corr, R2_lmmse, x2corr, zcorr2_den, zcorr2_lmmse] = {metrics}")

                if cfg.checkpoint_file:
                    names = ("x1_hat", "r1", "mu_warm")
                    vecs = (own(x1_hat), own(r1), own(mu_warm))
                    # a sharded run gathers the full vectors here, on the main
                    # thread: a collective never runs on the IO thread
                    copy = (stager.copy(vecs) if shard is None
                            else HostCopy([gather_m(v, shard) for v in vecs]))
                    if is_writer():
                        writer.submit(
                            checkpoint_iteration, cfg, "linear", dm, it, copy, names,
                            dict(y_adj=y_adj_host), dict(gam1=gam1_h, gamw=gamw_h),
                            dict(probs=probs_h, vars=vars_h, active=act), probes.state(),
                        )
                if shard is not None:
                    iter_collectives.append(shard.collectives() - coll0)
            _log(tracer.line(tracer.stop(it, cg_iters, gam1=gam1_h, gamw=gamw_h)))
            it_done = it

            # stopping criterion (src/vamp.cpp:405-423), computed on device
            _log(f"x1_hat NMSE = {nmse if np.isfinite(nmse) else 'n/a (zero previous iterate)'}")
            if it > 1 and nmse < cfg.stop_criteria_thr:
                _log("...stopping criteria fulfilled")
                break
    finally:
        tracer.close()
        flush_timed(writer, setup, write_outputs)  # artifacts durably on disk even on error paths
    tracer.fold(io_phases)

    act = prior.active.cpu().numpy()
    return LinearResult(
        x1_hat_scaled=gather_m(x1_hat, shard).numpy().astype(np.float64)[:Mt] / sqrt_n,
        iterations_run=it_done,
        gam1=float(gam1),
        gamw=float(gamw),
        probs=prior.probs.cpu().numpy()[act],
        vars=prior.vars.cpu().numpy()[act],
        metrics_history=metrics_history,
        r1_scaled=gather_m(r1, shard).numpy().astype(np.float64)[:Mt] / sqrt_n,
        iter_seconds=[r.seconds for r in tracer.records],
        iter_collectives=iter_collectives,
        setup=setup,
        solver=solver,
        iter_phases=[r.phases for r in tracer.records],
    )
