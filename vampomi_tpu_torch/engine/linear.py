"""Linear-model gVAMP engine (port of vampomi_tpu/engine/linear.py;
reference `vamp::infere_linear`, src/vamp.cpp:110-438).

A host loop writes the per-iteration artifacts around three phases:

  * `_em_phase`              — EM prior update + merge + signal budget
                               (reference src/vamp.cpp:531-643)
  * `_iteration_phase`       — denoising + CG LMMSE + Hutchinson Onsager +
                               noise-precision update + error measures
  * `_iteration_phase_eigen` — the same with the exact eigen-LMMSE solve:
                               one two-column ax_batch pass and one atx pass
                               over X per iteration

PyTorch runs eagerly, so the phases are plain functions; each iteration's
O(1) outputs reach the host in ONE batched copy, which is also the
iteration's synchronisation point.  Tensors handed to the IO thread are
never updated in place.

Scaling conventions (must match the reference to reproduce its numbers):
  * internal x-vectors carry a sqrt(N) factor (A has 1/sqrt(N) baked in);
  * saved estimates are divided by sqrt(N) (src/vamp.cpp:237-239);
  * prior variances were multiplied by N at init (src/vamp.cpp:87-88);
  * gamma clamps [1e-11, 1e11] (src/vamp.hpp:33-34);
  * gam1 is damped with rho after the LMMSE step (src/vamp.cpp:346), x1_hat
    is damped after denoising for it > 1 (src/vamp.cpp:208-211).

Not ported yet (ROADMAP.md): the per-iteration spectral solver,
checkpoint/resume, the eigen cache and covariates.  Where the JAX engine
would fall back to the spectral solver (eigen residual above tolerance, eigen
build over budget) this port raises instead.
"""

from __future__ import annotations

import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import RunConfig
from ..io.bin_io import iteration_file, write_marker_file
from ..io.csv_writer import PositionalCSV
from ..ops.cg import cg_solve
from ..ops.eigen import EigenFactor, build_eigen, eigen_weights
from ..ops.operator import DesignMatrix, atx, ax, ax_batch, f64
from ..ops.spectral import build_spectral
from ..prior.mixture import (
    MixturePrior, em_update, g1, g1d, init_prior, merge_components_device,
)
from ..utils.async_writer import AsyncWriter
from ..utils.telemetry import Tracer
from .metrics import prediction_metrics, signal_metrics

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
    # wall seconds of the once-per-run setup, and the eigen residual:
    # {"aty", "gram", "eigh", "eigen_resid"} as far as the solver ran them
    setup: dict | None = None


def _em_phase(dm: DesignMatrix, r1, gam1, prior: MixturePrior,
              em_max_iter, em_err_thr, learn_vars, merge_vars_thr,
              signal_budget, debug: bool = False) -> MixturePrior:
    """EM prior update + component merge + truth-free signal budget
    (reference src/vamp.cpp:531-643; JAX engine/linear.py:92-129).

    `signal_budget` (f64, 0 = off = reference parity) caps the slab's total
    second moment mt·Σ_{j≥1} p_j v_j at N·h2_max by rescaling the slab
    variances after each EM call — the stabilizer for wide M/N."""
    dev = dm.device
    prior = em_update(
        r1, gam1, prior, dm.mmask, dm.mt,
        em_max_iter=em_max_iter, em_err_thr=em_err_thr, learn_vars=learn_vars,
        debug=debug,
    )
    prior = merge_components_device(prior, merge_vars_thr)
    slab = prior.active & (torch.arange(prior.L, device=dev) >= 1)
    total = dm.mt * torch.where(slab, prior.probs * prior.vars, 0.0).sum()
    budget = f64(signal_budget, dev)
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
    alpha1 = (g1d(r1, gam1, prior) * dm.mmask).sum().to(torch.float64) / dm.mt
    eta1 = gam1 / alpha1
    gam2 = _clamp(eta1 - gam1)
    r2 = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)
    return x1_hat, alpha1, eta1, gam2, r2


def _nmse(x1_hat, x1_hat_prev):
    """Stopping-criterion NMSE (src/vamp.cpp:409-423); inf on a zero
    previous iterate."""
    dx = x1_hat - x1_hat_prev
    denom = torch.dot(x1_hat_prev, x1_hat_prev).to(torch.float64)
    return torch.where(
        denom > 0.0,
        torch.sqrt(torch.dot(dx, dx).to(torch.float64)
                   / torch.where(denom > 0.0, denom, 1.0)),
        math.inf,
    )


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
) -> dict:
    """One linear-VAMP iteration with the CG LMMSE solver and the
    Hutchinson Onsager estimate (JAX engine/linear.py:132-251)."""
    wd = dm.wd
    dev = dm.device
    c = lambda s: f64(s, dev).to(wd)  # noqa: E731 — scalar → work dtype
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

    x1_hat, alpha1, eta1, gam2, r2 = _denoise(
        dm, r1, gam1, prior, x1_hat_prev, damp, rho, c)
    z1 = ax(dm, x1_hat)

    # diagnostic "true" gam2 against the known signal (src/vamp.cpp:263-270)
    dev2 = r2 - sqrt_n_c * ts
    gam2_true = dm.mt / torch.dot(dev2, dev2).to(torch.float64)

    x1_corr, _ = signal_metrics(x1_hat, ts, dm.n)
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
    alpha2 = gam2 * torch.dot(bern, invq_bern).to(torch.float64)
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1    # damping (src/vamp.cpp:346)
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam1_true = dm.mt / torch.dot(dev1, dev1).to(torch.float64)

    # noise precision EM update (src/vamp.cpp:504-529)
    z2 = ax(dm, x2_hat)
    resid = z2 - y_raw
    trace_vec = atx(dm, ax(dm, invq_bern))
    trace_corr = torch.dot(bern, trace_vec).to(torch.float64) * dm.mt
    gamw_new = dm.n / (torch.dot(resid, resid).to(torch.float64) + trace_corr)

    x2_corr, _ = signal_metrics(x2_hat, ts, dm.n)
    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)
    metrics = torch.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse])

    return dict(
        nmse=_nmse(x1_hat, x1_hat_prev),
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


def _iteration_phase_eigen(
    dm: DesignMatrix,
    ef: EigenFactor,
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
) -> dict:
    """One linear-VAMP iteration with the eigen-LMMSE solver (JAX
    engine/linear.py:368-482): the LMMSE solve and both traces are exact,
    and X is read twice — one two-column ax_batch pass for z1 = A x1 and
    A v, one atx pass for A^T q."""
    wd = dm.wd
    dev = dm.device
    c = lambda s: f64(s, dev).to(wd)  # noqa: E731
    gam1 = f64(gam1, dev)
    gamw = f64(gamw, dev)
    r1 = r1.to(wd)
    x1_hat_prev = x1_hat_prev.to(wd)
    y_raw = y_raw.to(wd)
    aty_adj = aty_adj.to(wd)
    ts = true_signal.to(wd)
    sqrt_n_c = c(math.sqrt(dm.n))

    x1_hat, alpha1, eta1, gam2, r2 = _denoise(
        dm, r1, gam1, prior, x1_hat_prev, damp, rho, c)

    dev2 = r2 - sqrt_n_c * ts
    gam2_true = dm.mt / torch.dot(dev2, dev2).to(torch.float64)

    # ---------------- LMMSE, exact, in the eigenbasis ----------------
    v = c(gamw) * aty_adj + c(gam2) * r2
    Z = ax_batch(dm, torch.stack([x1_hat, v], dim=1))
    z1 = Z[:, 0]
    av = Z[:, 1]
    d, T = eigen_weights(ef, gamw, gam2)      # d_i = 1/(gam2 + gamw lam_i)
    q = ef.U @ (d.to(wd) * (ef.U.T @ av))    # S^{-1} A v == A x2_hat
    x2_hat = (v - c(gamw) * atx(dm, q)) / c(gam2)
    z2 = q

    x1_corr, _ = signal_metrics(x1_hat, ts, dm.n)
    r2_den, corr_y2_den = prediction_metrics(z1, y_raw)

    # exact traces from the eigenvalues
    n64 = float(ef.n)
    tr_qinv = T + (dm.mt - n64) / gam2
    tr_ata_qinv = (n64 - gam2 * T) / gamw
    alpha2 = gam2 * tr_qinv / dm.mt
    eta2 = gam2 / alpha2
    gam1_new = _clamp(eta2 - gam2)
    gam1_new = rho * gam1_new + (1.0 - rho) * gam1
    r1_new = (c(eta2) * x2_hat - c(gam2) * r2) / c(gam1_new)

    dev1 = r1_new - sqrt_n_c * ts
    gam1_true = dm.mt / torch.dot(dev1, dev1).to(torch.float64)

    resid = z2 - y_raw
    gamw_new = dm.n / (torch.dot(resid, resid).to(torch.float64) + tr_ata_qinv)

    x2_corr, _ = signal_metrics(x2_hat, ts, dm.n)
    r2_lmmse, corr_y2_lmmse = prediction_metrics(z2, y_raw)
    metrics = torch.stack(
        [r2_den, x1_corr, r2_lmmse, x2_corr, corr_y2_den, corr_y2_lmmse])

    return dict(
        nmse=_nmse(x1_hat, x1_hat_prev),
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


def choose_lmmse_solver(cfg: RunConfig, mt: int, n: int) -> str:
    """Resolve cfg.lmmse_solver with the JAX engine's rule
    (engine/linear.py:485-521): "auto" picks the spectral path when the
    one-time Gram build is clearly amortized (2048 <= N <= spectral_max_n
    and Mt >= 4N), else CG.  The warm-cache upgrade to eigen needs
    --eigen-cache, which is not ported, and this port runs on one device."""
    s = cfg.lmmse_solver
    if s != "auto":
        return s
    if n <= cfg.spectral_max_n and n >= 2048 and mt >= 4 * n:
        return "spectral"
    return "cg"


def warn_em_stability(cfg: RunConfig, mt: int, n: int) -> bool:
    """One-line stderr warning when the EM hyperparameter updates are on in
    a regime where they are measured to collapse (EM_STABILITY.json: every
    M/N >= 16 case except the smallest N diverged, engine and f64 numpy
    oracle alike — inherited from the reference's EM, src/vamp.cpp:531-643).
    Returns True when the warning fired."""
    risky = bool(cfg.learn_vars) and n > 0 and mt >= 16 * n
    if risky:
        print(
            f"WARNING: EM prior/noise learning is ON at M/N = {mt / n:.0f} "
            "(>= 16), where the EM recursion is measured to collapse "
            "(EM_STABILITY.json) — consider --em-h2-budget 0.9 (truth-free "
            "signal-budget stabilizer), a longer --learn-prior-delay, "
            "or --learn-vars 0 with known variances",
            file=sys.stderr, flush=True,
        )
    return risky


def build_eigen_budgeted(fac, cfg: RunConfig):
    """build_eigen under cfg.eigen_build_budget wall seconds (0 = unlimited).

    cuSOLVER's eigh cannot be interrupted, so the budget is checked when it
    returns.  Over budget the JAX engine falls back to the per-iteration
    spectral solver (engine/linear.py:622-641); that solver is not ported
    yet, so this raises instead."""
    t0 = time.time()
    ef, diag = build_eigen(fac)
    took = time.time() - t0
    if cfg.eigen_build_budget > 0 and took > cfg.eigen_build_budget:
        raise RuntimeError(
            f"eigen build took {took:.1f}s, over --eigen-build-budget "
            f"{cfg.eigen_build_budget:.0f}s; the spectral fallback is not "
            "ported yet (ROADMAP.md): raise the budget or pass "
            "--lmmse-solver cg")
    return ef, diag


def _draw_probe(gen: torch.Generator, dm: DesignMatrix) -> torch.Tensor:
    """Fresh Rademacher trace probe ±1/sqrt(Mt) (seeded; fixes reference
    quirk Q4).  Drawn from a CPU generator and copied to the run's device,
    so one seed gives the same probes on the CPU and on a card."""
    signs = torch.randint(0, 2, (dm.m_pad,), generator=gen) * 2 - 1
    scale = torch.tensor(1.0 / math.sqrt(dm.mt), dtype=dm.wd)
    return (signs.to(dm.wd) * scale).to(dm.device) * dm.mmask


def _log(msg: str):
    print(msg, flush=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    file units; `dm` is the design operator on the run's device."""
    not_ported = [name for name, on in (
        ("--resume-file", cfg.resume_file),
        ("--checkpoint-file", cfg.checkpoint_file),
        ("--eigen-cache", cfg.eigen_cache),
        ("covariates (--C > 0)", cfg.C > 0 or (
            covariates is not None and covariates.shape[1] > 0)),
    ) if on]
    if not_ported:
        raise NotImplementedError(
            f"{', '.join(not_ported)}: not ported yet (see ROADMAP.md)")

    M_pad = dm.m_pad
    Mt = int(dm.mt)
    N = int(dm.n)
    sqrt_n = float(np.sqrt(N))
    wd = dm.wd
    dev = dm.device
    # the reference narrates hyperparameters unconditionally; --verbosity 1
    # adds the per-CG / per-EM residual prints (the phases' debug flag)

    def pad_m(vec):
        out = np.zeros(M_pad, dtype=np.float64)
        if vec is not None:
            out[: len(vec)] = vec
        return torch.as_tensor(out).to(device=dev, dtype=wd)

    ts = pad_m(true_signal)
    # warm start: x1_hat = r1 = x1hat_init / sqrt(N) (src/vamp.cpp:70-79)
    init_vec = pad_m(np.asarray(x1hat_init) / sqrt_n if x1hat_init is not None else None)
    x1_hat = init_vec
    r1 = init_vec

    y_raw = torch.as_tensor(np.asarray(y, dtype=np.float64)).to(device=dev, dtype=wd)

    prior = init_prior(cfg.probs, cfg.vars, N, device=dev)
    gam1 = f64(float(cfg.gam1), dev)
    gamw = f64(1.0 / (1.0 - cfg.h2), dev)  # src/main_meth.cpp:52
    rho = float(cfg.rho)
    mu_warm = torch.zeros(M_pad, dtype=wd, device=dev)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(cfg.seed))

    out_params = out_metrics = out_prior = None
    if write_outputs:
        prior_header = (
            ["iteration", "number of components"]
            + [f"prob{i}" for i in range(len(cfg.probs))]
            + [f"var{i}" for i in range(len(cfg.vars))]
        )
        base = f"{cfg.out_dir}/{cfg.out_name}"
        out_metrics = PositionalCSV(base + "_metrics.csv", METRICS_HEADER)
        out_params = PositionalCSV(base + "_params.csv", PARAMS_HEADER)
        out_prior = PositionalCSV(base + "_prior.csv", prior_header)

    solver = choose_lmmse_solver(cfg, Mt, N)
    if solver == "spectral":
        raise NotImplementedError(
            f"the LMMSE solver resolved to 'spectral' (--lmmse-solver "
            f"{cfg.lmmse_solver}, N={N}, Mt={Mt}), which is not ported yet "
            "(ROADMAP.md): pass --lmmse-solver eigen or --lmmse-solver cg")
    if solver not in ("cg", "eigen"):
        raise ValueError(f"unknown LMMSE solver {solver!r}")
    warn_em_stability(cfg, Mt, N)

    setup = {}
    ef = None
    t_aty = time.time()
    aty_adj = atx(dm, y_raw)  # constant across iterations (no covariates yet)
    _sync(dev)
    setup["aty"] = time.time() - t_aty
    if solver == "eigen":
        t_fac = time.time()
        fac = build_spectral(dm)
        _sync(dev)
        setup["gram"] = time.time() - t_fac
        _log(f"spectral LMMSE factor built in {setup['gram']:.3f}s "
             f"(N={N}; exact solves + exact Onsager from here on)")
        t_eig = time.time()
        ef, eig_diag = build_eigen_budgeted(fac, cfg)
        del fac
        setup["eigh"] = time.time() - t_eig
        setup["eigen_resid"] = eig_diag["resid"]
        _log(f"eigenbasis of K built in {setup['eigh']:.3f}s "
             f"(residual {eig_diag['resid']:.2e}, "
             f"orthogonality {eig_diag['ortho']:.2e}, torch.linalg.eigh f64)")
        if eig_diag["resid"] > EIGEN_RESID_TOL:
            raise RuntimeError(
                f"eigen residual {eig_diag['resid']:.2e} above "
                f"{EIGEN_RESID_TOL:g}: the JAX engine falls back to the "
                "per-iteration spectral solver here, which is not ported yet "
                "(ROADMAP.md); pass --lmmse-solver cg")

    tracer = Tracer(
        path=(f"{cfg.out_dir}/{cfg.out_name}_trace.jsonl"
              if write_outputs and cfg.trace else None),
        model="linear",
        solver=solver,
    )
    itemsize = dm.X.element_size()

    # device→host artifact IO overlaps the next iteration's compute
    writer = AsyncWriter()

    def _dump_iteration(k, x1_dev, r1_dev):
        write_marker_file(
            iteration_file(cfg.out_dir, cfg.out_name, k), x1_dev, Mt, sqrt_n)
        write_marker_file(
            iteration_file(cfg.out_dir, cfg.out_name, k, kind="r1_"),
            r1_dev, Mt, sqrt_n)

    metrics_history = []
    it_done = 0
    L = prior.L

    try:
        for it in range(1, cfg.iterations + 1):
            tracer.start()
            _log(f"\n********************\niteration = {it}\n********************")

            # EM prior update + merge, on the device (src/vamp.cpp:186-187)
            if it > cfg.learn_prior_delay:
                prior = _em_phase(
                    dm, r1, gam1, prior, cfg.EM_max_iter, cfg.EM_err_thr,
                    bool(cfg.learn_vars), cfg.merge_vars_thr,
                    cfg.em_signal_budget(N), debug=cfg.verbosity == 1,
                )

            x1_prev = x1_hat
            r1_in = r1  # the r1 this iteration denoises; dumped to _r1_it_<k>.bin
            if solver == "eigen":
                out = _iteration_phase_eigen(
                    dm, ef, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                    it > 1, rho, gamw, ts,
                )
            else:
                out = _iteration_phase(
                    dm, aty_adj, y_raw, r1, gam1, prior, x1_prev,
                    it > 1, rho, gamw, mu_warm, _draw_probe(gen, dm), ts,
                    cfg.CG_max_iter, cfg.CG_err_tol,
                    debug=cfg.verbosity == 1,
                )

            gam1_pre = gam1  # params CSV records the pre-LMMSE gam1
            x1_hat = out["x1_hat"]
            mu_warm = out["x2_hat"]  # CG warm start (src/vamp.cpp:308-311, 753-754)
            r1 = out["r1"]
            gam1 = out["gam1"]
            gamw = out["gamw"]

            # ONE batched host copy of every O(1) output; it also waits for
            # the iteration's device work
            host = torch.cat([
                torch.stack([gam1_pre, out["alpha1"], out["alpha2"], out["gam2"],
                             out["gam1"], out["gamw"], out["gam1_true"],
                             out["gam2_true"], out["nmse"]]),
                out["metrics"], prior.probs, prior.vars,
                prior.active.to(torch.float64),
            ]).cpu().numpy()
            (gam1_denoise, alpha1_h, alpha2_h, gam2_h, gam1_h, gamw_h,
             gam1_true_h, gam2_true_h, nmse) = host[:9].tolist()
            metrics = host[9:15]
            probs_h, vars_h = host[15:15 + L], host[15 + L:15 + 2 * L]
            act = host[15 + 2 * L:] > 0.5
            cg_iters = int(out["cg_iters"])

            # per-iteration artifacts (src/vamp.cpp:234-252): x1_hat/sqrt(N)
            # and the r1 denoised this iteration, written on the IO thread
            if write_outputs:
                writer.submit(_dump_iteration, it, x1_hat, r1_in)

            metrics_history.append(metrics)
            params_row = [alpha1_h, gam1_denoise, alpha2_h, gam2_h, gamw_h]
            if write_outputs:
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

            rec = tracer.stop(it, cg_iters, M_pad, N, itemsize,
                              gam1=gam1_h, gamw=gamw_h)
            _log(f"iteration time = {rec.seconds:.3f}s  "
                 f"(~{rec.matrix_passes} matrix passes, {rec.gbps:.1f} GB/s)  "
                 f"total = {tracer.total_comp_time:.3f}s")
            it_done = it

            # stopping criterion (src/vamp.cpp:405-423), computed on device
            _log(f"x1_hat NMSE = {nmse if np.isfinite(nmse) else 'n/a (zero previous iterate)'}")
            if it > 1 and nmse < cfg.stop_criteria_thr:
                _log("...stopping criteria fulfilled")
                break
    finally:
        writer.close()  # artifacts durably on disk even on error paths

    act = prior.active.cpu().numpy()
    return LinearResult(
        x1_hat_scaled=x1_hat.cpu().numpy().astype(np.float64)[:Mt] / sqrt_n,
        iterations_run=it_done,
        gam1=float(gam1),
        gamw=float(gamw),
        probs=prior.probs.cpu().numpy()[act],
        vars=prior.vars.cpu().numpy()[act],
        metrics_history=metrics_history,
        r1_scaled=r1.cpu().numpy().astype(np.float64)[:Mt] / sqrt_n,
        iter_seconds=[r.seconds for r in tracer.records],
        setup=setup,
    )
