"""High-level in-memory Python API: arrays in, arrays out (port of
vampomi_tpu/api.py).

The CLI (cli.py) is the flag-for-flag reference surface; this module is the
library entry point for users whose design matrix and phenotype are already
numpy arrays — no .bin/.phen files, no output directory.  It wraps the same
engine code the CLI drives (ops/operator.build_design →
engine/linear.infere_linear or engine/probit.infere_bin_class), so every
number matches a file-driven run at the same configuration and seed:

    import vampomi_tpu_torch.api as va
    fit = va.fit_linear(X, y, iterations=10, h2=0.8,
                        probs=[0.9, 0.1], vars=[0.0, 1e-2])
    fit.x1_hat_scaled          # (M,) posterior-mean effects, file units
    va.h2_estimate(fit)        # 1 - 1/gamma_w (reference scripts/metrics.py:134)
    p = va.association_pvals(fit, n=X.shape[0])       # SE p-values, in memory
    yhat = va.predict_linear(fit, X_new)              # out-of-sample score
    pfit = va.fit_probit(X, y01, iterations=10)       # binary trait, 0/1 labels
    labels = va.predict_probit(pfit, X_new)           # Phi(z) >= 0.5

Where the JAX package takes `mesh=`, this takes `device=` ("cuda" by
default; it raises without a card, and never runs on the CPU instead) and
`shard=`, the counterpart of its `mesh="auto"`: "auto" (the default) splits
the markers over the ranks of an initialised torch.distributed process
group (sharding.shard_for), and means one process where there is none, so
a caller without a group gets what it got before; None forces one process;
a sharding.Shard is taken as given.  X is the whole matrix on every rank, as
in JAX; each rank builds only its rows [lo, hi) of the design, and the
results come back gathered, the same on every rank.

    # python -m torch.distributed.run --nproc-per-node 2 fit.py, with
    # torch.distributed.init_process_group("nccl") in fit.py first
    fit = va.fit_probit(X, y01, iterations=10)        # each rank half the markers

Conventions (the reference's): `X` is sample-major (N, M) like sklearn, or
marker-major (M, N) with marker_major=True; linear `y` is scaled by 1/sd but
NOT centered (src/data.cpp:88-103); returned effects are in "file units"
(x1_hat / sqrt(N), src/vamp.cpp:237-239), what the `_it_<k>.bin` dumps hold.
Covariates are the z-scored (N, C) matrix, fitted once by the probit Newton
step (src/vamp_probit.cpp:525-617) for either model.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

from .config import RunConfig, resolve_device
from .engine.linear import LinearResult, infere_linear
from .engine.probit import ProbitResult, infere_bin_class
from .modes.association import pvals_se
from .ops.operator import DesignMatrix, ax, build_design
from .sharding import Shard, gather_m, local_rows, shard_for, span
from .utils.mathx import normal_cdf

__all__ = [
    "fit_linear", "fit_probit", "predict_linear", "predict_probit",
    "association_pvals", "h2_estimate", "standardize_phenotype", "LinearResult",
    "ProbitResult",
]


def _marker_major(X, marker_major: bool) -> np.ndarray:
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {X.shape}")
    return X if marker_major else np.ascontiguousarray(X.T)


def standardize_phenotype(y) -> tuple[np.ndarray, float]:
    """(y * 1/sd, 1/sd) — the reference's read_phen transform: scaled by the
    inverse sample sd, NOT centered (src/data.cpp:88-103; io/phen.py)."""
    y = np.asarray(y, dtype=np.float64).ravel()
    avg = float(y.sum() / y.size)
    ss = float(np.sum((y - avg) ** 2))
    if ss == 0.0:
        raise ValueError("phenotype is constant — cannot standardize")
    sqn = float(np.sqrt((y.size - 1.0) / ss))
    return y * sqn, sqn


def _make_config(n: int, mt: int, model: str, device: str, config: dict) -> RunConfig:
    cfg = RunConfig()
    # meth_file is the CLI's mandatory flag (cfg.check()); the API feeds
    # arrays directly, so mark the source for error messages only
    cfg.meth_file = "<in-memory>"
    for k, v in config.items():
        if not hasattr(cfg, k):
            raise TypeError(f"unknown configuration field {k!r} "
                            f"(see vampomi_tpu_torch.config.RunConfig)")
        setattr(cfg, k, list(v) if isinstance(v, tuple) else v)
    cfg.N, cfg.Mt, cfg.model, cfg.device = n, mt, model, str(device)
    return cfg


def _shard_of(shard, mt: int, device) -> Shard | None:
    """The Shard `shard` names for Mt markers: "auto" the rank's slab of an
    initialised process group (None without one), None one process, a
    Shard itself."""
    if isinstance(shard, str):
        if shard != "auto":
            raise ValueError(f"shard must be 'auto', None or a sharding.Shard, got {shard!r}")
        return shard_for(mt, torch.device(device))
    return shard


def _build(Xm: np.ndarray, device, cfg: RunConfig, shard: Shard | None = None) -> DesignMatrix:
    """The design of the (M, N) markers Xm; with a shard, of its rows
    [lo, hi)."""
    return build_design(local_rows(Xm, shard), compute_dtype=cfg.resolved_compute_dtype(),
                        device=resolve_device(device), alpha_scale=cfg.alpha_scale,
                        shard=shard)


def fit_linear(
    X,
    y,
    *,
    marker_major: bool = False,
    device: str = "cuda",
    standardize_y: bool = True,
    true_signal=None,
    x1hat_init=None,
    covariates=None,
    quiet: bool = False,
    shard="auto",
    **config,
) -> LinearResult:
    """Linear gVAMP on in-memory arrays.

    X: (N, M) sample-major (or (M, N) with marker_major=True), y: (N,) raw
    phenotype.  `config` kwargs are RunConfig fields (iterations, h2, probs,
    vars, rho, compute_dtype, lmmse_solver, seed, ...).  No files are
    written.  `quiet` suppresses the engine's reference-style narration.
    `covariates` (with config C > 0) are fitted once and taken out of y
    (src/vamp.cpp:153-169).  `shard` as in the module docstring.  Returns
    the engine LinearResult (x1_hat_scaled in file units, all Mt markers)."""
    Xm = _marker_major(X, marker_major)
    y = np.asarray(y, dtype=np.float64).ravel()
    if y.size != Xm.shape[1]:
        raise ValueError(f"y has {y.size} samples but X has {Xm.shape[1]}")
    if standardize_y:
        y, _ = standardize_phenotype(y)
    cfg = _make_config(y.size, Xm.shape[0], "linear", device, config)
    dm = _build(Xm, device, cfg, _shard_of(shard, Xm.shape[0], device))
    sink = io.StringIO() if quiet else None
    with contextlib.redirect_stdout(sink) if sink else contextlib.nullcontext():
        return infere_linear(
            dm, y, cfg,
            true_signal=None if true_signal is None else np.asarray(true_signal, dtype=np.float64),
            x1hat_init=None if x1hat_init is None else np.asarray(x1hat_init, dtype=np.float64),
            covariates=None if covariates is None else np.asarray(covariates, dtype=np.float64),
            write_outputs=False,
        )


def fit_probit(
    X,
    y,
    *,
    marker_major: bool = False,
    device: str = "cuda",
    true_signal=None,
    x1hat_init=None,
    covariates=None,
    quiet: bool = False,
    shard="auto",
    **config,
) -> ProbitResult:
    """Probit GLM-VAMP (binary classification) on in-memory arrays.

    y must be 0/1 (used raw — the reference never standardizes the probit
    phenotype, src/data.cpp:40-43).  Covariates, if given (with config
    C > 0), are the z-scored (N, C) matrix and are fit by the one-time
    Newton step (src/vamp_probit.cpp:525-617).  `shard` as in the module
    docstring."""
    Xm = _marker_major(X, marker_major)
    y = np.asarray(y, dtype=np.float64).ravel()
    if y.size != Xm.shape[1]:
        raise ValueError(f"y has {y.size} samples but X has {Xm.shape[1]}")
    bad = ~np.isin(y, (0.0, 1.0))
    if bad.any():
        raise ValueError(f"probit y must be 0/1 (found {y[bad][:3]} ...)")
    cfg = _make_config(y.size, Xm.shape[0], "bin_class", device, config)
    dm = _build(Xm, device, cfg, _shard_of(shard, Xm.shape[0], device))
    sink = io.StringIO() if quiet else None
    with contextlib.redirect_stdout(sink) if sink else contextlib.nullcontext():
        return infere_bin_class(
            dm, y, cfg,
            true_signal=None if true_signal is None else np.asarray(true_signal, dtype=np.float64),
            x1hat_init=None if x1hat_init is None else np.asarray(x1hat_init, dtype=np.float64),
            covariates=None if covariates is None else np.asarray(covariates, dtype=np.float64),
            write_outputs=False,
        )


def _beta_of(fit) -> np.ndarray:
    if isinstance(fit, (LinearResult, ProbitResult)):
        return np.asarray(fit.x1_hat_scaled, dtype=np.float64)
    return np.asarray(fit, dtype=np.float64).ravel()


def predict_linear(
    fit,
    X_new,
    *,
    marker_major: bool = False,
    device: str = "cuda",
    compute_dtype: str = "auto",
    alpha_scale: float = 1.0,
    shard="auto",
) -> np.ndarray:
    """Out-of-sample linear score: A_test (beta * sqrt(N_test)).

    Mirrors the reference test mode's rescale-by-sqrt(N_test) of a file-unit
    estimate (src/main_meth.cpp:174-175): X_new is standardized with ITS OWN
    marker statistics, exactly as a test-split .bin would be.  `fit` is a
    LinearResult or a bare (M,) file-unit effect vector.  The score is in
    standardized-phenotype units (compare against y_test * 1/sd_test).
    `shard` as in the module docstring: a rank scores its slab of the
    markers, and the one all_reduce of the pass hands every rank the score."""
    beta = _beta_of(fit)
    Xm = _marker_major(X_new, marker_major)
    if Xm.shape[0] != beta.size:
        raise ValueError(f"fit has {beta.size} markers but X_new has {Xm.shape[0]}")
    cfg = RunConfig(compute_dtype=compute_dtype, alpha_scale=alpha_scale, device=str(device))
    sh = _shard_of(shard, beta.size, device)
    dm = _build(Xm, device, cfg, sh)
    lo, hi = span(beta.size, sh)
    xp = np.zeros(dm.m_pad, dtype=np.float64)
    xp[:hi - lo] = beta[lo:hi] * np.sqrt(float(Xm.shape[1]))
    z = ax(dm, torch.as_tensor(xp).to(device=dm.device, dtype=dm.wd))
    return z.cpu().numpy().astype(np.float64)


def association_pvals(fit, n: int, method: str = "se", *, shard="auto") -> np.ndarray:
    """Marker association p-values from a fit, fully in memory.

    method="se": the reference's r1/gam1 normal test (scripts/p_vals.py:44-62,
    src/main_meth.cpp:233-239) on the fit's final (r1, gam1) extrinsic pair.
    The LOO variants need the raw design matrix and live in
    modes/association.pvals_loo (file-driven).  `shard` as in the module
    docstring: a rank tests its slab of the markers and the p-values come
    back gathered (on the rank's card under NCCL, else on the host)."""
    if method != "se":
        raise ValueError("in-memory association supports method='se'; "
                         "use modes/association.run_association_test or the "
                         "CLI --run-mode association_test for loo/loo_std")
    if fit.r1_scaled is None:
        raise ValueError("fit carries no r1")
    r1 = np.asarray(fit.r1_scaled)
    nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    sh = _shard_of(shard, r1.size, f"cuda:{torch.cuda.current_device()}" if nccl else "cpu")
    p = pvals_se(local_rows(r1, sh), float(fit.gam1), int(n))
    return p if sh is None else gather_m(torch.as_tensor(p), sh).numpy()


def h2_estimate(fit: LinearResult) -> float:
    """Heritability estimate 1 - 1/gamma_w (reference scripts/metrics.py:134;
    gamma_w is the EM noise precision of the 1/sd-scaled phenotype)."""
    return 1.0 - 1.0 / float(fit.gamw)


def predict_probit(
    fit,
    X_new,
    *,
    marker_major: bool = False,
    device: str = "cuda",
    compute_dtype: str = "auto",
    covariates=None,
    return_proba: bool = False,
    shard="auto",
) -> np.ndarray:
    """Probit prediction on new samples.

    Default: 0/1 class labels via Phi(z) >= 0.5 — the reference's test-mode
    decision rule (src/main_meth_probit.cpp:160-199).  return_proba=True
    returns Phi(z + Z @ cov_eff) instead.  Covariate effects ride along when
    `fit` is a ProbitResult with cov_eff and `covariates` is given.  `shard`
    as in the module docstring."""
    z = predict_linear(fit, X_new, marker_major=marker_major, device=device,
                       compute_dtype=compute_dtype, shard=shard)
    if (covariates is not None and isinstance(fit, ProbitResult)
            and fit.cov_eff is not None):
        z = z + np.asarray(covariates, dtype=np.float64) @ np.asarray(
            fit.cov_eff, dtype=np.float64)
    proba = normal_cdf(torch.as_tensor(z)).numpy()
    return proba if return_proba else (proba >= 0.5).astype(np.int64)
