"""`association_test` run mode: SE and LOO p-values (port of
vampomi_tpu/modes/association.py).

SE (reference src/main_meth.cpp:220-244): p_j = Phi(0; r1_j, sqrt(1/(gam1 N))),
flipped for r1_j <= 0; written to `<out>_it_<k>_pval_se.bin`.

LOO (reference src/main_meth.cpp:245-264 + src/data.cpp:385-417): leave-one-
out per-marker regression from closed-form sufficient statistics around a
single A-pass:

  y_mark^{(j)} = (y - z1) + X_j x̂_j / sqrt(N)      (raw X_j — quirk Q5)

  sumy_j   = Σ y_mod + sumx_j x̂_j / sqrt(N)
  sumxy_j  = (X y_mod)_j + sumsqx_j x̂_j / sqrt(N)
  sumsqy_j = ||y_mod||² + 2 x̂_j/sqrt(N) (X y_mod)_j + x̂_j²/N sumsqx_j

then the 1-D regression t-test (reference src/utilities.cpp:269-282) with
scipy's Student-t survival function, in f64 numpy on the host.
`--pval-method loo_std` adds back the standardized marker contribution
msig_j (X_j - mave_j) x̂_j / sqrt(N) — what z1 subtracted — instead of the
raw-marker quirk; the JAX package's docstring gives the reason.

On the card the statistics of a quantized design come from the hand-written
kernels: sumx and sumsqx from `row_moments_*` (exact int64 sums of the codes),
X y_mod from `atx_int8` / `atx_packed4` (f32, y_mod never rounded to bf16),
and z1 from the `ax_batch_*` pass behind `ax`.

Sharded over markers (`dm.shard`), every p-value is a function of its own
marker: a rank reads its slab of r1 or of the estimate, and writes its slab
of the p-value file.  LOO's z1 = A x̂ meets the other ranks in the one
all_reduce of `ax`, so y_mod is replicated; the row statistics stay local.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.stats import norm, t as student_t

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import parse_iteration, read_bin_slab, write_bin_slab
from ..ops.atx_int8 import atx_int8, chunk_rows
from ..ops.bf16 import atx_bf16
from ..ops.moments import row_moments_int8, row_moments_packed4
from ..ops.operator import PACKED4_DTYPE, QUANTIZED, DesignMatrix, ax
from ..ops.packed4 import atx_packed4
from ..sharding import span


def pvals_se(r1: np.ndarray, gam1: float, n: int) -> np.ndarray:
    scale = np.sqrt(1.0 / (gam1 * float(n)))
    p = norm.cdf(0.0, loc=r1, scale=scale)
    return np.where(r1 <= 0.0, 1.0 - p, p)


def linear_reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n: int) -> np.ndarray:
    """Vectorized port of the reference's 1-D regression t-test
    (src/utilities.cpp:269-282)."""
    s2y = (sumsqy - sumy * sumy / n) / (n - 1)
    s2x = (sumsqx - sumx * sumx / n) / (n - 1)
    sxy = (sumxy - sumx * sumy / n) / (n - 1)
    rxy = sxy / np.sqrt(s2x * s2y)
    tstat = rxy * np.sqrt((n - 2) / (1.0 - rxy * rxy))
    return 2.0 * student_t.sf(np.abs(tstat), df=n - 2)


def _loo_stats(dm: DesignMatrix, y_mod: np.ndarray):
    """Per-marker moments of the stored X and the X @ y_mod matvec, as f64
    host arrays (sumx, sumsqx, xy).  For a quantized design these are
    code-space moments (the t-test is invariant to per-marker affine maps;
    pvals_loo rescales the add-back coefficient)."""
    if dm.X.dtype in QUANTIZED:
        y = torch.as_tensor(y_mod, dtype=torch.float32).to(dm.device)
        if dm.X.dtype == PACKED4_DTYPE:
            mom, xy = row_moments_packed4(dm.X), atx_packed4(dm.X, y)
        else:
            mom, xy = row_moments_int8(dm.X), atx_int8(dm.X, y)
        mom = mom.cpu().numpy().astype(np.float64)
        return mom[:, 0], mom[:, 1], xy.cpu().numpy().astype(np.float64)
    # float designs: f64 sums one chunk of rows at a time, so no squared
    # copy of the whole of X exists
    X = dm.X
    m, n = X.shape
    sumx = torch.empty(m, dtype=torch.float64, device=dm.device)
    sumsqx = torch.empty_like(sumx)
    rows = chunk_rows(m, 2 * n)  # f64 values: 8 bytes where chunk_rows counts 4
    for lo in range(0, m, rows):
        c = X[lo:lo + rows].to(torch.float64)
        sumx[lo:lo + rows] = c.sum(dim=1)
        sumsqx[lo:lo + rows] = (c * c).sum(dim=1)
    if X.dtype == torch.bfloat16:
        # y in f32: a bf16 X @ y would round y and the output to bf16
        xy = atx_bf16(X, torch.as_tensor(y_mod, dtype=torch.float32).to(dm.device))
    else:
        xy = X @ torch.as_tensor(y_mod).to(device=dm.device, dtype=X.dtype)
    return (sumx.cpu().numpy(), sumsqx.cpu().numpy(),
            xy.cpu().numpy().astype(np.float64))


def pvals_loo(
    ds: Dataset, x1_hat_scaled_up: np.ndarray, standardized: bool = False
) -> np.ndarray:
    """x1_hat_scaled_up: estimate * sqrt(N) (internal scale), length Mt, or
    the rank's slab of it on a sharded design; returns the p-values of
    those markers.

    standardized=False reproduces the reference's raw-marker add-back (Q5,
    src/data.cpp:405); True adds back the standardized column that z1
    actually used: y_mark = y_mod + c_j X_j - d_j with c_j = msig_j x̂_j/√N,
    d_j = c_j·mave_j (for the quirk, c_j = x̂_j/√N, d_j = 0).
    """
    dm = ds.dm
    n = int(dm.n)
    lo, hi = span(int(dm.mt), dm.shard)
    m = hi - lo  # this design's real markers

    xp = torch.zeros(dm.m_pad, dtype=torch.float64)
    xp[:m] = torch.as_tensor(np.asarray(x1_hat_scaled_up, dtype=np.float64))
    z1 = ax(dm, xp.to(device=dm.device, dtype=dm.wd)).cpu().numpy().astype(np.float64)
    y_mod = ds.phen.y - z1

    sumx, sumsqx, xy = (a[:m] for a in _loo_stats(dm, y_mod))
    xh = x1_hat_scaled_up / np.sqrt(n)
    if standardized:
        # for a quantized design dm.msig/dm.mave are the code-space folded
        # vectors, so these coefficients are already in code units
        c = dm.msig.cpu().numpy().astype(np.float64)[:m] * xh
        d = c * dm.mave.cpu().numpy().astype(np.float64)[:m]
    elif dm.X.dtype in QUANTIZED:
        # raw marker X_j = s_j q_j + z_j: the quirk's raw-unit add-back
        # xh·X_j becomes (xh·s_j)·q_j in code space, plus the constant
        # xh·z_j — a uniform shift of y_mark that the t statistic is
        # invariant to, so it is dropped (d = 0)
        if ds.qscale is None:
            raise ValueError(
                "LOO raw-marker add-back on a quantized design needs the "
                "dequantization scale; load the dataset via load_dataset "
                "(Dataset.qscale) or use --pval-method loo_std"
            )
        c = xh * np.asarray(ds.qscale, dtype=np.float64)[lo:hi]  # qscale is global
        d = np.zeros(m)
    else:
        c = xh
        d = np.zeros(m)
    sum_ymod = float(np.sum(y_mod))
    ss_ymod = float(np.dot(y_mod, y_mod))

    sumy = sum_ymod + c * sumx - n * d
    sumxy = xy + c * sumsqx - d * sumx
    sumsqy = (
        ss_ymod + c * c * sumsqx + n * d * d
        + 2.0 * c * xy - 2.0 * d * sum_ymod - 2.0 * c * d * sumx
    )

    return linear_reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n)


def run_association_test(ds: Dataset, cfg: RunConfig) -> np.ndarray:
    """The p-value file of cfg.pval_method; returns the p-values this
    process wrote (its slab on a sharded design)."""
    lo, hi = span(int(ds.dm.mt), ds.dm.shard)
    n = int(ds.dm.n)

    if cfg.pval_method == "se":
        it_str = parse_iteration(cfg.r1_file)
        r1 = read_bin_slab(cfg.r1_file, hi - lo, lo)
        pvals = pvals_se(r1, cfg.gam1, n)
        out = os.path.join(cfg.out_dir, f"{cfg.out_name}_it_{it_str}_pval_se.bin")
    elif cfg.pval_method in ("loo", "loo_std"):
        it_str = parse_iteration(cfg.estimate_file)
        x1 = read_bin_slab(cfg.estimate_file, hi - lo, lo) * np.sqrt(float(n))
        pvals = pvals_loo(ds, x1, standardized=cfg.pval_method == "loo_std")
        out = os.path.join(
            cfg.out_dir, f"{cfg.out_name}_it_{it_str}_pval_{cfg.pval_method}.bin"
        )
    else:
        raise ValueError(f"unknown pval method {cfg.pval_method}")

    write_bin_slab(out, pvals, lo)
    return pvals
