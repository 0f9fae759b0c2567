"""The standardized design-matrix operator A (port of vampomi_tpu/ops/operator.py).

A is never materialized.  As in the JAX package,

    A x   = ( X^T (sigma_inv ∘ x) - (mu · (sigma_inv ∘ x)) 1 ) / sqrt(N)
    A^T y = sigma_inv ∘ ( X y - mu (1^T y) ) / sqrt(N)

so each product is one dense pass over the (M, N) marker-major X plus O(M)
and O(N) rank-1 corrections.

Precision policy: every M- or N-length vector lives in the work dtype `wd`
(f32 for int8 or f32 X, f64 for the f64 CPU oracle); O(1) quantities stay
f64 in the callers.  Standardization statistics are computed in f64 on the
host and cast once.

int8 X: the A^T y direction (`atx`) runs the hand-written CUDA kernel
`ops/atx_int8.py` on a card and its plain version on the CPU.  The other
int8 products (`ax`, `ax_batch`, `atx_batch`) are plain PyTorch: one chunk of
marker rows is upcast to f32 and multiplied in f32 (TF32 off), so no f32 copy
of the whole of X exists.  This is MORE exact than the JAX int8 path, which
contracts bf16 x bf16 into f32 and so rounds w (and, off the Pallas kernel,
y) to bf16 (vampomi_tpu/ops/operator.py:186-197): a bf16 torch.matmul would
instead round every partial sum to bf16, so the port does not use one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .atx_int8 import PLAIN_CHUNK_BYTES, atx_int8, chunk_rows


class DesignMatrix(NamedTuple):
    """The raw data and the fused standardization vectors on one device.

    X          : (Mt, N) raw marker data (f64 or f32) or int8 codes.
    mave       : (Mt,) per-marker mean, work dtype.
    msig       : (Mt,) per-marker inverse sd (or 1/sd^alpha), work dtype.
    mmask      : (Mt,) 1.0 for real markers, work dtype (no padding here).
    inv_sqrt_n : () 1/sqrt(N) in the work dtype.
    n, mt      : sample count and marker count, as Python floats.
    """

    X: torch.Tensor
    mave: torch.Tensor
    msig: torch.Tensor
    mmask: torch.Tensor
    inv_sqrt_n: torch.Tensor
    n: float
    mt: float

    @property
    def m_pad(self) -> int:
        return self.X.shape[0]

    @property
    def wd(self) -> torch.dtype:
        """Work dtype for vector math: f32 for int8 X, else X's own dtype."""
        return torch.float32 if self.X.dtype == torch.int8 else self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device


def f64(x, device) -> torch.Tensor:
    """x (Python number or tensor) as an f64 tensor on `device` — O(1)
    quantities are f64 everywhere (a bare torch.as_tensor(float) is f32)."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _row_chunks(m: int, n: int):
    rows = chunk_rows(m, n, PLAIN_CHUNK_BYTES)
    for lo in range(0, m, rows):
        yield lo, min(m, lo + rows)


def _xt_w(dm: DesignMatrix, w: torch.Tensor) -> torch.Tensor:
    """X^T w for w (M,) or (M, K) in the work dtype → (N,) or (N, K)."""
    if dm.X.dtype != torch.int8:
        return dm.X.T @ w
    out = None
    for lo, hi in _row_chunks(*dm.X.shape):
        part = dm.X[lo:hi].to(torch.float32).T @ w[lo:hi]
        out = part if out is None else out + part
    return out


def _x_y(dm: DesignMatrix, ys: torch.Tensor) -> torch.Tensor:
    """X ys for ys (N, K) in the work dtype → (M, K) (plain, any dtype)."""
    if dm.X.dtype != torch.int8:
        return dm.X @ ys
    out = torch.empty((dm.X.shape[0], ys.shape[1]), dtype=torch.float32,
                      device=dm.device)
    for lo, hi in _row_chunks(*dm.X.shape):
        torch.matmul(dm.X[lo:hi].to(torch.float32), ys, out=out[lo:hi])
    return out


def ax(dm: DesignMatrix, x: torch.Tensor) -> torch.Tensor:
    """z = A x for x (M,) → (N,), in the work dtype (reference data::Ax,
    src/data.cpp:340-373)."""
    w = dm.msig * x.to(dm.wd)
    z = _xt_w(dm, w)
    corr = torch.dot(dm.mave, w)
    return (z - corr) * dm.inv_sqrt_n


def atx(dm: DesignMatrix, y: torch.Tensor) -> torch.Tensor:
    """v = A^T y for y (N,) → (M,) (reference data::ATx, src/data.cpp:315-333).

    int8 X goes through `atx_int8`: the CUDA kernel on a card, its plain
    version on the CPU; both keep y in f32."""
    yc = y.to(dm.wd)
    if dm.X.dtype == torch.int8:
        xy = atx_int8(dm.X, yc.contiguous())
    else:
        xy = dm.X @ yc
    v = dm.msig * (xy - dm.mave * yc.sum())
    return v * dm.inv_sqrt_n


def ax_batch(dm: DesignMatrix, xs: torch.Tensor) -> torch.Tensor:
    """A @ xs for xs (M, K) → (N, K): the K right-hand sides share one pass
    over X (the two-column pass of every eigen iteration, and CG)."""
    w = dm.msig[:, None] * xs.to(dm.wd)
    z = _xt_w(dm, w)
    corr = dm.mave @ w  # (K,)
    return (z - corr[None, :]) * dm.inv_sqrt_n


def atx_batch(dm: DesignMatrix, ys: torch.Tensor) -> torch.Tensor:
    """A^T @ ys for ys (N, K) → (M, K)."""
    yc = ys.to(dm.wd)
    xy = _x_y(dm, yc)
    v = dm.msig[:, None] * (xy - torch.outer(dm.mave, yc.sum(dim=0)))
    return v * dm.inv_sqrt_n


def normal_eq_mult(dm: DesignMatrix, v: torch.Tensor, tau, gam2) -> torch.Tensor:
    """(tau · A^T A + gam2 · I) v — the LMMSE system operator (reference
    vamp::lmmse_mult, src/vamp.cpp:645-662).  v is (M,) or (M, K)."""
    tau_c = f64(tau, dm.device).to(dm.wd)
    gam2_c = f64(gam2, dm.device).to(dm.wd)
    vc = v.to(dm.wd)
    if v.dim() == 1:
        return tau_c * atx(dm, ax(dm, vc)) + gam2_c * vc
    return tau_c * atx_batch(dm, ax_batch(dm, vc)) + gam2_c * vc


# ---------------------------------------------------------------------------
# host quantizers and statistics — copied from vampomi_tpu/ops/operator.py:359-463
# ---------------------------------------------------------------------------


def inv_sd_from_sumsq(sumsq: np.ndarray, n: int, alpha_scale: float) -> np.ndarray:
    """msig = 1/sd^alpha (reference src/data.cpp:270-276) from the centered
    sum of squares, (n-1) denominator; constant markers get msig = 1."""
    sumsq = np.asarray(sumsq, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sd = np.sqrt(sumsq / (n - 1.0))
        return np.where(sumsq != 0.0, 1.0 / np.where(sd == 0, 1.0, sd) ** alpha_scale, 1.0)


def _host_stats(X_raw: np.ndarray, alpha_scale: float):
    """f64 host-side standardization statistics (bit-faithful regardless of
    the on-device compute dtype)."""
    stats = np.asarray(X_raw, dtype=np.float64)
    n = stats.shape[1]
    mave = stats.sum(axis=1) / n
    sumsqr = ((stats - mave[:, None]) ** 2).sum(axis=1)
    return mave, inv_sd_from_sumsq(sumsqr, n, alpha_scale)


def quantize_markers(X_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-marker affine int8 quantization of raw marker rows.

        X ≈ s[:, None] * Xq + z[:, None],   Xq ∈ [-127, 127]

    with s = range/254 and z the range midpoint (f64, host side).  Constant
    markers get s = 1, z = value, Xq = 0 — their A rows are exactly zero
    after standardization.  The affine transform folds exactly into the
    standardization vectors (see build_design).
    """
    X = np.asarray(X_rows, dtype=np.float64)
    mn = X.min(axis=1)
    mx = X.max(axis=1)
    rng = mx - mn
    s = np.where(rng > 0.0, rng / 254.0, 1.0)
    z = 0.5 * (mn + mx)
    Xq = np.clip(
        np.rint((X - z[:, None]) / s[:, None]), -127, 127
    ).astype(np.int8)
    return Xq, s, z


def dequantized_stats(
    Xq: np.ndarray, s: np.ndarray, z: np.ndarray, alpha_scale: float
) -> tuple[np.ndarray, np.ndarray]:
    """(mave, msig) of the DEQUANTIZED values s·Xq + z, computed from the
    int8 codes alone (no f64 re-materialization): standardizing against the
    dequantized statistics makes each A row have exactly zero mean and unit
    sd^alpha for the matrix actually used in the solve."""
    Xq = np.asarray(Xq)
    n = Xq.shape[1]
    qmean = Xq.astype(np.float64).mean(axis=1)
    qsumsq = ((Xq.astype(np.float64) - qmean[:, None]) ** 2).sum(axis=1)
    mave = s * qmean + z
    msig_unit = inv_sd_from_sumsq(qsumsq, n, alpha_scale)  # of Xq itself
    # sd(s·Xq) = s·sd(Xq): fold s^alpha into the inverse sd
    msig = np.where(qsumsq != 0.0, msig_unit / s**alpha_scale, 1.0)
    return mave, msig


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _assemble(X: torch.Tensor, mave, msig, n: int, device) -> DesignMatrix:
    vd = torch.float32 if X.dtype == torch.int8 else X.dtype
    mt = X.shape[0]

    def vec(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=vd)

    return DesignMatrix(
        X=X,
        mave=vec(mave),
        msig=vec(msig),
        mmask=torch.ones(mt, dtype=vd, device=device),
        inv_sqrt_n=torch.tensor(1.0 / np.sqrt(float(n)), dtype=torch.float64,
                                device=device).to(vd),
        n=float(n),
        mt=float(mt),
    )


def build_design(
    X_raw: np.ndarray,
    compute_dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
    alpha_scale: float = 1.0,
) -> DesignMatrix:
    """A DesignMatrix on `device` from raw (Mt, N) marker-major host data.

    f64 / f32: X is stored as is; mave/msig are the f64 host statistics.
    int8: per-marker affine codes (quantize_markers), standardized against
    the statistics of the dequantized values and with the affine map folded
    into mave/msig, exactly as vampomi_tpu/ops/operator.py:489-574 does:
    msig∘(s·Xq + z - mave) == (msig·s)∘(Xq - (mave - z)/s).
    Single device, no padding."""
    X_raw = np.asarray(X_raw)
    n = X_raw.shape[1]
    device = torch.device(device)
    if compute_dtype == torch.int8:
        Xq, qs, qz = quantize_markers(X_raw)
        mave, msig = dequantized_stats(Xq, qs, qz, alpha_scale)
        mave = (mave - qz) / qs
        msig = msig * qs
        X = torch.as_tensor(Xq).to(device)
    elif compute_dtype in (torch.float64, torch.float32):
        mave, msig = _host_stats(X_raw, alpha_scale)
        np_dtype = np.float64 if compute_dtype == torch.float64 else np.float32
        # a copy: the reader may hand out a read-only memory map of the file
        X = torch.from_numpy(np.array(X_raw, dtype=np_dtype)).to(device)
    else:
        raise NotImplementedError(
            f"compute dtype {compute_dtype} is not ported yet (see ROADMAP.md)")
    return _assemble(X.contiguous(), mave, msig, n, device)


def design_from_codes(Xq: torch.Tensor, alpha_scale: float = 1.0) -> DesignMatrix:
    """A DesignMatrix over int8 codes that already live on their device,
    taking the codes themselves as the data (scale 1, zero 0).

    mave/msig are computed on Xq's device in f64, one chunk of marker rows
    at a time — what dequantized_stats computes on the host — so a design
    too large to stage through host memory is built where it lives."""
    if Xq.dtype != torch.int8 or Xq.dim() != 2 or not Xq.is_contiguous():
        raise ValueError("design_from_codes: need a contiguous (M, N) int8 tensor")
    m, n = Xq.shape
    mean = torch.empty(m, dtype=torch.float64, device=Xq.device)
    sumsq = torch.empty(m, dtype=torch.float64, device=Xq.device)
    rows = max(1, min(m, PLAIN_CHUNK_BYTES // (8 * n)))
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        xc = Xq[lo:hi].to(torch.float64)
        mu = xc.sum(dim=1) / n
        mean[lo:hi] = mu
        sumsq[lo:hi] = ((xc - mu[:, None]) ** 2).sum(dim=1)
    sd = torch.sqrt(sumsq / (n - 1.0))
    msig = torch.where(sumsq != 0.0,
                       1.0 / torch.where(sd == 0, 1.0, sd) ** alpha_scale,
                       torch.ones_like(sd))
    return DesignMatrix(
        X=Xq,
        mave=mean.to(torch.float32),
        msig=msig.to(torch.float32),
        mmask=torch.ones(m, dtype=torch.float32, device=Xq.device),
        inv_sqrt_n=torch.tensor(1.0 / np.sqrt(float(n)), dtype=torch.float64,
                                device=Xq.device).to(torch.float32),
        n=float(n),
        mt=float(m),
    )
