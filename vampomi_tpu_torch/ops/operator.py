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

Quantized X runs hand-written CUDA kernels on a card and their plain
versions on the CPU:

  * int8 (M, N) codes: `atx` and `atx_batch` through `ops/atx_int8.py`
    (`atx_int8`, `atx_batch_int8`), `ax` / `ax_batch` through
    `ops/broadcast.py ax_batch_int8`;
  * packed int4, (M, N/2) uint8 bytes of two biased nibbles (PACKED4_DTYPE,
    vampomi_tpu/ops/operator.py:41-47): `atx` and `atx_batch` through
    `ops/packed4.py`, `ax` / `ax_batch` through `ops/broadcast.py
    ax_batch_packed4`;
  * bf16 (M, N) values: `atx`, `atx_batch`, `ax` / `ax_batch` through
    `ops/bf16.py` (`atx_bf16`, `atx_batch_bf16`, `ax_batch_bf16`).

Every code or bf16 value is upcast exactly to f32 and multiplied by f32
vectors.  This is MORE exact than the JAX narrow paths, which contract
bf16 x bf16 into f32 and so round w (and, off the Pallas kernels, y) to bf16
(vampomi_tpu/ops/operator.py:186-197): a bf16 torch.matmul would instead
round every partial sum to bf16, so the port does not use one.

Marker sharding (`sharding.py`): a design with a `shard` holds one rank's
contiguous slab of markers.  `ax` and `ax_batch` fold the mave correction
into the slab's partial X^T w and meet the other ranks in ONE all_reduce of
the (N, K) partial a pass (DESIGN.md §1); `atx` and `atx_batch` stay local,
y being replicated.

Each call of the four public products (`ax`, `atx`, `ax_batch`,
`atx_batch`) reads the whole of this rank's X once, on any route (kernel
or plain product): it adds one to `X_PASSES`, which the engines' Tracer
reads around each iteration, and runs in an `xpass` span
(utils/telemetry.py).  The Gibbs sweep reads X a block of rows at a time
through `ax_block` / `atx_block`, which are neither counted nor spanned.
A replayed CUDA graph makes the passes and the kernel launches its capture
counted, and counts them with `count_passes` (engine/graph.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sharding import Shard, all_reduce_
from ..utils.telemetry import span
from .atx_int8 import PLAIN_CHUNK_BYTES, atx_batch_int8, atx_int8
from .bf16 import atx_batch_bf16, atx_bf16, ax_batch_bf16
from .broadcast import ax_batch_int8, ax_batch_packed4
from .packed4 import atx_batch_packed4, atx_packed4, unpack_rows

# Storage dtype of the packed-int4 design: X holds (M, N/2) bytes, each
# carrying two 4-bit affine codes (low nibble = sample j, high nibble =
# sample j + N/2, both biased by +8 into [0, 15]) — half the bytes of int8,
# so M ≈ 2e6 markers at N = 10,240 is 10 GiB (vampomi_tpu/ops/operator.py:41-47).
PACKED4_DTYPE = torch.uint8
QUANTIZED = (torch.int8, PACKED4_DTYPE)
# designs whose vectors work in f32 and whose passes run hand kernels
NARROW = QUANTIZED + (torch.bfloat16,)

X_PASSES = 0  # calls of ax, atx, ax_batch and atx_batch in this process: passes over X
# the hand kernels of the passes, each counting its launches in `.launches`
PASS_KERNELS = (atx_int8, atx_batch_int8, atx_bf16, atx_batch_bf16, ax_batch_bf16,
                ax_batch_int8, ax_batch_packed4, atx_packed4, atx_batch_packed4)


def x_passes() -> int:
    return X_PASSES


def pass_counts() -> list[int]:
    """X_PASSES, then the launches of each of PASS_KERNELS."""
    return [X_PASSES] + [k.launches for k in PASS_KERNELS]


def count_passes(delta: list[int]) -> None:
    """Add `delta`, a difference of two pass_counts(), to the counts."""
    global X_PASSES
    X_PASSES += delta[0]
    for k, d in zip(PASS_KERNELS, delta[1:]):
        k.launches += d


class DesignMatrix(NamedTuple):
    """The raw data and the fused standardization vectors on one device.

    X          : (M, N) raw marker data (f64, f32 or bf16) or int8 codes,
                 or (M, N/2) packed nibbles (PACKED4_DTYPE); M = m_pad is
                 this rank's slab of markers (all Mt of them without a
                 shard).
    mave       : (M,) per-marker mean, work dtype.
    msig       : (M,) per-marker inverse sd (or 1/sd^alpha), work dtype.
    mmask      : (M,) 1.0 for real markers, work dtype (no padding here).
    inv_sqrt_n : () 1/sqrt(N) in the work dtype.
    n, mt      : sample count and GLOBAL marker count, as Python floats:
                 normalise by mt, allocate M-vectors of m_pad.
    shard      : the rank's slab [lo, hi) and process group
                 (sharding.Shard), or None for one process.
    """

    X: torch.Tensor
    mave: torch.Tensor
    msig: torch.Tensor
    mmask: torch.Tensor
    inv_sqrt_n: torch.Tensor
    n: float
    mt: float
    shard: Shard | None = None

    @property
    def m_pad(self) -> int:
        return self.X.shape[0]

    @property
    def wd(self) -> torch.dtype:
        """Work dtype for vector math: f32 for int8, packed or bf16 X, else
        X's own dtype."""
        return torch.float32 if self.X.dtype in NARROW else self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device


def f64(x, device) -> torch.Tensor:
    """x (Python number or tensor) as an f64 tensor on `device` — O(1)
    quantities are f64 everywhere (a bare torch.as_tensor(float) is f32)."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


class Consts:
    """Python numbers as tensors on `device`, each made once: `k(x)` is
    `f64(x, device)` and `k(x, dtype)` that tensor `.to(dtype)`, made at the
    first call for x's bits and dtype and kept; for a tensor x, `k(x,
    dtype)` is `f64(x, device).to(dtype)`.  A Python number made a card's
    tensor is a copy from the host, which synchronises the stream and which
    a CUDA graph cannot capture: an engine keeps one `Consts` a fit, so
    that an iteration copies no number its first one copied."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._made = {}

    def __call__(self, x, dtype: torch.dtype = torch.float64) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return f64(x, self.device).to(dtype)
        key = (float(x).hex(), dtype)  # by its bits: 0.0 and -0.0 are equal keys
        t = self._made.get(key)
        if t is None:
            t = self._made[key] = f64(x, self.device).to(dtype)
        return t


def _xt_w(dm: DesignMatrix, w: torch.Tensor) -> torch.Tensor:
    """X^T w for w (M,) or (M, K) in the work dtype → (N,) or (N, K)
    (quantized X: (M, K) only)."""
    if dm.X.dtype == torch.int8:
        return ax_batch_int8(dm.X, w.contiguous())
    if dm.X.dtype == PACKED4_DTYPE:
        return ax_batch_packed4(dm.X, w.contiguous())
    if dm.X.dtype == torch.bfloat16:
        return ax_batch_bf16(dm.X, w.contiguous())
    return dm.X.T @ w


def _x_y(dm: DesignMatrix, ys: torch.Tensor) -> torch.Tensor:
    """X ys for ys (N, K) in the work dtype → (M, K)."""
    if dm.X.dtype == torch.int8:
        return atx_batch_int8(dm.X, ys.contiguous())
    if dm.X.dtype == PACKED4_DTYPE:
        return atx_batch_packed4(dm.X, ys.contiguous())
    if dm.X.dtype == torch.bfloat16:
        return atx_batch_bf16(dm.X, ys.contiguous())
    return dm.X @ ys


def _xpass() -> span:
    """Count one pass over X and return its `xpass` span."""
    global X_PASSES
    X_PASSES += 1
    return span("xpass")


def ax_block(dm: DesignMatrix, x: torch.Tensor) -> torch.Tensor:
    """`ax` neither counted nor spanned: the Gibbs sweep's product on a
    block of X's rows, which is no pass over X."""
    if dm.X.dtype in NARROW:
        return _ax_batch(dm, x[:, None])[:, 0]
    w = dm.msig * x.to(dm.wd)
    z = _xt_w(dm, w) - torch.dot(dm.mave, w)
    return all_reduce_(z, dm.shard) * dm.inv_sqrt_n


def atx_block(dm: DesignMatrix, y: torch.Tensor) -> torch.Tensor:
    """`atx` neither counted nor spanned: the Gibbs sweep's product on a
    block of X's rows, which is no pass over X."""
    yc = y.to(dm.wd)
    if dm.X.dtype == torch.int8:
        xy = atx_int8(dm.X, yc.contiguous())
    elif dm.X.dtype == PACKED4_DTYPE:
        xy = atx_packed4(dm.X, yc.contiguous())
    elif dm.X.dtype == torch.bfloat16:
        xy = atx_bf16(dm.X, yc.contiguous())
    else:
        xy = dm.X @ yc
    v = dm.msig * (xy - dm.mave * yc.sum())
    return v * dm.inv_sqrt_n


def _ax_batch(dm: DesignMatrix, xs: torch.Tensor) -> torch.Tensor:
    """`ax_batch` neither counted nor spanned."""
    w = dm.msig[:, None] * xs.to(dm.wd)
    z = _xt_w(dm, w) - (dm.mave @ w)[None, :]
    return all_reduce_(z, dm.shard) * dm.inv_sqrt_n


def ax(dm: DesignMatrix, x: torch.Tensor) -> torch.Tensor:
    """z = A x for x (M,) → (N,), in the work dtype (reference data::Ax,
    src/data.cpp:340-373).  Quantized and bf16 X: the K = 1 case of
    ax_batch, so the single vector rides the same kernel
    (vampomi_tpu/ops/operator.py:213-219)."""
    with _xpass():
        return ax_block(dm, x)


def atx(dm: DesignMatrix, y: torch.Tensor) -> torch.Tensor:
    """v = A^T y for y (N,) → (M,) (reference data::ATx, src/data.cpp:315-333).

    int8 X goes through `atx_int8`, packed X through `atx_packed4`, bf16 X
    through `atx_bf16`: the CUDA kernel on a card, its plain version on the
    CPU; all keep y in f32."""
    with _xpass():
        return atx_block(dm, y)


def ax_batch(dm: DesignMatrix, xs: torch.Tensor) -> torch.Tensor:
    """A @ xs for xs (M, K) → (N, K): the K right-hand sides share one pass
    over X (the two-column pass of every eigen iteration, and CG); with a
    shard, one all_reduce of the slab's corrected (N, K) partial."""
    with _xpass():
        return _ax_batch(dm, xs)


def atx_batch(dm: DesignMatrix, ys: torch.Tensor) -> torch.Tensor:
    """A^T @ ys for ys (N, K) → (M, K)."""
    with _xpass():
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
    return mave, inv_sd_from_sumsq(_centered_sumsq(stats, mave), n, alpha_scale)


def _centered_sumsq(X: np.ndarray, mean: np.ndarray) -> np.ndarray:
    """((X - mean[:, None]) ** 2).sum(axis=1) in f64, through one temporary
    updated in place (the same operations, so the same bits)."""
    t = np.subtract(X, mean[:, None], dtype=np.float64)
    np.square(t, out=t)
    return t.sum(axis=1)


def _affine_codes(X: np.ndarray, s: np.ndarray, z: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """clip(rint((X - z) / s), lo, hi) as int8 codes, each row by its own
    s and z, through one f64 temporary updated in place (the same
    operations as the expression, so the same bits, with a third of its
    allocations: the streamed ingest runs this on every chunk)."""
    t = np.subtract(X, z[:, None])
    np.divide(t, s[:, None], out=t)
    np.rint(t, out=t)
    np.clip(t, lo, hi, out=t)
    return t.astype(np.int8)


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
    return _affine_codes(X, s, z, -127, 127), s, z


def quantize_markers4(X_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-marker affine 4-bit quantization: X ≈ s[:, None] * Xq + z[:, None]
    with Xq ∈ [-8, 7], s = range/15, z positioned so the row extremes map to
    the code extremes.  Same folding algebra as quantize_markers (int8) —
    the codes standardize EXACTLY through the mave/msig vectors — but a
    16-level quantizer: per-entry error ≤ range/30, i.e. sd-relative noise
    ~(1/15)/sqrt(12) ≈ 1.9% for full-range markers (vs 0.11% for int8).
    The payoff is bytes: packed 2-per-byte, M=2e6 × N=10240 is 10 GiB.
    """
    X = np.asarray(X_rows, dtype=np.float64)
    mn = X.min(axis=1)
    mx = X.max(axis=1)
    rng = mx - mn
    s = np.where(rng > 0.0, rng / 15.0, 1.0)
    z = np.where(rng > 0.0, mn + 8.0 * s, X[:, 0])  # -8 ↦ mn, +7 ↦ mx
    # constant rows: z = value, s = 1 → codes exactly 0
    return _affine_codes(X, s, z, -8, 7), s, z


def pack_nibbles_host(codes: np.ndarray) -> np.ndarray:
    """(M, N) int4 codes in [-8, 7] → (M, N/2) packed bytes: low nibble =
    sample j, high nibble = sample j + N/2, biased by +8 (host numpy)."""
    m, n = codes.shape
    if n % 2 != 0:
        raise ValueError("packed-int4 designs need an even sample count N")
    b = (codes + 8).astype(np.uint8)
    return b[:, : n // 2] | (b[:, n // 2 :] << 4)


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
    qsumsq = _centered_sumsq(Xq, qmean)
    mave = s * qmean + z
    msig_unit = inv_sd_from_sumsq(qsumsq, n, alpha_scale)  # of Xq itself
    # sd(s·Xq) = s·sd(Xq): fold s^alpha into the inverse sd
    msig = np.where(qsumsq != 0.0, msig_unit / s**alpha_scale, 1.0)
    return mave, msig


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def assemble(X: torch.Tensor, mave, msig, n: int, device,
             shard: Shard | None = None) -> DesignMatrix:
    """The DesignMatrix over stored rows X on `device` with the f64 host
    statistics mave and msig (cast once to the work dtype)."""
    vd = torch.float32 if X.dtype in NARROW else X.dtype
    m = X.shape[0]

    def vec(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=vd)

    return DesignMatrix(
        X=X,
        mave=vec(mave),
        msig=vec(msig),
        mmask=torch.ones(m, dtype=vd, device=device),
        inv_sqrt_n=torch.tensor(1.0 / np.sqrt(float(n)), dtype=torch.float64,
                                device=device).to(vd),
        n=float(n),
        mt=float(m if shard is None else shard.mt),
        shard=shard,
    )


def design_rows(X_rows: np.ndarray, compute_dtype: torch.dtype, alpha_scale: float = 1.0):
    """What a design stores for raw (m, N) marker-major host rows, on the
    host: (X, mave, msig, scale, zero) with X the stored rows as a CPU
    tensor, mave and msig f64 arrays of m, and for a quantized design the
    f64 affine scale and zero of each row (else None).  Every statistic
    and quantizer here is per marker, so the rows of any chunk of a matrix
    give that chunk's rows of the whole matrix's design, bit for bit
    (build_design takes them in one piece, dataset.load_dataset chunk by
    chunk).

    f64 / f32: X is stored as is; mave/msig are the f64 host statistics.
    bf16: the raw values rounded to bf16 (f64 → f32 → bf16, as numpy's
    ml_dtypes cast in the JAX package: the stored bits are JAX's), with
    mave/msig the f64 statistics of the RAW values, not of the rounded ones
    (vampomi_tpu/ops/operator.py:489-574); the work dtype is f32.
    int8 / PACKED4_DTYPE: per-marker affine codes (quantize_markers /
    quantize_markers4, the 4-bit codes then packed two to a byte with
    pack_nibbles_host, which needs an even N), standardized against the
    statistics of the dequantized values and with the affine map folded
    into mave/msig, exactly as vampomi_tpu/ops/operator.py:489-574 does:
    msig∘(s·Xq + z - mave) == (msig·s)∘(Xq - (mave - z)/s)."""
    X_rows = np.asarray(X_rows)
    if compute_dtype in QUANTIZED:
        packed = compute_dtype == PACKED4_DTYPE
        Xq, qs, qz = quantize_markers4(X_rows) if packed else quantize_markers(X_rows)
        mave, msig = dequantized_stats(Xq, qs, qz, alpha_scale)
        X = torch.from_numpy(pack_nibbles_host(Xq) if packed else Xq)
        return X, (mave - qz) / qs, msig * qs, qs, qz
    if compute_dtype in (torch.float64, torch.float32):
        mave, msig = _host_stats(X_rows, alpha_scale)
        np_dtype = np.float64 if compute_dtype == torch.float64 else np.float32
        # a copy: the reader may hand out a read-only memory map of the file
        return torch.from_numpy(np.array(X_rows, dtype=np_dtype)), mave, msig, None, None
    if compute_dtype == torch.bfloat16:
        mave, msig = _host_stats(X_rows, alpha_scale)
        # f64 → f32 → bf16, two roundings, as ml_dtypes casts in the JAX
        # package (one rounding straight to bf16 differs near a midpoint)
        X = torch.from_numpy(np.array(X_rows, dtype=np.float32)).to(torch.bfloat16)
        return X, mave, msig, None, None
    raise NotImplementedError(
        f"compute dtype {compute_dtype} is not a design dtype (float64, float32, "
        "bfloat16, int8, or PACKED4_DTYPE for int4)")


def build_design(
    X_raw: np.ndarray,
    compute_dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
    alpha_scale: float = 1.0,
    quant_out: dict | None = None,
    shard: Shard | None = None,
) -> DesignMatrix:
    """A DesignMatrix on `device` from raw (Mt, N) marker-major host data,
    or with a `shard` from the rank's (hi - lo, N) rows of it: every
    statistic and quantizer is per marker (design_rows, which says what
    each compute dtype stores), so a slab's rows are the global design's
    rows.  `quant_out`, if given, receives {"scale": s, "zero": z} (f64,
    length Mt, or the slab's hi - lo) for a quantized design.  No
    padding."""
    X_raw = np.asarray(X_raw)
    device = torch.device(device)
    X, mave, msig, qs, qz = design_rows(X_raw, compute_dtype, alpha_scale)
    if qs is not None and quant_out is not None:
        quant_out["scale"] = qs
        quant_out["zero"] = qz
    return assemble(X.to(device).contiguous(), mave, msig, X_raw.shape[1], device, shard)


def _device_design(X: torch.Tensor, n: int, rows_f64, alpha_scale: float,
                   shard: Shard | None = None) -> DesignMatrix:
    """A DesignMatrix over X on its device whose mave/msig are computed on
    that device in f64, one chunk of marker rows at a time: rows_f64(lo, hi)
    gives rows [lo, hi) of the data as (hi - lo, n) f64 values (for
    quantized X its codes, taken as the data: scale 1, zero 0) — what
    _host_stats and dequantized_stats compute on the host — so a design
    too large to stage through host memory is built where it lives.  With
    a `shard`, X holds the rank's slab."""
    m = X.shape[0]
    mean = torch.empty(m, dtype=torch.float64, device=X.device)
    sumsq = torch.empty(m, dtype=torch.float64, device=X.device)
    rows = max(1, min(m, PLAIN_CHUNK_BYTES // (8 * n)))
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        xc = rows_f64(lo, hi)
        mu = xc.sum(dim=1) / n
        mean[lo:hi] = mu
        sumsq[lo:hi] = ((xc - mu[:, None]) ** 2).sum(dim=1)
    sd = torch.sqrt(sumsq / (n - 1.0))
    msig = torch.where(sumsq != 0.0,
                       1.0 / torch.where(sd == 0, 1.0, sd) ** alpha_scale,
                       torch.ones_like(sd))
    return DesignMatrix(
        X=X,
        mave=mean.to(torch.float32),
        msig=msig.to(torch.float32),
        mmask=torch.ones(m, dtype=torch.float32, device=X.device),
        inv_sqrt_n=torch.tensor(1.0 / np.sqrt(float(n)), dtype=torch.float64,
                                device=X.device).to(torch.float32),
        n=float(n),
        mt=float(m if shard is None else shard.mt),
        shard=shard,
    )


def design_from_raw_rows(m: int, n: int, rows_of, device, alpha_scale: float = 1.0,
                         shard: Shard | None = None) -> DesignMatrix:
    """A bf16 DesignMatrix of m marker rows built where it lives:
    rows_of(lo, hi) gives the raw values of rows [lo, hi) as an (hi - lo, n)
    tensor on `device`.  Each chunk's f64 statistics are those of its raw
    values, as build_design takes them on the host, and the chunk is stored
    as bf16 (through f32, as build_design rounds), so a design too large for
    host memory (20 GiB of bf16 at the north-star shape) is built on the
    card.  With a `shard`, the m rows are the rank's slab."""
    X = torch.empty((m, n), dtype=torch.bfloat16, device=device)

    def rows_f64(lo, hi):
        raw = rows_of(lo, hi)
        X[lo:hi] = raw.to(torch.float32).to(torch.bfloat16)
        return raw.to(torch.float64)

    return _device_design(X, n, rows_f64, alpha_scale, shard)


def design_from_codes(Xq: torch.Tensor, alpha_scale: float = 1.0,
                      shard: Shard | None = None) -> DesignMatrix:
    """A DesignMatrix over (M, N) int8 codes that already live on their
    device (see _device_design); with a `shard`, the rank's slab of them."""
    if Xq.dtype != torch.int8 or Xq.dim() != 2 or not Xq.is_contiguous():
        raise ValueError("design_from_codes: need a contiguous (M, N) int8 tensor")
    return _device_design(Xq, Xq.shape[1], lambda lo, hi: Xq[lo:hi].to(torch.float64),
                          alpha_scale, shard)


def design_from_packed(Xp: torch.Tensor, alpha_scale: float = 1.0,
                       shard: Shard | None = None) -> DesignMatrix:
    """A DesignMatrix over (M, N/2) packed-int4 bytes that already live on
    their device, N = 2·(N/2) samples (see _device_design): the twin of
    design_from_codes, each chunk of rows unpacked to its N codes."""
    if Xp.dtype != PACKED4_DTYPE or Xp.dim() != 2 or not Xp.is_contiguous():
        raise ValueError("design_from_packed: need a contiguous (M, N/2) uint8 tensor")
    return _device_design(Xp, 2 * Xp.shape[1],
                          lambda lo, hi: unpack_rows(Xp[lo:hi], torch.float64), alpha_scale,
                          shard)
