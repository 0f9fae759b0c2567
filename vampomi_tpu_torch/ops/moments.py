"""Per-row moments of the quantized design's codes: Σ q and Σ q² of each
marker row, as int64, for the LOO association test (modes/association.py).

`row_moments_int8` ((M, N) int8 codes) and `row_moments_packed4` ((M, N/2)
packed nibbles, both counted) wrap the hand-written CUDA kernel
`csrc/row_moments.cu`.  It replaces the reductions of the JAX package's
`_loo_stats` (vampomi_tpu/modes/association.py:78-81, 98-100), which XLA
fuses into its read of X: on the card a torch reduction of the int8 X alone
runs at a tenth of the memory rate (PERF.md §6), and the squares would need
an upcast copy of X.  The kernel reads X once, bound by its bytes.

Both return an (M, 2) int64 tensor: column 0 the sums, column 1 the sums of
squares.  They are exact integers at any row length, so kernel and plain
version (int64 chunk sums) agree bitwise.

On a CUDA tensor a wrapper launches its kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import check_int8, chunk_rows
from .packed4 import check_packed, unpack_rows

def _moments_plain(X: torch.Tensor, n: int, codes64) -> torch.Tensor:
    """(M, 2) int64 [Σ q, Σ q²] per row, from int64 codes of one chunk of rows
    at a time (codes64 gives a chunk's (rows, n) int64 codes)."""
    m = X.shape[0]
    out = torch.empty((m, 2), dtype=torch.int64, device=X.device)
    rows = chunk_rows(m, 2 * n)  # int64 codes: 8 bytes a value where chunk_rows counts 4
    for lo in range(0, m, rows):
        q = codes64(X[lo:lo + rows])
        out[lo:lo + rows, 0] = q.sum(dim=1)
        out[lo:lo + rows, 1] = (q * q).sum(dim=1)
    return out


def row_moments_int8_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-row [Σ q, Σ q²] of int8 X → (M, 2) int64."""
    return _moments_plain(X, X.shape[1], lambda c: c.to(torch.int64))


def row_moments_packed4_plain(Xp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-row [Σ q, Σ q²] over both nibbles' codes of packed
    (M, N/2) X → (M, 2) int64."""
    return _moments_plain(Xp, 2 * Xp.shape[1], lambda c: unpack_rows(c, torch.int64))


def _launch(lib: str, X: torch.Tensor) -> torch.Tensor:
    m, nb = X.shape
    fn = _build.function("row_moments", f"{lib}_launch",
                         [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    out = torch.empty((m, 2), dtype=torch.int64, device=X.device)
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), out.data_ptr(), m, nb, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"{lib} at M={m}, bytes per row {nb}")
    return out


def row_moments_int8(X: torch.Tensor) -> torch.Tensor:
    """Per-row [Σ q, Σ q²] of (M, N) int8 codes → (M, 2) int64."""
    check_int8(X, "row_moments_int8")
    if X.device.type == "cpu":
        return row_moments_int8_plain(X)
    out = _launch("row_moments_int8", X)
    row_moments_int8.launches += 1
    return out


def row_moments_packed4(Xp: torch.Tensor) -> torch.Tensor:
    """Per-row [Σ q, Σ q²] over the N = 2·(N/2) codes of (M, N/2) packed
    bytes → (M, 2) int64."""
    check_packed(Xp, "row_moments_packed4")
    if Xp.device.type == "cpu":
        return row_moments_packed4_plain(Xp)
    out = _launch("row_moments_packed4", Xp)
    row_moments_packed4.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
row_moments_int8.launches = 0
row_moments_packed4.launches = 0
