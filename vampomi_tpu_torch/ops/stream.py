"""The card's HBM read floor: every byte of an int8 (M, N) X summed as int32.

`stream_sum` ((1, 1) int32, the sum of all bytes with int32 wraparound) and
`stream_rowsum` ((M, 1) int32, one sum per row: the write pattern of the atx
matvec) wrap the hand-written CUDA kernels of `csrc/stream.cu`, which
replace the TPU Pallas probe kernels `stream_sum` and `stream_rowsum`
(tools/matvec_floor_probe.py:83-109, 112-132).  They read X once and do the
least compute that cannot be elided, so their time is the floor no matvec
over the same bytes can beat.

One difference from the TPU kernels: those run a grid of M // tm steps and
so drop the last M mod tm rows; these sum every row (the two agree when tm
divides M).

On a CUDA tensor a wrapper launches its kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain PyTorch version
beside it: int64 chunk sums, wrapped to int32 explicitly.  Integer sums
modulo 2^32 do not depend on their order, so kernel and plain agree
bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import check_int8, chunk_rows


def _wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums modulo 2^32 as int32 (two's complement)."""
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)


def _rows(m: int, n: int) -> int:
    # int64 partial sums: budget 8 bytes a value where chunk_rows counts 4
    return chunk_rows(m, 2 * n)


def stream_sum_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sum of every byte of X, int32 wraparound → (1, 1)."""
    m, n = X.shape
    total = torch.zeros((), dtype=torch.int64, device=X.device)
    rows = _rows(m, n)
    for lo in range(0, m, rows):
        total += X[lo:lo + rows].sum(dtype=torch.int64)
    return _wrap_int32(total).reshape(1, 1)


def stream_rowsum_plain(X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-row sums of X, int32 wraparound → (M, 1)."""
    m, n = X.shape
    out = torch.empty((m, 1), dtype=torch.int32, device=X.device)
    rows = _rows(m, n)
    for lo in range(0, m, rows):
        out[lo:lo + rows, 0] = _wrap_int32(X[lo:lo + rows].sum(dim=1, dtype=torch.int64))
    return out


def stream_sum(X: torch.Tensor) -> torch.Tensor:
    """The int32 (wrapping) sum of every byte of int8 X → (1, 1) int32."""
    check_int8(X, "stream_sum")
    if X.device.type == "cpu":
        return stream_sum_plain(X)
    m, n = X.shape
    fn = _build.function("stream", "stream_sum_launch",
                         [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(X.device):
        out = torch.zeros((1, 1), dtype=torch.int32, device=X.device)
        err = fn(X.data_ptr(), out.data_ptr(), m, n, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"stream_sum at M={m}, N={n}")
    stream_sum.launches += 1
    return out


def stream_rowsum(X: torch.Tensor) -> torch.Tensor:
    """The int32 sum of each row of int8 X → (M, 1) int32."""
    check_int8(X, "stream_rowsum")
    if X.device.type == "cpu":
        return stream_rowsum_plain(X)
    m, n = X.shape
    fn = _build.function("stream", "stream_rowsum_launch",
                         [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    out = torch.empty((m, 1), dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), out.data_ptr(), m, n, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"stream_rowsum at M={m}, N={n}")
    stream_rowsum.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
stream_sum.launches = 0
stream_rowsum.launches = 0
