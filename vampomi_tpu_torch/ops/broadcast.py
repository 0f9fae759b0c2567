"""The broadcast direction of the quantized designs: Z = X^T W over marker
rows for K <= 8 right-hand sides, the pass behind `ax` and `ax_batch`.

`ax_batch_int8` ((M, N) int8 codes) and `ax_batch_packed4` ((M, N/2) packed
nibbles, ops/packed4.py) wrap two instances of one hand-written CUDA kernel
template, `csrc/xtw.cuh`, built from `csrc/ax_batch_int8.cu` and
`csrc/ax_batch_packed4.cu`.  They replace the TPU Pallas kernels
`ax2_i8_pallas` (tools/r4_probe.py:77-103, K = 2) and `ax_batch_packed4_raw`
(vampomi_tpu/ops/pallas_matvec.py:127-180), computing what those compute in
interpret mode: each code upcast exactly to f32, multiplied by the f32
weight and summed in f32 (on the TPU the weights are rounded to bf16).

The TPU kernels add each tile into one resident output along a sequential
grid; on the card the sum over markers is split over warps, each writing a
partial Z to a workspace (splits, N, K), and a second kernel sums the
partials in a fixed order: no atomics, so the result is bitwise
repeatable.  See the note at the top of `xtw.cuh`.

On a CUDA tensor a wrapper launches its kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain PyTorch version
beside it, which is also what the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import check_int8, check_rhs, chunk_rows
from .packed4 import check_packed, unpack_rows


def _xtw_plain(X: torch.Tensor, W: torch.Tensor, n: int, rows_of) -> torch.Tensor:
    """sum over chunks of marker rows of rows_of(X chunk)^T @ W chunk, in
    f32, where rows_of gives a chunk's (rows, n) f32 codes."""
    m = X.shape[0]
    out = None
    rows = chunk_rows(m, n)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        part = rows_of(X[lo:hi]).T @ W[lo:hi]
        out = part if out is None else out + part
    return out


def ax_batch_int8_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Z = X.float()^T @ W, one chunk of marker rows at a time."""
    return _xtw_plain(X, W, X.shape[1], lambda c: c.to(torch.float32))


def ax_batch_packed4_plain(Xp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Z = codes(Xp)^T @ W, one chunk of marker rows unpacked at
    a time (the chunk budget counts the N unpacked values of a row)."""
    return _xtw_plain(Xp, W, 2 * Xp.shape[1], unpack_rows)


def launch_xtw(lib: str, X: torch.Tensor, W: torch.Tensor, n: int) -> torch.Tensor:
    """Run the broadcast kernel of library `lib` on the card: (N, K) f32.
    The library has the two entry points of `csrc/xtw.cuh`'s signatures,
    `<lib>_splits` and `<lib>_launch`."""
    m, nb = X.shape
    k = W.shape[1]
    splits_fn = _build.function(lib, f"{lib}_splits",
                                [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_longlong)])
    launch = _build.function(lib, f"{lib}_launch",
                             [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    splits = ctypes.c_longlong(0)
    with torch.cuda.device(X.device):
        _build.check_launch(splits_fn(m, nb, k, ctypes.byref(splits)),
                            f"{lib} occupancy query")
        work = torch.empty(splits.value * n * k, dtype=torch.float32, device=X.device)
        out = torch.empty((n, k), dtype=torch.float32, device=X.device)
        err = launch(X.data_ptr(), W.data_ptr(), work.data_ptr(), out.data_ptr(), m, nb, k,
                     splits.value, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"{lib} at M={m}, bytes per row {nb}, K={k}")
    return out


def ax_batch_int8(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z = X^T W for (M, N) int8 codes and (M, K) f32 W, K <= 8, in f32 →
    (N, K)."""
    check_int8(X, "ax_batch_int8")
    check_rhs(X, W, X.shape[0], "ax_batch_int8")
    if X.device.type == "cpu":
        return ax_batch_int8_plain(X, W)
    out = launch_xtw("ax_batch_int8", X, W, X.shape[1])
    ax_batch_int8.launches += 1
    return out


def ax_batch_packed4(Xp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z = codes(Xp)^T W for (M, N/2) packed X and (M, K) f32 W, K <= 8, in
    f32 → (N, K): rows [0, N/2) from the low nibbles, [N/2, N) from the high."""
    check_packed(Xp, "ax_batch_packed4")
    check_rhs(Xp, W, Xp.shape[0], "ax_batch_packed4")
    if Xp.device.type == "cpu":
        return ax_batch_packed4_plain(Xp, W)
    out = launch_xtw("ax_batch_packed4", Xp, W, 2 * Xp.shape[1])
    ax_batch_packed4.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
ax_batch_int8.launches = 0
ax_batch_packed4.launches = 0
