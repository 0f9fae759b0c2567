"""The int8 A^T y matvec: v = X @ y for (M, N) int8 X and (N,) f32 y.

`atx_int8` is the wrapper of the hand-written CUDA kernel
`csrc/atx_int8.cu`, which replaces the TPU Pallas kernel `_atx_kernel` /
`atx_int8_raw` (vampomi_tpu/ops/pallas_matvec.py:55-86).  It computes what
that kernel computes: each int8 code upcast exactly to f32, multiplied by f32
y and summed in f32 (y is never rounded to bf16).

The kernel is bound by the bytes of X: one pass reads M*N bytes at two FLOPs
per byte.  Its design streams X in 16-byte coalesced loads, one warp per row,
keeps y in shared memory (conflict-free by a per-lane rotation) and reduces
with warp shuffles; see the note at the top of the `.cu` source.

`atx_int8_plain` is its plain PyTorch version: the CPU path, and the
comparison the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Transient budget of the plain version: one marker-row chunk of X upcast to
# f32 at a time, so no f32 copy of the whole of X (40 GiB at the north-star
# shape) ever exists.  Same role as the JAX package's _UNPACK_CHUNK_BYTES.
PLAIN_CHUNK_BYTES = 256 << 20


def chunk_rows(m: int, n: int, budget: int | None = None) -> int:
    """Marker rows per chunk so that an (rows, n) f32 block stays under
    `budget` bytes (PLAIN_CHUNK_BYTES when not given; at least one row)."""
    budget = PLAIN_CHUNK_BYTES if budget is None else budget
    return max(1, min(m, budget // (4 * max(n, 1))))


def atx_int8_plain(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v = X.float() @ y, one chunk of marker rows at a time."""
    m, n = X.shape
    out = torch.empty(m, dtype=torch.float32, device=X.device)
    rows = chunk_rows(m, n, PLAIN_CHUNK_BYTES)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        torch.matmul(X[lo:hi].to(torch.float32), y, out=out[lo:hi])
    return out


def _check(X: torch.Tensor, y: torch.Tensor) -> None:
    if X.dtype != torch.int8:
        raise TypeError(f"atx_int8: X must be int8, got {X.dtype}")
    if y.dtype != torch.float32:
        raise TypeError(f"atx_int8: y must be float32, got {y.dtype}")
    if X.dim() != 2 or y.dim() != 1 or X.shape[1] != y.shape[0]:
        raise ValueError(
            f"atx_int8: need X (M, N) and y (N,), got {tuple(X.shape)} and "
            f"{tuple(y.shape)}")
    if X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"atx_int8: empty X {tuple(X.shape)}")
    if not (X.is_contiguous() and y.is_contiguous()):
        raise ValueError("atx_int8: X and y must be contiguous")
    if X.device != y.device:
        raise ValueError(
            f"atx_int8: X on {X.device} but y on {y.device}")


def atx_int8(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v = X @ y in f32.  On a CUDA tensor this launches the kernel on the
    current stream (and raises if it cannot); on a CPU tensor it runs
    `atx_int8_plain`."""
    _check(X, y)
    if X.device.type == "cpu":
        return atx_int8_plain(X, y)
    if X.device.type != "cuda":
        raise ValueError(f"atx_int8: unsupported device {X.device}")
    m, n = X.shape
    out = torch.empty(m, dtype=torch.float32, device=X.device)
    fn = _build.function("atx_int8", "atx_int8_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(), m, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"atx_int8 at M={m}, N={n}")
    atx_int8.launches += 1
    return out


atx_int8.launches = 0  # kernel launches since the last reset (plain ones not counted)
