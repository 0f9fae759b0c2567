"""The int8 reduce direction: v = X @ y and Y = X @ Ys for (M, N) int8 X.

`atx_int8` (y (N,) f32) wraps the hand-written CUDA kernel
`csrc/atx_int8.cu`, which replaces the TPU Pallas kernel `_atx_kernel` /
`atx_int8_raw` (vampomi_tpu/ops/pallas_matvec.py:55-86).  `atx_batch_int8`
(Ys (N, K) f32, K <= 8: CG's A^T pass) wraps `csrc/atx_batch_int8.cu`, the
int8 instance of the row-blocked reduce template `csrc/xy.cuh`; the JAX
package computes it as an XLA einsum (vampomi_tpu/ops/operator.py:334-340),
with no Pallas kernel.  Both compute each int8 code upcast exactly to f32,
multiplied by the f32 vector entry and summed in f32 (the vectors are never
rounded to bf16).

Both kernels are bound by the bytes of X: one pass reads M*N bytes at 2*K
FLOPs per byte.  They stream X in 16-byte coalesced loads, keep the vectors
in shared memory (conflict-free by a per-lane rotation) and reduce with warp
shuffles; see the notes at the top of the `.cu` and `.cuh` sources.

`atx_int8_plain` and `atx_batch_int8_plain` are their plain PyTorch
versions: the CPU path, and the comparison each kernel is held to on the
card.  This module also holds the input checks the port's kernel wrappers
share.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Transient budget of the plain version: one marker-row chunk of X upcast to
# f32 at a time, so no f32 copy of the whole of X (40 GiB at the north-star
# shape) ever exists.  Same role as the JAX package's _UNPACK_CHUNK_BYTES.
PLAIN_CHUNK_BYTES = 256 << 20
K_MAX = 8  # right-hand sides a kernel takes (the JAX package's gate)


def chunk_rows(m: int, n: int, budget: int | None = None) -> int:
    """Marker rows per chunk so that an (rows, n) f32 block stays under
    `budget` bytes (PLAIN_CHUNK_BYTES when not given; at least one row)."""
    budget = PLAIN_CHUNK_BYTES if budget is None else budget
    return max(1, min(m, budget // (4 * max(n, 1))))


def atx_batch_int8_plain(X: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = X.float() @ Ys, one chunk of marker rows at a time."""
    m, n = X.shape
    out = torch.empty((m, Ys.shape[1]), dtype=torch.float32, device=X.device)
    rows = chunk_rows(m, n, PLAIN_CHUNK_BYTES)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        torch.matmul(X[lo:hi].to(torch.float32), Ys, out=out[lo:hi])
    return out


def atx_int8_plain(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v = X.float() @ y."""
    return atx_batch_int8_plain(X, y[:, None])[:, 0]


def check_int8(X: torch.Tensor, what: str) -> None:
    if X.dtype != torch.int8:
        raise TypeError(f"{what}: X must be int8, got {X.dtype}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1 or not X.is_contiguous():
        raise ValueError(f"{what}: need a non-empty contiguous (M, N) X, got {tuple(X.shape)}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {X.device}")


def check_rhs(X: torch.Tensor, V: torch.Tensor, rows: int, what: str) -> int:
    """Validate a (rows, K) f32 right-hand side on X's device; returns K."""
    if V.dtype != torch.float32:
        raise TypeError(f"{what}: right-hand sides must be float32, got {V.dtype}")
    if V.dim() != 2 or V.shape[0] != rows:
        raise ValueError(f"{what}: need ({rows}, K) right-hand sides, got {tuple(V.shape)}")
    if not 1 <= V.shape[1] <= K_MAX:
        raise ValueError(f"{what}: K = {V.shape[1]} right-hand sides, the kernel takes "
                         f"1 to {K_MAX}")
    if not V.is_contiguous():
        raise ValueError(f"{what}: right-hand sides must be contiguous")
    if V.device != X.device:
        raise ValueError(f"{what}: X on {X.device} but right-hand sides on {V.device}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {X.device}")
    return V.shape[1]


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


def atx_batch_int8(X: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Y = X @ Ys for (M, N) int8 X and (N, K) f32 Ys, K <= 8, in f32 →
    (M, K).  On a CUDA tensor this launches the kernel on the current stream
    (and raises if it cannot); on a CPU tensor it runs
    `atx_batch_int8_plain`."""
    check_int8(X, "atx_batch_int8")
    m, n = X.shape
    k = check_rhs(X, Ys, n, "atx_batch_int8")
    if X.device.type == "cpu":
        return atx_batch_int8_plain(X, Ys)
    Yt = Ys.T.contiguous()
    out = torch.empty((m, k), dtype=torch.float32, device=X.device)
    fn = _build.function("atx_batch_int8", "atx_batch_int8_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), Yt.data_ptr(), out.data_ptr(), m, n, k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"atx_batch_int8 at M={m}, N={n}, K={k}")
    atx_batch_int8.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
atx_int8.launches = 0
atx_batch_int8.launches = 0
