"""The bf16 design's two passes over X, for (M, N) bfloat16 X.

`atx_bf16` (v = X y), `atx_batch_bf16` (Y = X Ys, K <= 8: CG's A^T pass)
and `ax_batch_bf16` (Z = X^T W, K <= 8: `ax` and the engine's two-column
`ax_batch`) wrap three hand-written CUDA kernels: `csrc/atx_bf16.cu` and
`csrc/atx_batch_bf16.cu`, the bf16 instances of the row-blocked reduce
template `csrc/xy.cuh`, and `csrc/ax_batch_bf16.cu`, the bf16 instance of
the broadcast template `csrc/xtw.cuh`.  The JAX package computes these
passes as XLA einsums (vampomi_tpu/ops/operator.py:186-197, 261-267,
334-340), with no Pallas kernel, and rounds the f32 vector to bf16 for the
TPU's matrix unit (`w.astype(dm.X.dtype)`).  Here each bf16 element is
widened to f32 exactly (its bits shifted left 16), multiplied by the f32
vector entry and summed in f32: the vector is never rounded, so the port is
more exact than the JAX package, as it is for int8.  A library call does
not serve: a bf16 torch.matmul rounds its output to bf16, and an f32 copy
of X would take 40 GiB at the north-star shape.

Bound: bytes of X, two a element (21.47 GB at 1,048,576 x 10,240, 6.41 ms at
3.35 TB/s), at 2*K FLOPs an element.

`*_plain` are their plain PyTorch versions in f32, one chunk of marker rows
upcast at a time (no f32 copy of the whole of X exists): the CPU path, and
what each kernel is held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import check_rhs, chunk_rows
from .broadcast import _xtw_plain, launch_xtw


def atx_batch_bf16_plain(X: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = X.float() @ Ys, one chunk of marker rows at a time."""
    m, n = X.shape
    out = torch.empty((m, Ys.shape[1]), dtype=torch.float32, device=X.device)
    rows = chunk_rows(m, n)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        torch.matmul(X[lo:hi].to(torch.float32), Ys, out=out[lo:hi])
    return out


def atx_bf16_plain(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v = X.float() @ y."""
    return atx_batch_bf16_plain(X, y[:, None])[:, 0]


def ax_batch_bf16_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Z = X.float()^T @ W, one chunk of marker rows at a time."""
    return _xtw_plain(X, W, X.shape[1], lambda c: c.to(torch.float32))


def check_bf16(X: torch.Tensor, what: str) -> None:
    if X.dtype != torch.bfloat16:
        raise TypeError(f"{what}: X must be bfloat16, got {X.dtype}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1 or not X.is_contiguous():
        raise ValueError(f"{what}: need a non-empty contiguous (M, N) X, got {tuple(X.shape)}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {X.device}")


def _launch_xy(name: str, X: torch.Tensor, Yt: torch.Tensor, k: int | None) -> torch.Tensor:
    """Run the reduce kernel of library `name` on the card: (M,) for the
    one-vector entry point (k None), else (M, k)."""
    m, n = X.shape
    out = torch.empty((m,) if k is None else (m, k), dtype=torch.float32, device=X.device)
    args = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    args += [ctypes.c_void_p] if k is None else [ctypes.c_int, ctypes.c_void_p]
    fn = _build.function(name, f"{name}_launch", args)
    rest = () if k is None else (k,)
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), Yt.data_ptr(), out.data_ptr(), m, n, *rest,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"{name} at M={m}, N={n}" + ("" if k is None else f", K={k}"))
    return out


def atx_bf16(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v = X @ y for (M, N) bf16 X and (N,) f32 y, in f32.  On a CUDA tensor
    this launches the kernel on the current stream (and raises if it
    cannot); on a CPU tensor it runs `atx_bf16_plain`."""
    check_bf16(X, "atx_bf16")
    if y.dim() != 1:
        raise ValueError(f"atx_bf16: y must be (N,), got {tuple(y.shape)}")
    check_rhs(X, y[:, None], X.shape[1], "atx_bf16")
    if X.device.type == "cpu":
        return atx_bf16_plain(X, y)
    out = _launch_xy("atx_bf16", X, y, None)
    atx_bf16.launches += 1
    return out


def atx_batch_bf16(X: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Y = X @ Ys for (M, N) bf16 X and (N, K) f32 Ys, K <= 8, in f32 →
    (M, K); the kernel on a CUDA tensor, `atx_batch_bf16_plain` on a CPU
    one."""
    check_bf16(X, "atx_batch_bf16")
    k = check_rhs(X, Ys, X.shape[1], "atx_batch_bf16")
    if X.device.type == "cpu":
        return atx_batch_bf16_plain(X, Ys)
    out = _launch_xy("atx_batch_bf16", X, Ys.T.contiguous(), k)
    atx_batch_bf16.launches += 1
    return out


def ax_batch_bf16(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z = X^T W for (M, N) bf16 X and (M, K) f32 W, K <= 8, in f32 →
    (N, K); the kernel on a CUDA tensor, `ax_batch_bf16_plain` on a CPU
    one."""
    check_bf16(X, "ax_batch_bf16")
    check_rhs(X, W, X.shape[0], "ax_batch_bf16")
    if X.device.type == "cpu":
        return ax_batch_bf16_plain(X, W)
    out = launch_xtw("ax_batch_bf16", X, W, X.shape[1])
    ax_batch_bf16.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
atx_bf16.launches = 0
atx_batch_bf16.launches = 0
ax_batch_bf16.launches = 0
