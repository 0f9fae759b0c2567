"""The packed-int4 design's bytes and its reduce direction Y = X Ys.

A packed design holds (M, N/2) uint8 bytes, each carrying two 4-bit affine
codes biased by +8: the low nibble is the code of sample j, the high nibble
the code of sample j + N/2 (ops/operator.py pack_nibbles_host, as in
vampomi_tpu/ops/operator.py:41-47).

`atx_packed4` (v = X y) and `atx_batch_packed4` (Y = X Ys, K <= 8) wrap the
hand-written CUDA kernels `csrc/atx_packed4.cu` and
`csrc/atx_batch_packed4.cu` (the P = 2 instances of the row-blocked reduce
template `csrc/xy.cuh`, whose int8 instance is `atx_batch_int8`), which
replace the TPU Pallas kernels `atx_packed4_raw` and
`atx_batch_packed4_raw` (vampomi_tpu/ops/pallas_matvec.py:89-124,
183-238).  They compute what those compute in interpret mode: each code
upcast exactly to f32, multiplied by the f32 entry and summed in f32 (the
TPU's batch kernel rounds Ys to bf16; the port does not).  Bound by the bytes
of X; see the note at the top of `xy.cuh`.

On a CUDA tensor a wrapper launches its kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain PyTorch version
beside it, which is also what the kernel is held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import check_rhs, chunk_rows


def unpack_nibbles(Xp: torch.Tensor, dtype: torch.dtype = torch.float32):
    """(lo, hi) code halves of packed (m, N/2) bytes as `dtype` values in
    [-8, 7]: lo covers samples [0, N/2), hi covers [N/2, N).  4-bit codes are
    exact in every float dtype and in int8."""
    p = Xp.to(torch.int16)
    return ((p & 15) - 8).to(dtype), ((p >> 4) - 8).to(dtype)


def unpack_rows(Xp: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (m, N) codes of packed (m, N/2) bytes, samples in order."""
    return torch.cat(unpack_nibbles(Xp, dtype), dim=1)


def atx_batch_packed4_plain(Xp: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = codes(Xp) @ Ys in f32, one chunk of marker rows
    unpacked at a time (the chunk budget counts the N unpacked values of a
    row, not its N/2 bytes)."""
    m, n2 = Xp.shape
    out = torch.empty((m, Ys.shape[1]), dtype=torch.float32, device=Xp.device)
    rows = chunk_rows(m, 2 * n2)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        torch.matmul(unpack_rows(Xp[lo:hi]), Ys, out=out[lo:hi])
    return out


def atx_packed4_plain(Xp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v = codes(Xp) @ y in f32."""
    return atx_batch_packed4_plain(Xp, y[:, None])[:, 0]


def check_packed(Xp: torch.Tensor, what: str) -> None:
    if Xp.dtype != torch.uint8:
        raise TypeError(f"{what}: X must be uint8 packed nibbles, got {Xp.dtype}")
    if Xp.dim() != 2 or Xp.shape[0] < 1 or Xp.shape[1] < 1:
        raise ValueError(f"{what}: need a non-empty (M, N/2) X, got {tuple(Xp.shape)}")
    if not Xp.is_contiguous():
        raise ValueError(f"{what}: X must be contiguous")


def atx_batch_packed4(Xp: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """Y = codes(Xp) @ Ys for (M, N/2) packed X and (N, K) f32 Ys, K <= 8,
    in f32 → (M, K)."""
    check_packed(Xp, "atx_batch_packed4")
    m, n2 = Xp.shape
    k = check_rhs(Xp, Ys, 2 * n2, "atx_batch_packed4")
    if Xp.device.type == "cpu":
        return atx_batch_packed4_plain(Xp, Ys)
    Yt = Ys.T.contiguous()
    out = torch.empty((m, k), dtype=torch.float32, device=Xp.device)
    fn = _build.function("atx_batch_packed4", "atx_batch_packed4_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(Xp.device):
        err = fn(Xp.data_ptr(), Yt.data_ptr(), out.data_ptr(), m, n2, k,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"atx_batch_packed4 at M={m}, N/2={n2}, K={k}")
    atx_batch_packed4.launches += 1
    return out


def atx_packed4(Xp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v = codes(Xp) @ y for (M, N/2) packed X and (N,) f32 y, in f32 → (M,)."""
    check_packed(Xp, "atx_packed4")
    m, n2 = Xp.shape
    if y.dim() != 1:
        raise ValueError(f"atx_packed4: need y (N,), got {tuple(y.shape)}")
    check_rhs(Xp, y[:, None], 2 * n2, "atx_packed4")
    if Xp.device.type == "cpu":
        return atx_packed4_plain(Xp, y)
    out = torch.empty(m, dtype=torch.float32, device=Xp.device)
    fn = _build.function("atx_packed4", "atx_packed4_launch",
                         [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                         + [ctypes.c_void_p])
    with torch.cuda.device(Xp.device):
        err = fn(Xp.data_ptr(), y.data_ptr(), out.data_ptr(), m, n2,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"atx_packed4 at M={m}, N/2={n2}")
    atx_packed4.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
atx_packed4.launches = 0
atx_batch_packed4.launches = 0
