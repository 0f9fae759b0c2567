"""The quantized design's two matvec directions on the tensor cores, with
the vector rounded to bf16: the matrix-unit probe kernels of the TPU tools.

  * `atx_mxu(X, y)`: v = X bf16(y) for (M, N) int8 X → (M,) f32;
    `csrc/atx_mxu.cu`, replacing `atx_mxu` (tools/matvec_floor_probe.py:135-165).
  * `ax_mxu(X, W)`: Z = X^T bf16(W) for (M, N) int8 X and (M, K) W, K <= 8
    → (N, K) f32; `csrc/ax_mxu.cu`, replacing `ax_mxu`
    (tools/matvec_floor_probe.py:168-200, K = 1, which returns (N,)).
  * `ax2_packed4_mxu(Xp, W)`: the same for (M, N/2) packed-int4 X;
    `csrc/ax2_packed4_mxu.cu`, replacing `ax2_i4_pallas`
    (tools/r4_probe.py:139-174, K = 2, which returns Z^T).

The last two are instances of one template, `csrc/mxu_xtw.cuh`.  They
compute what the TPU kernels compute: each code exact in bf16, the vector
rounded to bf16 (nearest even), the products summed in f32 — by `mma.sync`
bf16 products on the tensor cores, whose f32 sums do not round like a chain
of IEEE adds.  They are measurement tools, the tensor-core twins of the
CUDA-core kernels the design operator runs (`atx_int8`, `ax_batch_int8`,
`ax_batch_packed4`), which multiply the f32 vector unrounded.

On a CUDA tensor a wrapper launches its kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain PyTorch version
beside it: the CUDA-core kernel's plain version on the bf16-rounded vector,
codes.to(f32) @ v.to(bfloat16).to(f32) in f32 (never a bf16 matmul, which
would round its output to bf16).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .atx_int8 import atx_int8_plain, check_int8, check_rhs
from .broadcast import ax_batch_int8_plain, ax_batch_packed4_plain, launch_xtw
from .packed4 import check_packed

# the columns one step of atx_mxu's products covers (kCols in atx_mxu.cu):
# its bf16 copy of y is zero-padded to a multiple of this
ATX_MXU_COLS = 64


def bf16_round(v: torch.Tensor) -> torch.Tensor:
    """f32 v rounded to bf16 (nearest even) and back: exact in f32."""
    return v.to(torch.bfloat16).to(torch.float32)


def atx_mxu_plain(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch v = X.float() @ bf16(y) in f32."""
    return atx_int8_plain(X, bf16_round(y))


def ax_mxu_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Z = X.float()^T @ bf16(W) in f32 → (N, K)."""
    return ax_batch_int8_plain(X, bf16_round(W))


def ax2_packed4_mxu_plain(Xp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Z = codes(Xp)^T @ bf16(W) in f32 → (N, K)."""
    return ax_batch_packed4_plain(Xp, bf16_round(W))


def atx_mxu(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v = X @ bf16(y) for (M, N) int8 X and (N,) f32 y, f32 sums → (M,)."""
    check_int8(X, "atx_mxu")
    m, n = X.shape
    if y.dim() != 1:
        raise ValueError(f"atx_mxu: need y (N,), got {tuple(y.shape)}")
    check_rhs(X, y[:, None], n, "atx_mxu")
    if X.device.type == "cpu":
        return atx_mxu_plain(X, y)
    npad = -(-n // ATX_MXU_COLS) * ATX_MXU_COLS
    fn = _build.function("atx_mxu", "atx_mxu_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(X.device):
        yb = torch.empty(npad, dtype=torch.bfloat16, device=X.device)
        out = torch.empty(m, dtype=torch.float32, device=X.device)
        err = fn(X.data_ptr(), y.data_ptr(), yb.data_ptr(), out.data_ptr(), m, n, npad,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"atx_mxu at M={m}, N={n}")
    atx_mxu.launches += 1
    return out


def ax_mxu(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z = X^T @ bf16(W) for (M, N) int8 X and (M, K) f32 W, K <= 8, f32
    sums → (N, K)."""
    check_int8(X, "ax_mxu")
    check_rhs(X, W, X.shape[0], "ax_mxu")
    if X.device.type == "cpu":
        return ax_mxu_plain(X, W)
    out = launch_xtw("ax_mxu", X, W, X.shape[1])
    ax_mxu.launches += 1
    return out


def ax2_packed4_mxu(Xp: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Z = codes(Xp)^T @ bf16(W) for (M, N/2) packed X and (M, K) f32 W,
    K <= 8, f32 sums → (N, K): rows [0, N/2) from the low nibbles, [N/2, N)
    from the high."""
    check_packed(Xp, "ax2_packed4_mxu")
    check_rhs(Xp, W, Xp.shape[0], "ax2_packed4_mxu")
    if Xp.device.type == "cpu":
        return ax2_packed4_mxu_plain(Xp, W)
    out = launch_xtw("ax2_packed4_mxu", Xp, W, 2 * Xp.shape[1])
    ax2_packed4_mxu.launches += 1
    return out


# kernel launches since the last reset (plain runs are not counted)
atx_mxu.launches = 0
ax_mxu.launches = 0
ax2_packed4_mxu.launches = 0
