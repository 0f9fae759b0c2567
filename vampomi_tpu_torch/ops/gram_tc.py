"""The Gram's products G = X^T diag(w^2) X and t = X^T u of a narrow design
(int8 codes, packed-int4 nibbles or bf16 values) on the tensor cores,
without leaving f32.

`gram_tc(X, w2, u)` wraps the hand-written CUDA kernels of
`csrc/gram_tc.cu`.  They replace no Pallas kernel: the JAX package's Gram is
an XLA dot that rounds w^2 x to bf16 once (vampomi_tpu/ops/spectral.py:
111-133).  They compute the port's f32 function instead: every code (and
every bf16 value) is exact in bf16, and the f32 weighted side v = w^2 x,
formed as `w2[:, None] * X` forms it, is split into three bf16 pieces

    h = bf16(v),  m = bf16(v - h),  l = bf16(v - h - m),  h + m + l == v

exactly (`split3`), so G = sum over the pieces of piece^T X: products exact
in f32, sums in f32.  Only the lower block triangle of 128 x 128 tiles is
multiplied; G's upper triangle is the mirror of its lower one
(`mirror_lower`), so G is exactly symmetric.  t = X^T u is summed from the
pre-pass's per-64-marker partials (fused multiply-adds in marker order).
The note at the top of the source gives the design and the bound.

On a CUDA tensor `gram_tc` launches the kernels on the current stream (and
raises if it cannot); on a CPU tensor it runs `gram_tc_plain`, the same
function by torch.matmul: `gram_blocks`, the Gram's route off the tensor
cores (spectral.gram), with G mirrored.  `gram_tc.launches` counts the
kernels' launches (two a block of markers; plain runs are not counted).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed4 import unpack_rows

TILE = 128     # rows and columns of a tile of G (kTile in gram_tc.cu)
STEP_K = 64    # markers of a pipeline stage and of a pre-pass tile (kStepK)
# the pre-pass's kind of each storage dtype: int8 codes, packed nibbles
# (ops/operator.py PACKED4_DTYPE), bf16 values
KINDS = {torch.int8: 0, torch.uint8: 1, torch.bfloat16: 2}


def samples(X: torch.Tensor) -> int:
    """N: the row's samples (a packed byte holds two)."""
    return 2 * X.shape[1] if X.dtype == torch.uint8 else X.shape[1]


def decode(Xb: torch.Tensor) -> torch.Tensor:
    """The (rows, N) f32 values of a block of stored rows, exact."""
    return unpack_rows(Xb) if Xb.dtype == torch.uint8 else Xb.to(torch.float32)


def split3(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h, m, l), bf16, with h + m + l == v exactly for f32 v (nearest-even
    rounding at each step; each residual is an exact f32 subtraction): the
    pre-pass's split in PyTorch, what the tests hold exact."""
    h = v.to(torch.bfloat16)
    r = v - h.to(torch.float32)
    m = r.to(torch.bfloat16)
    return h, m, (r - m.to(torch.float32)).to(torch.bfloat16)


def mirror_lower(G: torch.Tensor) -> torch.Tensor:
    """G's lower triangle and its mirror: exactly symmetric, in place."""
    G.tril_()
    return G.add_(G.tril(-1).mT)


def _check(X: torch.Tensor, w2: torch.Tensor, u: torch.Tensor) -> None:
    if X.dtype not in KINDS:
        raise TypeError(f"gram_tc: X must be int8, packed uint8 or bfloat16, got {X.dtype}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1 or not X.is_contiguous():
        raise ValueError(f"gram_tc: need a contiguous non-empty 2-D X, got {tuple(X.shape)}")
    for name, v in (("w2", w2), ("u", u)):
        if (v.dtype != torch.float32 or v.shape != (X.shape[0],) or v.device != X.device
                or not v.is_contiguous()):
            raise ValueError(f"gram_tc: {name} must be a contiguous f32 ({X.shape[0]},) "
                             f"tensor on {X.device}, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")


def gram_blocks(X: torch.Tensor, w2: torch.Tensor, u: torch.Tensor, n: int,
                block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, t) = (X^T diag(w2) X, X^T u) by torch.matmul in w2's dtype, one
    block of rows upcast (or unpacked) at a time: every X that the kernels
    do not take, and the kernels' plain version."""
    acc = w2.dtype
    m = X.shape[0]
    G = torch.zeros((n, n), dtype=acc, device=X.device)
    t = torch.zeros(n, dtype=acc, device=X.device)
    block = max(1, min(block, m))
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        Xb = unpack_rows(X[lo:hi], acc) if X.dtype == torch.uint8 else X[lo:hi].to(acc)
        G += (w2[lo:hi, None] * Xb).T @ Xb
        t += u[lo:hi] @ Xb
    return G, t


def gram_tc_plain(X: torch.Tensor, w2: torch.Tensor, u: torch.Tensor,
                  block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (G, t): `gram_blocks` in f32 with G's lower triangle
    mirrored.  Its products v x are the kernel's h x + m x + l x up to f32
    rounding; only the order of the f32 sums differs."""
    G, t = gram_blocks(X, w2, u, samples(X), block)
    return mirror_lower(G), t


def gram_tc(X: torch.Tensor, w2: torch.Tensor, u: torch.Tensor,
            block: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, t) = (X^T diag(w2) X, X^T u) for (M, N) int8 or bf16 X or (M, N/2)
    packed X and f32 (M,) w2 and u, in f32, G exactly symmetric; `block`
    rows of X at a time (the scratch of a block: 4 N·block bf16)."""
    _check(X, w2, u)
    if X.device.type == "cpu":
        return gram_tc_plain(X, w2, u, block)
    m, n = X.shape[0], samples(X)
    block = max(1, min(block, m))
    npad = -(-n // TILE) * TILE
    kpad = -(-block // STEP_K) * STEP_K
    row_bytes = X.shape[1] * X.element_size()
    split = _build.function("gram_tc", "gram_tc_split_launch",
                            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 4
                            + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                            + [ctypes.c_void_p] * 2)
    mma = _build.function("gram_tc", "gram_tc_launch",
                          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(X.device):
        # rows past N stay zero: the pre-pass never writes them
        S = torch.zeros((4, npad, kpad), dtype=torch.bfloat16, device=X.device)
        tpart = torch.empty((kpad // STEP_K, n), dtype=torch.float32, device=X.device)
        G = torch.zeros((n, n), dtype=torch.float32, device=X.device)
        t = torch.zeros(n, dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, m, block):
            kb = min(m, lo + block) - lo
            err = split(X.data_ptr() + lo * row_bytes, KINDS[X.dtype], row_bytes, kb,
                        X.shape[1], n, w2.data_ptr() + 4 * lo, u.data_ptr() + 4 * lo,
                        S.data_ptr(), npad, kpad, tpart.data_ptr(), stream)
            _build.check_launch(err, f"gram_tc_split at rows {lo}+{kb}, N={n}")
            err = mma(S.data_ptr(), G.data_ptr(), n, npad, kpad, kb, stream)
            _build.check_launch(err, f"gram_tc at rows {lo}+{kb}, N={n}")
            gram_tc.launches += 2
            t += tpart[:-(-kb // STEP_K)].sum(0)
    return mirror_lower(G), t


gram_tc.launches = 0  # kernel launches since the last reset
