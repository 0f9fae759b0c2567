"""The Gram-space (Woodbury) LMMSE solver: the Gram matrix K = A A^T, the
per-iteration factor of the shifted dual S = gam2 I + tau K, and the exact
N x N step of an iteration, `GramFactor.solve` (port of
vampomi_tpu/ops/spectral.py).

K is built once per dataset, blocked over markers:

    G  = X^T diag(w^2) X,   t = X^T (w^2 ∘ mu),   s2 = sum_m w_m^2 mu_m^2
    K  = (G - t 1^T - 1 t^T + s2 11^T) / N

so the w^2-scaled copy of X exists one block at a time.  Two routes, chosen
by what X is, compute the same f32 function — more exact than the JAX
package, which rounds the w^2-weighted side to bf16 (spectral.py:111-133):

  * a narrow X on a card (int8 codes, packed-int4 nibbles or bf16 values,
    f32 work dtype) runs the hand-written tensor-core kernel of
    ops/gram_tc.py: codes exact in bf16, the f32 weighted side split into
    three bf16 pieces that sum to it exactly, products exact and summed in
    f32, over the lower block triangle only (about half of 3·2·M·N^2 bf16
    FLOPs), G mirrored from it;
  * everything else (any CPU tensor, f32 or f64 X) is plain torch.matmul,
    as JAX leaves it to XLA outside any Pallas kernel: each block upcast to
    the work dtype (packed blocks unpacked to their N codes,
    spectral.py:89-110) and contracted with TF32 off, 2·M·N^2 FLOPs.

Per iteration the spectral solver factors S = L L^T and forms W = L^{-1}
(`shift_inverse`), so that S^{-1} b = W^T (W b) and T = tr S^{-1} = ||W||_F^2
make the LMMSE solve and both VAMP traces exact (`GramFactor.solve` gives
S^{-1} A v and the two traces; the engine's one atx pass makes Q^{-1} v):

    Q^{-1} v        = (v - tau A^T S^{-1} A v) / gam2     [Woodbury]
    A Q^{-1} v      = S^{-1} A v                          [push-through]
    tr Q^{-1}       = T + (Mt - N) / gam2
    tr A^T A Q^{-1} = (N - gam2 T) / tau

`shift_inverse` is the JAX package's fused blocked pass (spectral.py:237-404:
`default_nb`, `_factor_diag`, `_shift_inverse_body`; the block counts and the
leaf size are the port's, see _FACTOR_BASE): default_nb(N) diagonal blocks,
each factored and inverted by a 2x2 recursion down to leaves of at most
_FACTOR_BASE rows (cuSOLVER's potrf and a triangular solve against the
leaf's identity), panels L[r, i] = A[r, i] W_ii^T, the trailing update on the
lower block triangle and W built row group by row group — about 2N^3/3 FLOPs
(N^3/3 of factor, N^3/3 of inverse), nearly all of it f32 GEMMs with TF32
off.  The GEMMs run in eager PyTorch, so every block is a view of S (updated
in place; it ends as L below its diagonal blocks) or of one (N, N) W, and
each of JAX's inner block sums that runs over a contiguous range is one GEMM:
about nb^2 GEMMs a call.  A factor that fails (S not positive definite in the
work dtype) raises, naming the global leading minor: the leaves' infos stay
on the device and are read with one host sync a call; nothing returns NaNs
or switches to another solver.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sharding import all_reduce_many
from .gram_tc import gram_blocks, gram_tc
from .operator import NARROW, DesignMatrix, f64


class GramFactor(NamedTuple):
    """The reusable LMMSE state: the Gram matrix K = A A^T (N, N), work
    dtype.  Valid for every (tau, gam2) shift."""

    K: torch.Tensor

    @property
    def n(self) -> int:
        return self.K.shape[0]

    def solve(self, av: torch.Tensor, tau, gam2, mt):
        """The N x N step of an exact iteration, S = gam2 I + tau K:
        (q = S^{-1} av, tr Q^{-1}, tr A^T A Q^{-1}), the traces f64 over the
        mt markers, through the inverse factor of `shift_inverse` at
        default_nb(N) blocks.  Raises when the factor fails."""
        winv = shift_inverse(self, tau, gam2)
        return (winv.solve(av), *_trace_closed_forms(winv.T, self.n, mt, tau, gam2))


def gram(dm: DesignMatrix, block: int = 16384) -> torch.Tensor:
    """K = A A^T as an (N, N) tensor in the operator's work dtype, f32 for
    narrow X.  On a card, narrow X (int8 or packed codes, bf16 values) goes
    through the tensor-core kernel (ops/gram_tc.py), whose three bf16
    pieces of the f32 w^2·x make its products those of f32 and leave only
    the order of the f32 sums to differ; everything else, and every CPU
    tensor, through `gram_blocks`.  The JAX package rounds w^2·x to bf16
    once there (vampomi_tpu/ops/spectral.py:111-133), so its K differs by
    that rounding.  Sharded over markers, each rank sums its slab's G, t
    and s2 and one all_reduce of the three makes K, the same bits on every
    rank (vampomi_tpu/ops/spectral.py:175-193)."""
    acc = dm.wd
    w2 = (dm.msig * dm.msig).to(acc)
    u = w2 * dm.mave.to(acc)
    if dm.X.is_cuda and dm.X.dtype in NARROW:
        G, t = gram_tc(dm.X, w2, u, block)
    else:
        G, t = gram_blocks(dm.X, w2, u, int(dm.n), block)  # packed X has N/2 byte columns
    s2 = (u * dm.mave.to(acc)).sum()
    G, t, s2 = all_reduce_many([G, t, s2], dm.shard)
    inv_n = dm.inv_sqrt_n.to(acc) ** 2
    K = (G - t[:, None] - t[None, :] + s2) * inv_n
    return 0.5 * (K + K.T)  # exact symmetry


def build_spectral(dm: DesignMatrix, block: int = 16384) -> GramFactor:
    """One-time Gram build — M·N^2 FLOPs, amortized over every LMMSE solve."""
    return GramFactor(K=gram(dm, block=block))


class ShiftInverse(NamedTuple):
    """Per-iteration dense LMMSE state (vampomi_tpu/ops/spectral.py:213-234):

        W = L^{-1}  with  L L^T = S = gam2 I + tau K    (N, N) lower triangular
        T = ||W||_F^2 = tr(S^{-1})                      () f64
    """

    W: torch.Tensor
    T: torch.Tensor

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """S^{-1} b as two triangular matvecs (full f32 products: TF32 is off,
        config.resolve_device)."""
        return self.W.T @ (self.W @ b)


# The leaf size of _factor_diag and the block counts of default_nb are the
# port's own: on an H100 (f32) the JAX package's pair (256; 16 blocks from
# N = 4096, 8 from 2048), tuned on a TPU, was 2-10% slower at N = 10,240 and
# 16,384 and 1.4-3.2x slower at 2,048 and 4,096, where the host's launches of
# many small blocks set the pace.  A leaf is cholesky_ex and a triangular
# solve; _FACTOR_BASE stays at 256 or more, so that an S of N <= 256 is one
# leaf, as in the JAX package.
_FACTOR_BASE = 512


def default_nb(n: int) -> int:
    """Diagonal blocks of shift_inverse's factor: one below N = 2048, where
    the recursion of _factor_diag alone factors S (as the JAX package's
    rule, vampomi_tpu/ops/spectral.py:399-404), 4 from 2048 and 8 from 8192
    (the JAX package: 8 from 2048, 16 from 4096)."""
    return 8 if n >= 8192 else (4 if n >= 2048 else 1)


def _spans(n: int, nb: int) -> list[tuple[int, int]]:
    """The non-empty [lo, hi) row ranges of nb blocks over n, on JAX's
    bounds (np.linspace(0, n, nb + 1).astype(int))."""
    bounds = np.linspace(0, n, max(1, min(nb, n)) + 1).astype(int)
    return [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]


def _shifted(fac: GramFactor, tau, gam2) -> torch.Tensor:
    """S = gam2 I + tau K, a fresh tensor in the factor's dtype."""
    dev = fac.K.device
    S = f64(tau, dev).to(fac.K.dtype) * fac.K
    S.diagonal().add_(f64(gam2, dev).to(fac.K.dtype))
    return S


def _check_factor(infos: list, fac: GramFactor, tau, gam2) -> None:
    """Raise if a leaf's cholesky_ex failed, with the global leading minor
    (the first failing leaf's offset plus its info): one host sync reads
    every leaf's info."""
    for (off, _), info in zip(infos, torch.stack([i for _, i in infos]).tolist()):
        if info > 0:
            raise RuntimeError(
                f"Cholesky of S = gam2 I + tau K failed at leading minor {off + info} of "
                f"{fac.n} (tau={float(tau):.6g}, gam2={float(gam2):.6g}, "
                f"{str(fac.K.dtype).replace('torch.', '')}): S is not positive "
                "definite in the work dtype")


def _inverse_factor(L: torch.Tensor) -> torch.Tensor:
    """W = L^{-1} of a leaf by a triangular solve against its identity."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _frobenius2(W: torch.Tensor) -> torch.Tensor:
    """||W||_F^2 accumulated in f64."""
    return torch.linalg.vector_norm(W, dtype=torch.float64) ** 2


def _trailing_update(S: torch.Tensor, P: torch.Tensor, spans: list) -> None:
    """S[r, s] -= P[r] P[s]^T in place for the blocks r >= s of `spans`, where
    P holds the rows from spans[0]'s start down: one GEMM a column block over
    its rows to the end."""
    top = spans[0][0]
    for lo, hi in spans:
        S[lo:, lo:hi].addmm_(P[lo - top:], P[lo - top:hi - top].T, alpha=-1)


def _factor_diag(A: torch.Tensor, W: torch.Tensor, infos: list, offset: int = 0) -> None:
    """L and W = L^{-1} of an SPD block by the JAX package's 2x2 recursion
    (vampomi_tpu/ops/spectral.py:275-310), in place:

        A = [[A11, A21^T], [A21, A22]],  L11 W11 from A11,
        P = A21 W11^T,  Sc = A22 - P P^T,  L22 W22 from Sc,
        L = [[L11, 0], [P, L22]],  W = [[W11, 0], [-W22 P W11, W22]].

    A becomes L in its lower triangle (the blocks above its diagonal blocks
    keep stale values) and W, zero on entry, receives W.  A leaf (at most
    _FACTOR_BASE rows) is cholesky_ex and a triangular solve against its
    identity; its (offset, info) goes to `infos`, read by _check_factor."""
    b = A.shape[0]
    if b <= _FACTOR_BASE:
        L, info = torch.linalg.cholesky_ex(A)
        infos.append((offset, info))
        W.copy_(_inverse_factor(L))
        A.copy_(L)
        return
    h = min((b // 2 + 127) // 128 * 128, b - 1)  # JAX's lane-aligned split
    W11, W22 = W[:h, :h], W[h:, h:]
    _factor_diag(A[:h, :h], W11, infos, offset)
    P = A[h:, :h] @ W11.T
    A[h:, h:].addmm_(P, P.T, alpha=-1)
    A[h:, :h].copy_(P)
    _factor_diag(A[h:, h:], W22, infos, offset + h)
    W[h:, :h].addmm_(W22, P @ W11, beta=0, alpha=-1)


def _shift_inverse_body(S: torch.Tensor, nb: int, infos: list) -> torch.Tensor:
    """W = L^{-1} of S = L L^T by the JAX package's right-looking factor and
    left-looking inverse (vampomi_tpu/ops/spectral.py:313-369) over nb
    diagonal blocks.  S is overwritten: below its diagonal blocks it ends as
    L.  Step i factors block i (W_ii by _factor_diag), forms the panel
    L[r, i] = A[r, i] W_ii^T of every r > i as one GEMM, updates the lower
    block triangle after it, then fills row group i of W:
    W[i, j] = -W_ii sum_{k=j}^{i-1} L[i, k] W[k, j], one GEMM over k a j."""
    n = S.shape[0]
    spans = _spans(n, nb)
    # column-major, as a leaf's triangular solve returns it: a single leaf
    # (N <= _FACTOR_BASE) gives W, its products and its norm the bits of
    # that solve's own output
    W = torch.zeros_like(S).mT
    for i, (lo, hi) in enumerate(spans):
        Wii = W[lo:hi, lo:hi]
        _factor_diag(S[lo:hi, lo:hi], Wii, infos, lo)
        if hi < n:
            P = S[hi:, lo:hi] @ Wii.T
            _trailing_update(S, P, spans[i + 1:])
            S[hi:, lo:hi].copy_(P)
        for jlo, jhi in spans[:i]:
            W[lo:hi, jlo:jhi].addmm_(Wii, S[lo:hi, jlo:lo] @ W[jlo:lo, jlo:jhi],
                                     beta=0, alpha=-1)
    return W


def shift_inverse(fac: GramFactor, tau, gam2, nb: int | None = None) -> ShiftInverse:
    """W = L^{-1} and T = ||W||_F^2 (f64) for S = gam2 I + tau K = L L^T —
    what one spectral iteration needs from the N x N problem — by the fused
    blocked pass over nb diagonal blocks (default_nb(N) unless given).
    Raises when the factor fails."""
    infos: list = []
    W = _shift_inverse_body(_shifted(fac, tau, gam2), nb or default_nb(fac.n), infos)
    _check_factor(infos, fac, tau, gam2)
    return ShiftInverse(W=W, T=_frobenius2(W))


def _trace_closed_forms(T, n, mt, tau, gam2):
    """(tr Q^{-1}, tr(A^T A Q^{-1})) in f64 from T = tr(S^{-1}),
    S = gam2 I + tau K: the zero modes of Q = tau A^T A + gam2 I contribute
    1/gam2 each, counted by (Mt - N)/gam2."""
    dev = T.device if isinstance(T, torch.Tensor) else None
    tau64, gam264, T64 = f64(tau, dev), f64(gam2, dev), f64(T, dev)
    tr_qinv = T64 + (float(mt) - n) / gam264
    tr_ata_qinv = (n - gam264 * T64) / tau64
    return tr_qinv, tr_ata_qinv
