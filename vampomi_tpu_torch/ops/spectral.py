"""The Gram-space (Woodbury) LMMSE solver: the Gram matrix K = A A^T, the
per-iteration factor of the shifted dual S = gam2 I + tau K, the exact solve
and the trace closed forms (port of vampomi_tpu/ops/spectral.py:64-272,
407-518).

K is built once per dataset, blocked over markers:

    G  = X^T diag(w^2) X,   t = X^T (w^2 ∘ mu),   s2 = sum_m w_m^2 mu_m^2
    K  = (G - t 1^T - 1 t^T + s2 11^T) / N

so the w^2-scaled copy of X exists one block at a time.  int8 blocks are
upcast to f32, packed-int4 blocks unpacked to their N f32 codes
(spectral.py:89-110), and contracted in f32 with TF32 off — more exact than
the JAX package, which rounds the w^2-weighted side to bf16
(spectral.py:111-133).  This is plain torch.matmul, as JAX leaves it to XLA
outside any Pallas kernel: 2·M·N^2 FLOPs once per dataset.

Per iteration the spectral solver factors S = L L^T and forms W = L^{-1}
(`shift_inverse`), so that S^{-1} b = W^T (W b) and T = tr S^{-1} = ||W||_F^2
make the LMMSE solve and both VAMP traces exact:

    Q^{-1} v        = (v - tau A^T S^{-1} A v) / gam2     [Woodbury]
    A Q^{-1} v      = S^{-1} A v                          [push-through]
    tr Q^{-1}       = T + (Mt - N) / gam2
    tr A^T A Q^{-1} = (N - gam2 T) / tau

The factor and the inverse are cuSOLVER/cuBLAS calls through torch
(`cholesky_ex`, then a triangular solve against the identity); the JAX
package's blocked factor with its explicit-inverse panels (`_factor_diag`,
`_shift_inverse_body`, `_blocked_cholesky`, `default_nb`, spectral.py:275-404)
works around the TPU's row-sequential Cholesky and is not ported.  A factor
that fails (S not positive definite in the work dtype) raises: nothing here
returns NaNs or switches to another solver.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sharding import all_reduce_many
from .operator import PACKED4_DTYPE, DesignMatrix, atx, ax, f64
from .packed4 import unpack_rows


class GramFactor(NamedTuple):
    """The reusable LMMSE state: the Gram matrix K = A A^T (N, N), work
    dtype.  Valid for every (tau, gam2) shift."""

    K: torch.Tensor

    @property
    def n(self) -> int:
        return self.K.shape[0]


def gram(dm: DesignMatrix, block: int = 16384) -> torch.Tensor:
    """K = A A^T as an (N, N) tensor in the operator's work dtype.  Narrow X
    (int8 or packed codes, bf16 values) is upcast to f32 one block of rows
    at a time and multiplied in full f32; the JAX package rounds w·x to
    bf16 there (vampomi_tpu/ops/spectral.py:111-133), so its K differs by
    that rounding.  Sharded over markers, each rank sums its slab's G, t
    and s2 and one all_reduce of the three makes K, the same bits on every
    rank (vampomi_tpu/ops/spectral.py:175-193)."""
    acc = dm.wd
    X = dm.X
    m, n = dm.m_pad, int(dm.n)  # packed X has N/2 byte columns
    w2 = (dm.msig * dm.msig).to(acc)
    u = w2 * dm.mave.to(acc)
    G = torch.zeros((n, n), dtype=acc, device=dm.device)
    t = torch.zeros(n, dtype=acc, device=dm.device)
    block = max(1, min(block, m))
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        Xb = unpack_rows(X[lo:hi], acc) if X.dtype == PACKED4_DTYPE else X[lo:hi].to(acc)
        G += (w2[lo:hi, None] * Xb).T @ Xb
        t += u[lo:hi] @ Xb
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


def shift_cholesky(fac: GramFactor, tau, gam2) -> torch.Tensor:
    """L with L L^T = S = gam2 I + tau K, in the factor's dtype.  Raises when
    the factor fails (the leading minor cuSOLVER or LAPACK reports is not
    positive in the work dtype)."""
    wd, dev = fac.K.dtype, fac.K.device
    S = f64(tau, dev).to(wd) * fac.K
    S.diagonal().add_(f64(gam2, dev).to(wd))
    L, info = torch.linalg.cholesky_ex(S)
    minor = int(info)
    if minor != 0:
        raise RuntimeError(
            f"Cholesky of S = gam2 I + tau K failed at leading minor {minor} of "
            f"{fac.n} (tau={float(tau):.6g}, gam2={float(gam2):.6g}, "
            f"{str(fac.K.dtype).replace('torch.', '')}): S is not positive "
            "definite in the work dtype")
    return L


def _inverse_factor(L: torch.Tensor) -> torch.Tensor:
    """W = L^{-1} by a triangular solve against the identity."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _frobenius2(W: torch.Tensor) -> torch.Tensor:
    """||W||_F^2 accumulated in f64."""
    return torch.linalg.vector_norm(W, dtype=torch.float64) ** 2


def shift_inverse(fac: GramFactor, tau, gam2) -> ShiftInverse:
    """W = L^{-1} and T = ||W||_F^2 for S = gam2 I + tau K = L L^T — what one
    spectral iteration needs from the N x N problem (the JAX package's fused
    blocked pass, spectral.py:237-272, as a factor and a triangular solve)."""
    W = _inverse_factor(shift_cholesky(fac, tau, gam2))
    return ShiftInverse(W=W, T=_frobenius2(W))


def spectral_solve(
    dm: DesignMatrix,
    fac: GramFactor,
    v: torch.Tensor,
    tau,
    gam2,
    av: torch.Tensor | None = None,
    L: torch.Tensor | None = None,
    winv: ShiftInverse | None = None,
):
    """Exact mu = (tau A^T A + gam2 I)^{-1} v via Woodbury.  Returns (mu, q)
    with q = S^{-1} A v = A mu (push-through, no extra pass over X).  Pass
    `av = A v` if it is at hand, and either the inverse factor `winv` or a
    shift Cholesky `L` (a Cholesky solve); with neither, L is factored here."""
    wd = dm.wd
    tau_c = f64(tau, dm.device).to(wd)
    gam2_c = f64(gam2, dm.device).to(wd)
    vc = v.to(wd)
    if av is None:
        av = ax(dm, vc)
    if winv is not None:
        q = winv.solve(av.to(wd))
    else:
        if L is None:
            L = shift_cholesky(fac, tau, gam2)
        q = torch.cholesky_solve(av.to(wd)[:, None], L)[:, 0]
    mu = (vc - tau_c * atx(dm, q)) / gam2_c
    return mu, q


def spectral_traces(fac: GramFactor, mt, tau, gam2, L: torch.Tensor | None = None,
                    winv: ShiftInverse | None = None):
    """Exact (tr Q^{-1}, tr(A^T A Q^{-1})) over the Mt markers, f64, from
    T = tr S^{-1}: the inverse factor's T when `winv` is given, else
    ||L^{-1}||_F^2 of the shift Cholesky `L` (factored here if not given)."""
    if winv is not None:
        T = winv.T
    else:
        if L is None:
            L = shift_cholesky(fac, tau, gam2)
        T = _frobenius2(_inverse_factor(L))
    return _trace_closed_forms(T, fac.n, mt, tau, gam2)


def _trace_closed_forms(T, n, mt, tau, gam2):
    """(tr Q^{-1}, tr(A^T A Q^{-1})) in f64 from T = tr(S^{-1}),
    S = gam2 I + tau K: the zero modes of Q = tau A^T A + gam2 I contribute
    1/gam2 each, counted by (Mt - N)/gam2."""
    dev = T.device if isinstance(T, torch.Tensor) else None
    tau64, gam264, T64 = f64(tau, dev), f64(gam2, dev), f64(T, dev)
    tr_qinv = T64 + (float(mt) - n) / gam264
    tr_ata_qinv = (n - gam264 * T64) / tau64
    return tr_qinv, tr_ata_qinv
