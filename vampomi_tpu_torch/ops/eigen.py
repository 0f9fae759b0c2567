"""Eigen-LMMSE: once-per-dataset eigendecomposition of the Gram matrix
(port of vampomi_tpu/ops/eigen.py:84-107, 935-980).

K = A A^T is fixed for the whole run; only the shift pair (tau, gam2) of the
dual matrix S = gam2 I + tau K moves between iterations.  Diagonalizing K
once,

    K = U diag(lam) U^T,

makes every per-iteration dense quantity O(N^2) or closed-form:

    S^{-1} b   = U ((gam2 + tau*lam)^{-1} ∘ (U^T b))      [2 matvecs]
    tr(S^{-1}) = sum_i 1/(gam2 + tau*lam_i)               [exact, f64]

The build is `torch.linalg.eigh` of K in f64, as the JAX package's own
small-N host leaf does (eigen.py:565-572).  The JAX package's sign-function
divide-and-conquer eigensolver (eigen.py:121-797) exists because XLA's TPU eigh
is unusable; on the card cuSOLVER's eigh serves, so it is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .operator import DesignMatrix, atx, ax, f64
from .spectral import GramFactor, _trace_closed_forms


class EigenFactor(NamedTuple):
    """The reusable eigen-LMMSE state.

    U   : (N, N) orthonormal eigenvectors of K (columns, ascending lam), in
          the work dtype.
    lam : (N,) f64 Rayleigh eigenvalues diag(U^T K U) of the U actually
          used, so the per-iteration traces are exact closed forms.
    """

    U: torch.Tensor
    lam: torch.Tensor

    @property
    def n(self) -> int:
        return self.U.shape[0]


def build_eigen(fac: GramFactor) -> tuple[EigenFactor, dict]:
    """Diagonalize K = fac.K.  Returns (EigenFactor, diagnostics) with
    diagnostics = {"resid": ||K U - U lam||_F / ||K||_F,
    "ortho": max |U^T U - I|}, both measured on U in the work dtype
    against K in f64."""
    wd = fac.K.dtype
    K64 = fac.K.to(torch.float64)
    K64 = 0.5 * (K64 + K64.T)
    _, V = torch.linalg.eigh(K64)
    U = V.to(wd)
    U64 = U.to(torch.float64)
    KU = K64 @ U64
    lam = (U64 * KU).sum(dim=0)  # Rayleigh values diag(U^T K U)
    resid = torch.linalg.norm(KU - U64 * lam[None, :]) / torch.linalg.norm(K64)
    G = U64.T @ U64
    ortho = (G - torch.eye(fac.n, dtype=torch.float64, device=G.device)).abs().max()
    return EigenFactor(U=U, lam=lam), {"resid": float(resid), "ortho": float(ortho)}


def eigen_weights(ef: EigenFactor, tau, gam2):
    """d_i = 1/(gam2 + tau lam_i) in f64, plus T = sum d (= tr S^{-1})."""
    tau64 = f64(tau, ef.lam.device)
    gam264 = f64(gam2, ef.lam.device)
    d = 1.0 / (gam264 + tau64 * ef.lam)
    return d, d.sum()


def eigen_solve(
    dm: DesignMatrix,
    ef: EigenFactor,
    v: torch.Tensor,
    tau,
    gam2,
    av: torch.Tensor | None = None,
):
    """Exact mu = (tau A^T A + gam2 I)^{-1} v via the eigenbasis (Woodbury
    and push-through identities).  Returns (mu, q) with q = S^{-1} A v = A mu."""
    wd = dm.wd
    tau_c = f64(tau, dm.device).to(wd)
    gam2_c = f64(gam2, dm.device).to(wd)
    vc = v.to(wd)
    if av is None:
        av = ax(dm, vc)
    d, _ = eigen_weights(ef, tau, gam2)
    t = ef.U.T @ av.to(wd)
    q = ef.U @ (d.to(wd) * t)
    mu = (vc - tau_c * atx(dm, q)) / gam2_c
    return mu, q


def eigen_traces(ef: EigenFactor, mt, tau, gam2):
    """Exact (tr Q^{-1}, tr(A^T A Q^{-1})) over the Mt markers, f64."""
    _, T = eigen_weights(ef, tau, gam2)
    return _trace_closed_forms(T, ef.n, mt, tau, gam2)
