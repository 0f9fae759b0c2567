"""The Gram matrix K = A A^T and the LMMSE trace closed forms (port of the
part of vampomi_tpu/ops/spectral.py:64-210 that the eigen solver needs).

K is built once per dataset, blocked over markers:

    G  = X^T diag(w^2) X,   t = X^T (w^2 ∘ mu),   s2 = sum_m w_m^2 mu_m^2
    K  = (G - t 1^T - 1 t^T + s2 11^T) / N

so the w^2-scaled copy of X exists one block at a time.  int8 blocks are
upcast to f32 and contracted in f32 with TF32 off — more exact than the JAX
package, which rounds the w^2-weighted side to bf16 (spectral.py:111-133).
This is plain torch.matmul: 2·M·N^2 FLOPs once per dataset.

The per-iteration spectral solver (shift_inverse and its blocked Cholesky,
spectral.py:237-398) is not ported yet: see ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .operator import DesignMatrix, f64


class GramFactor(NamedTuple):
    """The reusable LMMSE state: the Gram matrix K = A A^T (N, N), work
    dtype.  Valid for every (tau, gam2) shift."""

    K: torch.Tensor

    @property
    def n(self) -> int:
        return self.K.shape[0]


def gram(dm: DesignMatrix, block: int = 16384) -> torch.Tensor:
    """K = A A^T as an (N, N) tensor in the operator's work dtype."""
    acc = dm.wd
    X = dm.X
    m, n = X.shape
    w2 = (dm.msig * dm.msig).to(acc)
    u = w2 * dm.mave.to(acc)
    G = torch.zeros((n, n), dtype=acc, device=dm.device)
    t = torch.zeros(n, dtype=acc, device=dm.device)
    block = max(1, min(block, m))
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        Xb = X[lo:hi].to(acc)
        G += (w2[lo:hi, None] * Xb).T @ Xb
        t += u[lo:hi] @ Xb
    s2 = (u * dm.mave.to(acc)).sum()
    inv_n = dm.inv_sqrt_n.to(acc) ** 2
    K = (G - t[:, None] - t[None, :] + s2) * inv_n
    return 0.5 * (K + K.T)  # exact symmetry


def build_spectral(dm: DesignMatrix, block: int = 16384) -> GramFactor:
    """One-time Gram build — M·N^2 FLOPs, amortized over every LMMSE solve."""
    return GramFactor(K=gram(dm, block=block))


def _trace_closed_forms(T, n, mt, tau, gam2):
    """(tr Q^{-1}, tr(A^T A Q^{-1})) in f64 from T = tr(S^{-1}),
    S = gam2 I + tau K: the zero modes of Q = tau A^T A + gam2 I contribute
    1/gam2 each, counted by (Mt - N)/gam2."""
    dev = T.device if isinstance(T, torch.Tensor) else None
    tau64, gam264, T64 = f64(tau, dev), f64(gam2, dev), f64(T, dev)
    tr_qinv = T64 + (float(mt) - n) / gam264
    tr_ata_qinv = (n - gam264 * T64) / tau64
    return tr_qinv, tr_ata_qinv
