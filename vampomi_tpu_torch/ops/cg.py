"""Jacobi-preconditioned conjugate-gradient solver for the LMMSE system

    Q mu = v,   Q = tau · A^T A + gam2 · I

(port of vampomi_tpu/ops/cg.py:39-173).  Mirrors the reference
`vamp::precondCG_solver` (src/vamp.cpp:664-757): a scalar Jacobi
preconditioner diag = tau (N-1)/N + gam2, the same update order, and the
`denoiser == 0` early exit when gam2 ⟨v, mu⟩ stabilizes to rel-err 1e-8.

Multi-RHS: K right-hand sides are solved at once with per-column alpha/beta
and per-column stopping, so the main LMMSE solve and the Onsager probe solve
share every pass over X.  A Python loop replaces lax.while_loop: its
condition reads the device's `active` flags, one small synchronisation per
CG step.  (M, K) vector math runs in the operator's work dtype; the scalar
convergence bookkeeping is f64.

Sharded over markers (`dm.shard`), every inner product over M is a local
column sum and an all_reduce: one for the start (⟨v, v⟩ with ⟨r, z⟩) and
two a step (⟨d, p⟩; then ⟨v, mu⟩, ⟨r, z⟩ and ⟨r, r⟩ of the updated
residual together), beside the operator's one a pass.  The values reduced
are the same the one-process loop reduces, so `active` is the same on every
rank and the loop takes the same branch there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sharding import all_reduce_, all_reduce_many
from .operator import DesignMatrix, f64, normal_eq_mult

_ONSAGER_REL_TOL = 1e-8  # reference: src/vamp.cpp:718


class CGResult(NamedTuple):
    mu: torch.Tensor        # (M, K) solution iterates
    iters: int              # CG iterations executed
    rel_err: torch.Tensor   # (K,) final ||r|| / ||v|| per column (f64)


def cg_solve(
    dm: DesignMatrix,
    v: torch.Tensor,
    mu0: torch.Tensor,
    tau,
    gam2,
    *,
    max_iter: int,
    tol: float,
    onsager_cols: torch.Tensor | None = None,
    debug: bool = False,
) -> CGResult:
    """Solve Q mu = v column-wise for v of shape (M, K).

    onsager_cols: optional (K,) bool — columns using the denoiser==0 early
    exit on gam2·⟨v, mu⟩ stabilization in addition to the residual test.
    debug: print the reference's per-CG-iteration residuals (--verbosity 1;
    src/vamp.cpp:723-724, 747-748).
    """
    wd = dm.wd
    dev = dm.device
    v = (v if v.dim() == 2 else v[:, None]).to(wd)
    mu0 = (mu0 if mu0.dim() == 2 else mu0[:, None]).to(wd)
    K = v.shape[1]
    if onsager_cols is None:
        onsager_cols = torch.zeros(K, dtype=torch.bool, device=dev)
    onsager_cols = onsager_cols.to(dev)

    tau64 = f64(tau, dev)
    gam264 = f64(gam2, dev)
    gam2_c = gam264.to(wd)
    diag = (tau64 * (dm.n - 1.0) / dm.n + gam264).to(wd)  # scalar precond
    inv_diag = 1.0 / diag

    def colsum(a, b):  # per-column inner products ⟨a_k, b_k⟩ in work dtype, local
        return (a * b).sum(dim=0)

    r = v - normal_eq_mult(dm, mu0, tau64, gam264)
    z = r * inv_diag
    p = z
    vv, rz = all_reduce_many([colsum(v, v), colsum(r, z)], dm.shard)
    norm_v = torch.sqrt(vv).to(torch.float64)
    safe_norm_v = torch.where(norm_v == 0.0, 1.0, norm_v)
    mu = mu0
    prev_ons = torch.zeros(K, dtype=torch.float64, device=dev)
    active = torch.ones(K, dtype=torch.bool, device=dev)
    rel_err = torch.full((K,), float("inf"), dtype=torch.float64, device=dev)

    i = 0
    while i < max_iter and bool(active.any()):
        d = normal_eq_mult(dm, p, tau64, gam264)
        dp = all_reduce_(colsum(d, p), dm.shard)
        alpha = rz / torch.where(dp == 0.0, torch.ones_like(dp), dp)
        alpha = torch.where(active, alpha, torch.zeros_like(alpha)).to(wd)

        mu = mu + alpha[None, :] * p
        # the residual's update for every column; the columns that stop
        # below keep their r and z.  A column's sums read that column alone,
        # so those of the columns that go on are the ones of the update.
        r_next = r - alpha[None, :] * d
        z_next = r_next * inv_diag
        vmu, rz_new, rr = all_reduce_many(
            [colsum(v, mu), colsum(r_next, z_next), colsum(r_next, r_next)], dm.shard)

        # denoiser == 0 early exit: running Onsager estimate stabilized
        # (scalar bookkeeping in f64 so the 1e-8 tolerance is resolvable)
        ons = (gam2_c * vmu).to(torch.float64)
        ons_rel = torch.where(
            ons != 0.0,
            ((ons - prev_ons) / torch.where(ons == 0.0, 1.0, ons)).abs(),
            1.0,
        )
        ons_done = onsager_cols & (ons_rel < _ONSAGER_REL_TOL)
        still = active & ~ons_done

        upd = still[None, :]
        r = torch.where(upd, r_next, r)
        z = torch.where(upd, z_next, z)
        beta = (rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)).to(wd)
        p = torch.where(upd, z + beta[None, :] * p, p)

        rel_err = torch.where(still, torch.sqrt(rr).to(torch.float64) / safe_norm_v, rel_err)
        active = still & (rel_err >= tol)
        rz = torch.where(still, rz_new, rz)
        prev_ons = ons
        i += 1

        if debug:
            norm_mu = torch.sqrt(all_reduce_(colsum(mu, mu), dm.shard)).to(torch.float64)
            print(f"[CG] it = {i}: ||r_it|| / ||RHS|| = {rel_err.tolist()}, "
                  f"||x_it|| = {norm_mu.tolist()}", flush=True)
            ons_print = torch.where(onsager_cols, ons_rel, float("nan"))
            print(f"[CG onsager] it = {i}: relative error for onsager is "
                  f"{ons_print.tolist()}", flush=True)

    return CGResult(mu=mu, iters=i, rel_err=rel_err)
