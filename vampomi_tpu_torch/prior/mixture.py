"""Spike + Gaussian-mixture prior: MMSE denoisers and EM hyperparameter
updates, vectorized over (M, L) (port of vampomi_tpu/prior/mixture.py).

Math follows the reference exactly, including its numerical stabilization:
the largest mixture variance ("eta_max") is factored out of every exponent
(reference: src/vamp.cpp:440-492 g1/g1d, src/vamp.cpp:531-643 updatePrior).
The same factoring keeps every exponent ≤ 0, which keeps the (M, L) math
safe in f32, the work dtype on the card; hyperparameters and sufficient
statistics stay f64 (O(L) scalars).

Fixed component count: merged components keep their slot with prob 0 and
`active` False, as in the JAX package, so every tensor keeps its shape.

Conventions: `vars` are the *internally scaled* variances (multiplied by N,
reference src/vamp.cpp:87-88); component 0 is the spike (vars[0] == 0 by
default) and is never merged away nor var-learned.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.operator import f64

_SIGMA_TINY = 1e-10  # reference: src/vamp.cpp:446 shortcut when 1/gam1 ~ 0


class MixturePrior(NamedTuple):
    """Mixture hyperparameters with a fixed max component count, on one
    device.  probs/vars are f64 (O(L) scalars)."""

    probs: torch.Tensor   # (L,) f64, dead slots 0
    vars: torch.Tensor    # (L,) f64, scaled by N
    active: torch.Tensor  # (L,) bool

    @property
    def L(self) -> int:
        return self.probs.shape[0]


def _vmax(prior: MixturePrior) -> torch.Tensor:
    """Largest active variance (f64)."""
    return torch.where(prior.active, prior.vars,
                       torch.full_like(prior.vars, -math.inf)).max()


def _terms(y: torch.Tensor, gam1, prior: MixturePrior):
    """Common per-component quantities in y's dtype.

    Returns (sigma, v, z) with z_j(y) = probs_j / sqrt(vars_j + sigma) *
    exp(stabilized exponent), 0 for inactive slots.
    """
    wd = y.dtype
    sigma = (1.0 / f64(gam1, y.device)).to(wd)
    eta_max = _vmax(prior).to(wd)
    v = prior.vars.to(wd)[None, :]
    probs = prior.probs.to(wd)[None, :]
    y2 = (y * y)[:, None]
    expo = -0.5 * y2 * (eta_max - v) / (v + sigma) / (eta_max + sigma)
    z = probs / torch.sqrt(v + sigma) * torch.exp(expo)
    z = torch.where(prior.active[None, :], z, torch.zeros((), dtype=wd, device=y.device))
    return sigma, v, z


def g1(y: torch.Tensor, gam1, prior: MixturePrior) -> torch.Tensor:
    """MMSE posterior-mean denoiser (reference src/vamp.cpp:440-463) in the
    shrinkage form  g1 = y * sum_k w_k v_k/(v_k + sigma),  w_k = z_k / sum z,
    which keeps full relative precision at cold start (sigma = 1e6) where the
    reference's `y + sigma pk'/pk` cancels to 0 in f32."""
    sigma, v, z = _terms(y, gam1, prior)
    pk = z.sum(dim=1)
    pk_safe = torch.where(pk == 0.0, torch.ones_like(pk), pk)
    w = z / pk_safe[:, None]
    shrink = (w * (v / (v + sigma))).sum(dim=1)
    # pk can underflow to 0 in f32 for huge |y|: the posterior is then
    # dominated by the max-variance component, so take its shrinkage factor
    vmax = _vmax(prior).to(y.dtype)
    shrink = torch.where(pk == 0.0, vmax / (vmax + sigma), shrink)
    val = y * shrink
    return torch.where(sigma.abs() < _SIGMA_TINY, y, val)


def g1d(y: torch.Tensor, gam1, prior: MixturePrior) -> torch.Tensor:
    """Derivative of g1 (reference src/vamp.cpp:465-492), in the stable form

        g1d = sum_k w_k v_k/(v_k+sigma) + sigma y^2 Var_w[1/(v+sigma)]

    with a two-pass variance (>= 0 by construction; the E[a^2]-E[a]^2 form
    cancels negative in f32 and collapses alpha1 at cold start)."""
    sigma, v, z = _terms(y, gam1, prior)
    a = 1.0 / (v + sigma)
    pk = z.sum(dim=1)
    pk_safe = torch.where(pk == 0.0, torch.ones_like(pk), pk)
    w = z / pk_safe[:, None]
    shrink = (w * (v * a)).sum(dim=1)
    mean_a = (w * a).sum(dim=1)
    var_a = (w * (a - mean_a[:, None]) ** 2).sum(dim=1)
    val = shrink + sigma * (y * y) * var_a
    vmax = _vmax(prior).to(y.dtype)
    val = torch.where(pk == 0.0, vmax / (vmax + sigma), val)
    return torch.where(sigma.abs() < _SIGMA_TINY, torch.ones_like(y), val)


def em_update(
    r1: torch.Tensor,
    gam1,
    prior: MixturePrior,
    mmask: torch.Tensor,
    mt,
    *,
    em_max_iter,
    em_err_thr,
    learn_vars,
    debug: bool = False,
) -> MixturePrior:
    """One call of the reference's `updatePrior` EM loop
    (src/vamp.cpp:531-643, minus the merge — see `merge_components_device`).

    A Python loop stands in for JAX's lax.while_loop.  With the default
    em_max_iter = 1 the loop condition never reads the device's convergence
    flag, so the call does not synchronise.  The (M, L) responsibilities are
    in r1's dtype; the O(L) hyperparameter arithmetic stays f64.
    """
    wd = r1.dtype
    dev = r1.device
    gam1 = f64(gam1, dev)
    noise_var = (1.0 / gam1).to(wd)
    gam1_c = gam1.to(wd)
    slab = prior.active & (torch.arange(prior.L, device=dev) >= 1)
    mmask_c = mmask.to(wd)
    r2_half = (r1 * r1) * 0.5  # (M,)
    two_pi = torch.tensor(2.0 * np.pi, dtype=wd, device=dev)
    zero = torch.zeros((), dtype=wd, device=dev)
    neg_inf = torch.full_like(prior.vars, -math.inf)

    def masked_rel_dist(a, b):
        d = torch.where(prior.active, (a - b) ** 2, 0.0).sum()
        n = torch.where(prior.active, a * a, 0.0).sum()
        return torch.sqrt(d / torch.where(n == 0.0, 1.0, n))

    probs64, vars64 = prior.probs, prior.vars
    it = 0
    done = None
    while it < int(em_max_iter) and not (done is not None and bool(done)):
        lam64 = 1.0 - probs64[0]
        max_sigma = torch.where(prior.active, vars64, neg_inf).max().to(wd)

        v_col = vars64.to(wd)[None, :]
        probs_c = probs64.to(wd)[None, :]
        num = (
            probs_c
            * torch.exp(
                -r2_half[:, None] * (max_sigma - v_col) / (v_col + noise_var)
                / (max_sigma + noise_var)
            )
            / torch.sqrt(v_col + noise_var)
            / torch.sqrt(two_pi)
        )
        num = torch.where(slab[None, :], num, zero)
        sum_num = num.sum(dim=1)
        sum_safe = torch.where(sum_num == 0.0, torch.ones_like(sum_num), sum_num)
        beta = num / sum_safe[:, None]

        # pin_i: posterior inclusion probability of marker i
        spike_term = (
            (1.0 - lam64).to(wd)
            / torch.sqrt(two_pi * noise_var)
            * torch.exp(-r2_half * max_sigma / noise_var / (noise_var + max_sigma))
        )
        pin = 1.0 / (1.0 + spike_term / sum_safe)
        pin = pin * mmask_c

        lam_total = pin.sum().to(torch.float64)
        lam_new = lam_total / mt

        v_safe = torch.where(v_col == 0.0, torch.ones_like(v_col), v_col)
        gmean = gam1_c * r1[:, None] / (1.0 / v_safe + gam1_c)
        v_post64 = 1.0 / (1.0 / torch.where(vars64 == 0.0, 1.0, vars64) + gam1)
        gammas = beta * (gmean * gmean + v_post64.to(wd)[None, :])

        res = (beta * pin[:, None]).sum(dim=0).to(torch.float64)
        res_gammas = (gammas * pin[:, None]).sum(dim=0).to(torch.float64)

        res_safe = torch.where(res == 0.0, 1.0, res)
        new_vars = torch.where(slab & (res != 0.0), res_gammas / res_safe, vars64)
        vars_next = new_vars if bool(learn_vars) else vars64
        omegas = torch.where(
            slab, res / torch.where(lam_total == 0.0, 1.0, lam_total), 0.0)
        probs_next = torch.where(slab, lam_new * omegas, probs64)
        probs_next = torch.cat([(1.0 - lam_new).reshape(1), probs_next[1:]])
        probs_next = torch.where(prior.active, probs_next, 0.0)

        dist_probs = masked_rel_dist(probs_next, probs64)
        dist_vars = masked_rel_dist(vars_next, vars64)
        done = (dist_probs < em_err_thr) & (dist_vars < em_err_thr)
        if debug:
            # per-EM-iteration narration (--verbosity 1; src/vamp.cpp:615-617)
            print(f"it = {it}: dist_probs = {float(dist_probs)} & "
                  f"dist_vars = {float(dist_vars)}", flush=True)
        probs64, vars64 = probs_next, vars_next
        it += 1
    return MixturePrior(probs=probs64, vars=vars64, active=prior.active)


def merge_components(
    probs: np.ndarray, vars_: np.ndarray, active: np.ndarray, merge_vars_thr: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side merge of near-duplicate variance components (reference
    src/vamp.cpp:627-642; copied from vampomi_tpu/prior/mixture.py).  The
    reference erases vector entries; we zero the prob and clear the active
    flag so shapes stay fixed.  Returns new (probs, vars, active) arrays."""
    probs = np.array(probs, dtype=np.float64)
    vars_ = np.array(vars_, dtype=np.float64)
    active = np.array(active, dtype=bool)
    L = len(probs)
    for j in range(L):
        if not active[j]:
            continue
        for k in range(j + 1, L):
            if not active[k]:
                continue
            denom = min(vars_[j], vars_[k]) if vars_[j] != 0 else 1e-7
            if denom == 0.0:
                # vars_[j] != 0 but vars_[k] == 0: infinite ratio, never a merge
                continue
            if abs(vars_[j] - vars_[k]) / denom < merge_vars_thr:
                probs[j] += probs[k]
                probs[k] = 0.0
                active[k] = False
    return probs, vars_, active


def merge_components_device(prior: MixturePrior, merge_vars_thr) -> MixturePrior:
    """Merge with `merge_components`' semantics, computed on the prior's
    device without a host round trip (unrolled over the fixed L, ~L^2/2
    scalar selects)."""
    probs = prior.probs.clone()
    vars_ = prior.vars
    active = prior.active.clone()
    thr = f64(merge_vars_thr, probs.device)
    L = probs.shape[0]
    for j in range(L):
        for k in range(j + 1, L):
            denom = torch.where(
                vars_[j] != 0.0, torch.minimum(vars_[j], vars_[k]),
                torch.tensor(1e-7, dtype=torch.float64, device=probs.device))
            # denom == 0 means an infinite ratio — never a merge; divide by a
            # dummy 1.0 to keep the masked-out lane finite
            ratio = (vars_[j] - vars_[k]).abs() / torch.where(denom != 0.0, denom, 1.0)
            do = active[j] & active[k] & (denom != 0.0) & (ratio < thr)
            probs[j] = probs[j] + torch.where(do, probs[k], 0.0)
            probs[k] = torch.where(do, 0.0, probs[k])
            active[k] = torch.where(do, False, active[k])
    return MixturePrior(probs=probs, vars=vars_, active=active)


def init_prior(probs, vars_, n_samples: int, l_max: int | None = None,
               device: str | torch.device = "cpu") -> MixturePrior:
    """A MixturePrior from CLI-style probs/vars (unscaled); variances are
    scaled by N internally (reference: src/vamp.cpp:87-88)."""
    probs = np.asarray(probs, dtype=np.float64)
    vars_ = np.asarray(vars_, dtype=np.float64) * float(n_samples)
    L = len(probs)
    if len(vars_) != L:
        raise ValueError("probs and vars must have equal length")
    l_max = l_max or L
    p = np.zeros(l_max)
    v = np.zeros(l_max)
    a = np.zeros(l_max, dtype=bool)
    p[:L] = probs
    v[:L] = vars_
    a[:L] = True
    return MixturePrior(
        probs=torch.as_tensor(p, device=device),
        vars=torch.as_tensor(v, device=device),
        active=torch.as_tensor(a, device=device),
    )
