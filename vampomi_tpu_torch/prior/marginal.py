# Copied from vampomi_tpu/prior/marginal.py.
"""Truth-free spike/slab prior estimation from marginal effects — the
one-pass analog of the reference's documented Gibbs warm start
(reference README.md:170-213: run an MCMC sampler, average its prior
rows via scripts/conf_gibbs_init.py, feed the .conf back with
--init-conf).  These estimators supply the same (lambda, slab var, h2)
triple from a single A^T y device pass plus a host-side 1-D EM, so a
production run at wide M/N (where EM-within-VAMP destabilizes,
EM_STABILITY.json) can fix its prior without ever touching ground truth.

Model for the M marginal effects b_j = A_j^T y_centered:

    b ~ (1 - lam) N(0, v0)  +  lam N(0, v0 + v1)

v0 — THE EXACT CONDITIONAL PIN.  An exactly standardized column (zero
sum, fixed sum of squares s2 = sum_i A_ij^2; the engine guarantees both,
ops/operator.py build_design / reference src/data.cpp:270-276) built
from rotation-invariant raw data is uniform on the radius-sqrt(s2)
sphere of the zero-sum subspace (dim n-1), so conditional on the
observed phenotype the null variance is

    v0 = ||y_c||^2 * s2 / (n - 1)        -- exact, ZERO estimation error.

This exactness is load-bearing: at M >> N the causal signal is a
0.3-3% sliver on top of m*v0, and the (lam, v1) MLE moves ~25% for
every 0.1% of v0 mis-pin (measured on north-star-shape mixture draws).
A free-v0 EM absorbs the sliver into v0 (h2 biased ~40% low); a
median-of-chi2 pin carries ~0.3% MC error at m=1e6 (h2 ~45% low).
Pinning the exact conditional value removes the error entirely — for a
binary trait it is fully deterministic, ||y_c||^2 = n*ybar*(1-ybar).
(Int8/int4-quantized columns are standardized exactly but are not
exactly spherical; the exchangeability correction is O(1/n) ~ 1e-4
relative at production n, far inside the safe zone.)

Scale convention: s2 is passed as `col_sumsq` (production engine units:
n-1 for alpha=1 standardization; the unit-column convention of the
calibration fixtures: (n-1)/n).  Internally S := col_sumsq * n/(n-1)
is the per-column sum of squares on the unit-variance-entry scale
(S = n in engine units, S = 1 for unit columns).

Linear trait (y scaled to unit variance, reference src/data.cpp:88-103):
    E[b_j | beta] = S * beta_j           =>  h2 = lam * m * v1 / (n * S)

Probit/liability trait (y binary, l = sum_j a_j^std beta_j + N(0,1),
y = 1{l > t}, sum beta^2 = h2): the indicator's linear response
attenuates each marginal effect by c = phi(Phi^-1(ybar)) / sqrt(1 + h2)
(density of the liability at the threshold; reference likelihood
src/vamp_probit.cpp:469-488; slope verified to ~2% on generative
fixtures, tests/test_marginal_prior.py).  Hence

    T := lam * m * v1 / (n * S * phi^2)  =  h2 / (1 + h2),  h2 = T/(1-T)

— the liability-scale attenuation 1/(1+h2) enters through the
self-consistent T map; omitting it (the round-4 tool) biases h2 by the
full (1+h2) factor.

EM convergence: the (lam, v1) likelihood ridge at weak separation is so
flat that plain EM needs ~10^4 sweeps (600 sweeps leaves t 50% high —
the transient, not the MLE, was being reported).  fit_marginal_mixture
therefore runs SQUAREM (Varadhan & Roland 2008 squared extrapolation)
in (log lam, log v1); it reaches the pinned-v0 MLE in ~50-100
accelerated steps, verified against a 10^4-sweep plain EM.

Accuracy is set by the causal count CM and the slab/null separation,
not by the estimator: at the north-star regime (CM ~ 2100, slab 2.4x
null) the MLE itself scatters ~±25% (1 sigma) on T per draw with a
~-10% small-sample bias (6-seed mean; verified converged — plain EM
does not move from the SQUAREM point) — the information limit of the
marginal statistic.  Small fixtures (CM ~ 330) scatter ~±30-40%; tests
band the seed mean accordingly (tests/test_marginal_prior.py).
"""

from __future__ import annotations

import math

import numpy as np

_SQRT2PI = math.sqrt(2.0 * math.pi)


def _normal_ppf(p: float) -> float:
    """Inverse standard-normal CDF (bisection on erfc is plenty at the
    1e-12 level needed here; scipy-free so the module has no hard scipy
    dependency)."""
    lo, hi = -12.0, 12.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if 0.5 * math.erfc(-mid / math.sqrt(2.0)) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _em_step(
    b2: np.ndarray, lam: float, v1: float, v0: float
) -> tuple[float, float]:
    s1 = v0 + v1
    log_r1 = (math.log(lam) - 0.5 * math.log(s1) - 0.5 * b2 / s1) - (
        math.log1p(-lam) - 0.5 * math.log(v0) - 0.5 * b2 / v0
    )
    r1 = 1.0 / (1.0 + np.exp(-np.clip(log_r1, -40, 40)))
    w1 = float(r1.sum())
    lam_new = min(max(w1 / b2.size, 1e-12), 0.5)
    v1_new = max(float((r1 * b2).sum()) / max(w1, 1e-12) - v0, 1e-300)
    return lam_new, v1_new


def fit_marginal_mixture(
    bhat: np.ndarray,
    v0: float,
    iters: int = 300,
    lam_init: float = 0.01,
) -> tuple[float, float]:
    """Pinned-v0 SQUAREM-EM for  b ~ (1-lam) N(0, v0) + lam N(0, v0+v1)
    over the M marginal effects; returns the MLE (lam, v1).

    v0 is REQUIRED and must be the exact conditional null variance
    ||y_c||^2 * col_sumsq / (n-1) — see the module docstring for why a
    data-estimated v0 (free EM refresh, median-of-chi2) destroys the
    estimate at M >> N.  v1 is the EXCESS slab variance, so (lam, v1)
    stays identified even when the slab is only ~2x the null (the
    north-star probit regime).

    SQUAREM extrapolation in (log lam, log v1): plain EM crawls along
    the flat lam*v1 ridge for ~10^4 sweeps before converging; the
    squared-secant step reaches the same fixed point in ~10^2 F-evals
    (verified: identical (lam, v1) to a 10^4-sweep plain EM at the
    north-star mixture shape, and EM started AT truth converges to the
    same point — it is the MLE, not an artifact of the start)."""
    b2 = np.asarray(bhat, dtype=np.float64) ** 2
    v0 = float(v0)
    if not v0 > 0.0:
        raise ValueError("v0 pin must be positive")
    lam = float(lam_init)
    v1 = max(float(b2.mean()) - v0, v0) * 10.0
    th = np.array([math.log(lam), math.log(v1)])

    def F(th):
        lam_n, v1_n = _em_step(b2, math.exp(th[0]), math.exp(th[1]), v0)
        return np.array([math.log(lam_n), math.log(max(v1_n, 1e-300))])

    for _ in range(iters):
        th1 = F(th)
        th2 = F(th1)
        r = th1 - th
        v = th2 - th1 - r
        nv = float(np.linalg.norm(v))
        if nv < 1e-14:
            th = th2
            break
        alpha = min(-float(np.linalg.norm(r)) / nv, -1.0)
        th_new = F(th - 2.0 * alpha * r + alpha * alpha * v)
        if not np.all(np.isfinite(th_new)):
            th_new = th2
        if float(np.linalg.norm(th_new - th)) < 1e-10:
            th = th_new
            break
        th = th_new
    return math.exp(th[0]), math.exp(th[1])


def estimate_linear_prior(
    bhat: np.ndarray,
    n: int,
    y_ss: float | None = None,
    col_sumsq: float | None = None,
    h2_cap: float = 0.95,
) -> dict:
    """Truth-free (lam, slab var, h2) for a LINEAR trait from marginal
    effects b = A^T y.  `y_ss` = ||y_c||^2 (defaults to n: unit-variance
    phenotype); `col_sumsq` = per-column sum of squares of A (defaults
    to the unit-column fixture convention (n-1)/n; engine units pass
    n-1).  h2 = lam*m*v1/(n*S); slab variance in FILE units (the .conf
    convention, scripts/conf_gibbs_init.py output) is h2/(lam*m) so the
    triple is consistent."""
    bhat = np.asarray(bhat)
    m = bhat.size
    col_sumsq = (n - 1.0) / n if col_sumsq is None else float(col_sumsq)
    y_ss = float(n) if y_ss is None else float(y_ss)
    s_unit = col_sumsq * n / (n - 1.0)
    v0 = y_ss * col_sumsq / (n - 1.0)
    lam, v1 = fit_marginal_mixture(bhat, v0)
    h2 = min(max(lam * m * v1 / (n * s_unit), 1e-4), h2_cap)
    return dict(lam=lam, v0=v0, v1_internal=v1, h2=h2,
                var_file=h2 / (lam * m))


def estimate_probit_prior(
    bhat: np.ndarray,
    n: int,
    ybar: float,
    col_sumsq: float | None = None,
    h2_cap: float = 0.95,
) -> dict:
    """Truth-free (lam, slab var, h2) for a PROBIT trait from marginal
    effects b = A^T (y - ybar), y in {0, 1}.

    For binary y the conditional pin is fully deterministic:
    ||y_c||^2 = n*ybar*(1-ybar) exactly, so v0 = n*ybar*(1-ybar) *
    col_sumsq/(n-1) with zero estimation error.  The indicator's linear
    response attenuates each marginal effect by
    c = phi(Phi^-1(ybar)) / sqrt(1 + h2)  (liability variance 1 + h2
    with unit probit noise, reference src/vamp_probit.cpp model), so
    lam*m*v1 = c^2 h2 n S and T = lam*m*v1/(n S phi^2) = h2/(1+h2) —
    inverted in closed form.  File-unit slab variance is h2/(lam*m),
    matching the liability construction sum(beta^2) = h2."""
    bhat = np.asarray(bhat)
    m = bhat.size
    ybar = float(min(max(ybar, 1e-6), 1.0 - 1e-6))
    col_sumsq = (n - 1.0) / n if col_sumsq is None else float(col_sumsq)
    s_unit = col_sumsq * n / (n - 1.0)
    v0 = n * ybar * (1.0 - ybar) * col_sumsq / (n - 1.0)
    lam, v1 = fit_marginal_mixture(bhat, v0)
    phi = math.exp(-0.5 * _normal_ppf(ybar) ** 2) / _SQRT2PI
    t = lam * m * v1 / (n * s_unit * phi * phi)
    h2 = min(max(t / max(1.0 - t, 0.05), 1e-4), h2_cap)
    return dict(lam=lam, v0=v0, v1_internal=v1, h2=h2,
                var_file=h2 / (lam * m), attenuation_sq=phi * phi / (1.0 + h2),
                t=t)
