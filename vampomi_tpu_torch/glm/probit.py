# Copied from vampomi_tpu/glm/probit.py: predict_probit, mlogl_probit, _grad_cov and newton_method_cov as they are (host numpy/scipy, the --verbosity 1 print without its process gate); the z-denoisers in torch.
"""Probit-GLM denoisers and covariate solver.

The reference stabilizes the inverse-Mills ratio phi/Phi with a hand-rolled
double-precision erfcx polynomial (src/utilities.cpp:293-363, used at
src/vamp_probit.cpp:469-488).  The JAX package, and this port after it, get
the same stability from `log_ndtr`: phi(x)/Phi(x) = exp(logpdf(x) -
log_ndtr(x)), accurate for arbitrarily negative x.  The z-denoisers run on
tensors (torch.special.log_ndtr) in the tensors' dtype.

The Newton covariate solver (reference src/vamp_probit.cpp:525-617) runs once
per inference on a small (N, C) problem; it is host-side numpy/scipy with the
reference's exact update order, singular fallback, and backtracking line
search.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import log_ndtr as np_log_ndtr

_LOG_SQRT_2PI = 0.5 * np.log(2.0 * np.pi)


def _mills_ratio(x: torch.Tensor) -> torch.Tensor:
    """phi(x) / Phi(x), stable for all x (torch version)."""
    return torch.exp(-0.5 * x * x - _LOG_SQRT_2PI - torch.special.log_ndtr(x))


def _mills_ratio_np(x):
    return np.exp(-0.5 * x * x - _LOG_SQRT_2PI - np_log_ndtr(x))


def g1_bin_class(p, tau1, y, m_cov=0.0, probit_var=1.0):
    """Posterior mean of z under the probit likelihood
    (reference src/vamp_probit.cpp:469-478).  Vectorized over p, y, m_cov;
    tau1 and probit_var are numbers or 0-dim tensors of p's dtype."""
    s = torch.sqrt(torch.as_tensor(probit_var + 1.0 / tau1, dtype=p.dtype, device=p.device))
    sign = 2.0 * y - 1.0
    c = (p + m_cov) / s
    ratio = _mills_ratio(sign * c)
    return p + sign * ratio / (tau1 * s)


def g1d_bin_class(p, tau1, y, m_cov=0.0, probit_var=1.0):
    """Derivative of g1_bin_class (reference src/vamp_probit.cpp:480-488)."""
    s = torch.sqrt(torch.as_tensor(probit_var + 1.0 / tau1, dtype=p.dtype, device=p.device))
    sign = 2.0 * y - 1.0
    c = (p + m_cov) / s
    ratio = _mills_ratio(sign * c)
    return 1.0 - ratio / (1.0 + tau1 * probit_var) * (sign * c + ratio)


def predict_probit(z, th: float = 0.5):
    """Hard labels from Phi(z) >= th (reference src/vamp_probit.cpp:619-629)."""
    from scipy.special import ndtr

    z = np.asarray(z, dtype=np.float64)
    return (ndtr(z) >= th).astype(np.float64)


def mlogl_probit(y, gg, probit_var, Z, eta):
    """Mean negative probit log-likelihood (reference
    src/vamp_probit.cpp:490-502)."""
    g = np.asarray(gg) + np.asarray(Z) @ np.asarray(eta)
    arg = (2.0 * np.asarray(y) - 1.0) / np.sqrt(probit_var) * g
    return -np.mean(np_log_ndtr(arg))


def _grad_cov(y, gg, probit_var, Z, eta):
    """Gradient of the mean negative log-likelihood wrt eta (reference
    src/vamp_probit.cpp:504-523)."""
    g = gg + Z @ eta
    sign = 2.0 * y - 1.0
    arg = sign / np.sqrt(probit_var) * g
    ratio = _mills_ratio_np(arg)
    return -(Z.T @ (ratio * sign / np.sqrt(probit_var))) / len(y)


def newton_method_cov(
    y, gg, Z, eta, probit_var: float = 1.0, verbosity: int = 0
) -> np.ndarray:
    """Newton-Raphson probit regression of covariates with backtracking line
    search, replicating the reference's update order exactly
    (src/vamp_probit.cpp:525-617):

      * the Newton direction solves (Z^T W Z) d = Z^T lambda with
        lambda_i = mills((2y-1) g_i) (2y_i - 1) and
        W_ii = lambda_i (lambda_i + g_i);
      * singular system -> zero direction;
      * Armijo-like backtracking (scale *= 0.9, up to 299 shrinks);
      * if the relative step is < 1e-4 the step is DISCARDED and iteration
        stops (reference breaks before assigning eta = eta_new);
      * stops if the negative log-likelihood increases.
    """
    y = np.asarray(y, dtype=np.float64)
    gg = np.asarray(gg, dtype=np.float64)
    Z = np.asarray(Z, dtype=np.float64)
    eta = np.array(eta, dtype=np.float64)
    C = Z.shape[1]

    for it in range(501):
        g = gg + Z @ eta
        sign = 2.0 * y - 1.0
        arg = sign * g  # note: no 1/sqrt(probit_var) here (reference line 539)
        lam = _mills_ratio_np(arg) * sign
        W = lam * (lam + g)

        lhs = Z.T @ (Z * W[:, None])
        rhs = Z.T @ lam
        try:
            direction = np.linalg.solve(lhs, rhs)
        except np.linalg.LinAlgError:
            direction = np.zeros(C)

        grad = _grad_cov(y, gg, probit_var, Z, eta)
        init_val = mlogl_probit(y, gg, probit_var, Z, eta)
        scale = 1.0
        eta_new = eta.copy()
        for _ls in range(1, 300):  # 0.9^300 ~ 1.8e-14
            displ = scale * direction
            eta_new = eta + displ
            curr_val = mlogl_probit(y, gg, probit_var, Z, eta_new)
            if curr_val <= init_val + np.dot(displ, grad) / 2.0:
                break
            scale *= 0.9

        norm_eta = np.sqrt(np.dot(eta, eta))
        rel_err = 1.0 if norm_eta == 0 else np.sqrt(np.sum((eta - eta_new) ** 2)) / norm_eta
        if verbosity == 1:
            # reference per-iteration print, verbosity-gated
            # (src/vamp_probit.cpp:595-596); the port runs one process
            print(f"[Newton_cov] it = {it}, relative err = {rel_err}", flush=True)
        if rel_err < 1e-4:
            break  # step discarded, reference breaks before the assignment

        init_val = mlogl_probit(y, gg, probit_var, Z, eta)
        eta = eta_new
        curr_val = mlogl_probit(y, gg, probit_var, Z, eta)
        if curr_val > init_val:
            break  # likelihood not improving

    return eta
