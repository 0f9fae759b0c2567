"""Plain PyTorch probit GLM-VAMP: the benchmark's reference for the probit
model (case/control labels).

It follows the reference algorithm (VAMPomi, src/vamp_probit.cpp:19-467,
`--model bin_class`) in the port's documented update order, four
half-steps an iteration over the pair (x, z = A x), with an exact LMMSE
step for x:

  1. denoise x with the spike-and-slab mixture (the linear model's g1, g1'),
     rho-damping both x1 and alpha1 from iteration 2, eta1 from the
     undamped alpha1 (src/vamp_probit.cpp:130, 160-165);
  2. denoise z under the probit likelihood (src/vamp_probit.cpp:469-488),
     beta1 >= N clamped to N - 1, and the extrinsic pair (p2, tau2);
  3. the LMMSE step for x, exact in the eigenbasis of K = A A^T:
     x2 = (tau2 A^T A + gam2 I)^{-1} (tau2 A^T p2 + gam2 r2), z2 = A x2,
     alpha2 = gam2 tr((tau2 A^T A + gam2 I)^{-1}) / M in closed form;
  4. the LMMSE step for z: beta2 = (M/N)(1 - alpha2) and (p1, tau1).

The prior's EM update runs after the phase, on the r1 that the phase
consumed, from iteration 2 (src/vamp_probit.cpp:113, 139), so that g1 of
iteration k uses the prior of iteration k - 1.  The starting p1 ~ N(0, 1)^N
is the engine's documented draw: float64 normals from a CPU torch.Generator
seeded with the run's seed, before anything else.  No covariates.

The design, its eigenbasis, the mixture denoiser and the EM step are the
linear reference's (benchmark/reference/gvamp.py), which the caller passes
in as `linear`, so that this file imports nothing but torch and the
standard library.  The precision is the design's: float64 for the
reference, and for the control ("tf32") float32 vectors with every
product over the design rounded as a TF32 tensor-core product does it.
The z-denoisers form phi(x)/Phi(x) as sqrt(2/pi) / erfcx(-x/sqrt(2)), the
reference's form, in the design's precision.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

GAMMA_MIN, GAMMA_MAX = 1e-11, 1e11  # src/vamp.hpp:33-34
SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class Settings(NamedTuple):
    """The run's settings that the iteration reads (src/options.hpp)."""
    rho: float
    gam1: float          # the starting gam1, and tau1 (src/vamp_probit.cpp:35)
    probit_var: float
    learn_vars: bool


class Answer(NamedTuple):
    """What a fit returns: each iteration's row [alpha1, beta1, gam1, tau1,
    alpha2, beta2, gam2, tau2, x1 correlation, x2 correlation] (the params
    row and the two correlations with the true signal), the last
    iteration's [accuracy of A x1, x1 correlation], and the state after the
    last iteration; x1 and r1 in file units (over sqrt(N))."""
    rows: list
    last: list
    x1: torch.Tensor
    r1: torch.Tensor


def _clamp(g: float) -> float:
    return min(max(g, GAMMA_MIN), GAMMA_MAX)


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    den = math.sqrt(float(a @ a) * float(b @ b))
    return float(a @ b) / den if den > 0 else 0.0


def _accuracy(z: torch.Tensor, y: torch.Tensor) -> float:
    """The share of labels that 1[Phi(z) >= 1/2] = 1[z >= 0] gets right."""
    return float(((z >= 0).to(y.dtype) == y).to(torch.float64).mean())


def z_denoise(p: torch.Tensor, tau1: float, y: torch.Tensor,
              probit_var: float) -> tuple[torch.Tensor, float]:
    """The posterior mean of z under the probit likelihood at prior mean p
    and precision tau1, and the mean of its derivative over the samples
    (src/vamp_probit.cpp:469-488): with s = sqrt(probit_var + 1/tau1),
    t = (2y - 1) p / s and the inverse Mills ratio m = phi(t)/Phi(t),
    g = p + (2y - 1) m / (tau1 s), g' = 1 - m (t + m) / (1 + tau1 probit_var)."""
    s = math.sqrt(probit_var + 1.0 / tau1)
    sign = 2.0 * y - 1.0
    t = sign * p / s
    mills = SQRT_2_OVER_PI / torch.special.erfcx(-t / math.sqrt(2.0))
    g = p + sign * mills / (tau1 * s)
    gd = 1.0 - mills * (t + mills) / (1.0 + tau1 * probit_var)
    return g, float(gd.sum())


def start_p1(seed: int, n: int) -> torch.Tensor:
    """The starting z-extrinsic p1 ~ N(0, 1)^N (src/vamp_probit.cpp:53): the
    engine's documented draw, the first from a CPU torch.Generator seeded
    with the run's seed, in float64."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.randn(n, generator=g, dtype=torch.float64)


def tail_row(design, x1: torch.Tensor, y: torch.Tensor, ts: torch.Tensor) -> list:
    """[accuracy of z1 = A x1, correlation of x1 with the true signal]
    worked out from x1 in file units: an iteration's denoising accuracy and
    x1 correlation follow from its x1 alone."""
    dt, dev = design.dtype, design.codes.device
    x1 = x1.to(device=dev, dtype=dt)
    z1 = design.ax(x1[:, None])[:, 0]
    return [_accuracy(z1, y.to(device=dev, dtype=dt)), _corr(x1, ts.to(device=dev, dtype=dt))]


def run(linear, design, eig, y: torch.Tensor, ts: torch.Tensor, prior, p1: torch.Tensor,
        settings: Settings, *, iterations: int) -> Answer:
    """`iterations` probit GLM-VAMP iterations from the cold start (x1 = r1
    = 0, gam1 = tau1 = settings.gam1, p1 given) with an exact LMMSE step.
    `linear` is the linear reference module (gvamp.py: `denoise`, `em_step`,
    `Prior`), `design` and `eig` its Design and the Eigen of its Gram;
    `y` (N,) 0/1 labels, `ts` (M,) the true signal in file units, `prior`
    the linear reference's Prior with variances in file units."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt, dev = design.dtype, design.codes.device
    m, n = design.m, design.n
    y = y.to(device=dev, dtype=dt)
    ts = ts.to(device=dev, dtype=dt)
    p1 = p1.to(device=dev, dtype=dt)
    U, lam = eig.U.to(dt), eig.lam.to(dt)
    root_n = math.sqrt(n)
    rho, pv = settings.rho, settings.probit_var
    gam1 = tau1 = settings.gam1
    alpha1 = 0.0
    x1_hat = torch.zeros(m, dtype=dt, device=dev)
    r1 = torch.zeros_like(x1_hat)
    prior = linear.Prior(probs=list(prior.probs), vars=[v * n for v in prior.vars])
    rows, last = [], []
    for it in range(1, iterations + 1):
        # denoise x
        x1_new, dx = linear.denoise(r1, gam1, prior)
        alpha1_new = float(dx.sum()) / m
        eta1 = gam1 / alpha1_new
        if it > 1:
            x1_hat = rho * x1_new + (1.0 - rho) * x1_hat
            alpha1 = rho * alpha1_new + (1.0 - rho) * alpha1
        else:
            x1_hat, alpha1 = x1_new, alpha1_new
        gam2 = _clamp(eta1 - gam1)
        r2 = (eta1 * x1_hat - gam1 * r1) / gam2

        # denoise z
        z1_hat, gd_sum = z_denoise(p1, tau1, y, pv)
        beta1 = (n - 1.0 if gd_sum >= n else gd_sum) / n
        p2 = (z1_hat - beta1 * p1) / (1.0 - beta1)
        tau2 = tau1 * (1.0 - beta1) / beta1

        # LMMSE x, exact: q = (gam2 I + tau2 K)^{-1} A v = A x2
        v = tau2 * design.atx(p2[:, None])[:, 0] + gam2 * r2
        Z = design.ax(torch.stack([x1_hat / root_n, v], dim=1))
        d = 1.0 / (gam2 + tau2 * lam)
        q = U @ (d * (U.T @ Z[:, 1]))
        x2_hat = (v - tau2 * design.atx(q[:, None])[:, 0]) / gam2
        alpha2 = gam2 * (float(d.sum()) + (m - n) / gam2) / m

        r1_new = (x2_hat - alpha2 * r2) / (1.0 - alpha2)
        gam1_new = _clamp(gam2 * (1.0 - alpha2) / alpha2)

        # LMMSE z
        beta2 = m / n * (1.0 - alpha2)
        p1_new = (q - beta2 * p2) / (1.0 - beta2)
        tau1_new = _clamp(tau2 * (1.0 - beta2) / beta2)

        x1_corr = _corr(x1_hat, ts)
        rows.append([alpha1, beta1, gam1, tau1, alpha2, beta2, gam2, tau2,
                     x1_corr, _corr(x2_hat, ts)])
        last = [_accuracy(Z[:, 0], y), x1_corr]

        # EM after the phase, on the r1 it consumed
        if it > 1:
            prior = linear.em_step(r1, gam1, prior, learn_vars=settings.learn_vars)
        r1, gam1, p1, tau1 = r1_new, gam1_new, p1_new, tau1_new
    return Answer(rows=rows, last=last, x1=x1_hat / root_n, r1=r1 / root_n)
