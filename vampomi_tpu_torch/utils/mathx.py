# Copied from vampomi_tpu/utils/mathx.py: noise_prec_calc, calc_stdev and simulate_mixture as they are; erfcx and normal_cdf in torch.
"""Math utilities completing the reference's runtime-library surface
(src/utilities.cpp): erfcx, normal_cdf, the Gaussian-mixture sampler, the
synced stdev, and the SNR-based noise-precision estimate.

`erfcx` is the JAX package's stable composition (not the reference's fma
polynomial): exp(x^2) erfc(x) in the moderate range, the continued-fraction
asymptotic for large x, and the reflection erfcx(x) = 2 exp(x^2) - erfcx(-x)
for negative x (clamped like the reference at x < -10, utilities.cpp:293-298),
on torch.special.erfc in f64.  `normal_cdf` is erfc's too.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def erfcx(x) -> torch.Tensor:
    """Scaled complementary error function, exp(x^2) * erfc(x), f64."""
    x = torch.as_tensor(x, dtype=torch.float64)
    ax = x.abs()

    # moderate |x|: direct product is exact (exp(x^2) < 1e43 for |x| < 10)
    a10 = torch.clamp(ax, max=10.0)
    direct = torch.exp(a10 * a10) * torch.special.erfc(a10)

    # large x > 10: asymptotic continued fraction 1/(sqrt(pi) x) * (1 - 1/(2x^2) + 3/(4x^4) - ...)
    ax2 = ax * ax
    asym = (1.0 / (ax * math.sqrt(math.pi))) * (
        1.0 - 0.5 / ax2 + 0.75 / (ax2 * ax2) - 1.875 / (ax2 * ax2 * ax2)
    )

    pos = torch.where(ax > 10.0, asym, direct)

    # reflection for negative arguments; reference clamps x < -10 to +inf
    a26 = torch.clamp(ax, max=26.0)
    neg = 2.0 * torch.exp(a26 * a26) - pos
    neg = torch.where(x < -10.0, math.inf, neg)
    return torch.where(x >= 0.0, pos, neg)


def normal_cdf(x) -> torch.Tensor:
    """Phi(x) = erfc(-x/sqrt(2))/2 (reference utilities.cpp:284-287), in x's
    floating dtype (f64 for anything else).  Through erfc, as the reference
    and the JAX package compute it: torch.special.ndtr on the CPU returns 0
    below x = -10 (f64), where Phi(-10) = 7.6e-24."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    return 0.5 * torch.special.erfc(-x * (1.0 / math.sqrt(2.0)))


def noise_prec_calc(snr: float, vars_, probs, mt: int, n: int) -> float:
    """gamw = SNR / (Mt * E[var]) (reference utilities.cpp:92-101)."""
    expe = float(np.dot(np.asarray(vars_), np.asarray(probs)))
    return snr / mt / expe


def calc_stdev(vec: np.ndarray) -> float:
    """Sample stdev with the (n-1) denominator (reference utilities.cpp:183-205)."""
    return float(np.std(np.asarray(vec), ddof=1))


def simulate_mixture(m: int, eta, pi, seed: int | None = None) -> np.ndarray:
    """Sample m values from a Gaussian mixture with variances `eta` and
    weights `pi`; a zero variance is a spike at 0
    (reference utilities.cpp:50-89, seeded instead of random_device)."""
    eta = np.asarray(eta, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    rng = np.random.default_rng(seed)
    comp = rng.choice(len(pi), size=m, p=pi / pi.sum())
    draws = rng.normal(0.0, 1.0, size=m) * np.sqrt(eta[comp])
    return np.where(eta[comp] == 0.0, 0.0, draws)
