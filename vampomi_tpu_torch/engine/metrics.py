"""Error measures of the linear engine (port of vampomi_tpu/engine/metrics.py).

Reference: `vamp::err_measures` (src/vamp.cpp:760-852) fills a 6-slot metrics
row [R2 denoising, x1 corr, R2 LMMSE, x2 corr, z1 corr^2, z2 corr^2].
Vector math stays in the input's dtype; the outputs are f64 0-dim tensors.
"""

from __future__ import annotations

import torch

from ..ops.operator import f64


def _corr(a, b):
    num = torch.dot(a, b)
    den = torch.sqrt(torch.dot(a, a) * torch.dot(b, b))
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def signal_metrics(x_hat, true_signal, n):
    """Corr(x_hat, x0) and L2 error of x_hat/sqrt(N) vs x0 (file units)."""
    ts = true_signal.to(x_hat.dtype)
    inv_sqrt_n = (1.0 / torch.sqrt(f64(n, x_hat.device))).to(x_hat.dtype)
    corr = _corr(x_hat, ts)
    diff = x_hat * inv_sqrt_n - ts
    ts2 = torch.dot(ts, ts)
    l2 = torch.sqrt(torch.dot(diff, diff) / torch.where(ts2 == 0.0, torch.ones_like(ts2), ts2))
    return corr.to(torch.float64), l2.to(torch.float64)


def prediction_metrics(z_hat, y):
    """R2 = 1 - ||y - z||^2 / ||y||^2 and Corr(z, y)^2."""
    yc = y.to(z_hat.dtype)
    resid = yc - z_hat
    y2 = torch.dot(yc, yc)
    r2 = 1.0 - (torch.dot(resid, resid)
                / torch.where(y2 == 0.0, torch.ones_like(y2), y2)).to(torch.float64)
    c = _corr(z_hat, yc).to(torch.float64)
    return r2, c * c
