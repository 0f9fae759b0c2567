"""Error measures of the engines (port of vampomi_tpu/engine/metrics.py).

Reference: `vamp::err_measures` (src/vamp.cpp:760-852) fills the linear
engine's 6-slot metrics row [R2 denoising, x1 corr, R2 LMMSE, x2 corr, z1
corr^2, z2 corr^2]; the probit engine counts the confusion matrix of its
labels (src/vamp_probit.cpp:631-652).  Vector math stays in the input's
dtype; the outputs are f64 0-dim tensors, the counts int64.  The signal
metrics run over markers: a sharded engine sums their four inner products
(`signal_sums`) over the ranks in its own batch, then finishes them
(`signal_from_sums`).
"""

from __future__ import annotations

import torch

from ..ops.operator import f64


def _corr(a, b):
    num = torch.dot(a, b)
    den = torch.sqrt(torch.dot(a, a) * torch.dot(b, b))
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def signal_sums(x_hat, true_signal, n) -> torch.Tensor:
    """The four inner products over markers the signal metrics need, in
    x_hat's dtype: [x·t, x·x, t·t, d·d] with d = x/sqrt(N) - t."""
    ts = true_signal.to(x_hat.dtype)
    inv_sqrt_n = (1.0 / torch.sqrt(f64(n, x_hat.device))).to(x_hat.dtype)
    diff = x_hat * inv_sqrt_n - ts
    return torch.stack([torch.dot(x_hat, ts), torch.dot(x_hat, x_hat), torch.dot(ts, ts),
                        torch.dot(diff, diff)])


def signal_from_sums(s: torch.Tensor):
    """Corr(x_hat, x0) and the L2 error from signal_sums' four (summed)
    inner products."""
    xt, xx, tt, dd = s
    den = torch.sqrt(xx * tt)
    corr = xt / torch.where(den == 0.0, torch.ones_like(den), den)
    l2 = torch.sqrt(dd / torch.where(tt == 0.0, torch.ones_like(tt), tt))
    return corr.to(torch.float64), l2.to(torch.float64)


def signal_metrics(x_hat, true_signal, n):
    """Corr(x_hat, x0) and L2 error of x_hat/sqrt(N) vs x0 (file units)."""
    return signal_from_sums(signal_sums(x_hat, true_signal, n))


def prediction_metrics(z_hat, y):
    """R2 = 1 - ||y - z||^2 / ||y||^2 and Corr(z, y)^2."""
    yc = y.to(z_hat.dtype)
    resid = yc - z_hat
    y2 = torch.dot(yc, yc)
    r2 = 1.0 - (torch.dot(resid, resid)
                / torch.where(y2 == 0.0, torch.ones_like(y2), y2)).to(torch.float64)
    c = _corr(z_hat, yc).to(torch.float64)
    return r2, c * c


def confusion_counts(y, yhat):
    """TP, TN, FP, FN for 0/1 labels (reference src/vamp_probit.cpp:631-652)."""
    tp = ((y == 1) & (yhat == 1)).sum()
    tn = ((y == 0) & (yhat == 0)).sum()
    fp = ((y == 0) & (yhat == 1)).sum()
    fn = ((y == 1) & (yhat == 0)).sum()
    return tp, tn, fp, fn
