"""zchannel_ms: milliseconds an iteration of the probit engine spends in its
z-channel, the `zdenoise` span (the probit z-denoisers, beta1, p2, tau2)
plus the `zlmmse` span (beta2, p1, tau1) of the engine's own iteration
phases (ProbitResult.iter_phases; host walls, which end when their
launches are queued), the median over iterations 2.. of every untraced fit
of the window; nothing where the program records no such span (the linear
engine, or a probit engine from before them)."""

import numpy as np


def read(run):
    secs = [p["zdenoise"] + p["zlmmse"] for f in run.fits
            for p in (getattr(f.result, "iter_phases", None) or [])[1:]
            if "zdenoise" in p and "zlmmse" in p]
    return 1e3 * float(np.median(secs)) if secs else None
