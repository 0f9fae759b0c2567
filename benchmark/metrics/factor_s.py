"""factor_s: seconds of a fit's LMMSE factor, the Gram (ops/spectral.py
build_spectral) and under eigen its eigh (ops/eigen.py), from the engine's
own spans (LinearResult.setup "gram" and "eigh"), the median over the
window's untraced fits; nothing for a fit without a factor (CG)."""

import numpy as np


def read(run):
    secs = [f.result.setup["gram"] + f.result.setup.get("eigh", 0.0)
            for f in run.fits if f.result.setup and "gram" in f.result.setup]
    return float(np.median(secs)) if secs else None
