"""eigh_solve_s: seconds of the eigh alone inside the LMMSE factor
(ops/eigen.py's `eigh.solve` span, LinearResult.setup["eigen_solve"], a
part of "eigh"), the median over the window's untraced fits; nothing where
no fit ran an eigh or the program does not record it."""

import numpy as np


def read(run):
    secs = [f.result.setup["eigen_solve"] for f in run.fits
            if f.result.setup and "eigen_solve" in f.result.setup]
    return float(np.median(secs)) if secs else None
