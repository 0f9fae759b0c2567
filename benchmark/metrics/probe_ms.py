"""probe_ms: milliseconds an engine iteration spends on its trace probe,
drawn or skipped on the host (the engine's `probe` span in
LinearResult.iter_phases), the median over iterations 2.. of every
untraced fit of the window; nothing where the program records no
phases."""

import numpy as np


def read(run):
    secs = [p["probe"] for f in run.fits
            for p in (getattr(f.result, "iter_phases", None) or [])[1:] if "probe" in p]
    return 1e3 * float(np.median(secs)) if secs else None
