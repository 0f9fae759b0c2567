"""dump_write_ms: milliseconds the IO thread takes to write an iteration's
dump, the `dump.write` span (engine/linear.py dump_iteration: x1 and r1
widened to float64, divided by sqrt(N) and written) that the engine folds
into the iteration's phases, the median over the iterations of every
untraced fit of the window; nothing where the program records no such
span."""

import numpy as np


def read(run):
    ms = [1e3 * p["dump.write"] for f in run.fits
          for p in (getattr(f.result, "iter_phases", None) or []) if "dump.write" in p]
    return float(np.median(ms)) if ms else None
