"""dump_flush_ms: milliseconds a fit waits after its last iteration for the
IO thread's backlog of dumps to be written, the `dump.flush` span of the
fit's set-up walls (LinearResult.setup), the median over the untraced
fits of the window; nothing where the program records no such span."""

import numpy as np


def read(run):
    ms = [1e3 * f.result.setup["dump.flush"] for f in run.fits
          if (getattr(f.result, "setup", None) or {}).get("dump.flush") is not None]
    return float(np.median(ms)) if ms else None
