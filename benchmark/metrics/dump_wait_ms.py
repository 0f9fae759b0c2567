"""dump_wait_ms: milliseconds an iteration the engine loop waits for the IO
thread's backlog before it hands over an iteration's dump, the `dump.wait`
span (AsyncWriter.submit; 0 in an iteration whose submit found room) of
the iterations that staged a dump (`dump.stage`) of the engine's phases,
the median over iterations 2.. of every untraced fit of the window;
nothing where the program records no `dump.stage` (its outputs off, or a
program from before the span)."""

import numpy as np


def read(run):
    ms = [1e3 * p.get("dump.wait", 0.0) for f in run.fits
          for p in (getattr(f.result, "iter_phases", None) or [])[1:] if "dump.stage" in p]
    return float(np.median(ms)) if ms else None
