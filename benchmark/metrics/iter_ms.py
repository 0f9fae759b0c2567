"""iter_ms: the engine loop's milliseconds an iteration, the median over
iterations 2.. of every untraced fit of the window of the engine's own span
(LinearResult.iter_seconds: an iteration's wall, stopped after its one host
fetch, which waits for the card)."""

import numpy as np


def read(run):
    secs = [s for f in run.fits for s in (f.result.iter_seconds or [])[1:]]
    return 1e3 * float(np.median(secs)) if secs else None
