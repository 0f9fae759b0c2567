"""iter_host_share: the share of an engine iteration in which the host,
not the card, sets the pace: 100 x (`iteration` - `fetch`) / `iteration`
of the engine's own spans (LinearResult.iter_phases; `fetch` is the one
batched copy where the host waits for the card), the median over
iterations 2.. of every untraced fit of the window; nothing where the
program records no phases."""

import numpy as np


def read(run):
    shares = [(p["iteration"] - p["fetch"]) / p["iteration"]
              for f in run.fits for p in (getattr(f.result, "iter_phases", None) or [])[1:]
              if "fetch" in p and p.get("iteration", 0) > 0]
    return 100.0 * float(np.median(shares)) if shares else None
