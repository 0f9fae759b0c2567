"""xpass_roofline: the kernels that read the design, as a share of their
roofline.  Each launch of a kernel named in benchmark/kernels/ reads the
stored design `x_reads` times; the least time of a pass is the design's
bytes at the card's 3.35 TB/s (roofline.py: the bytes bind a pass).  The share is the passes' least time over
the device time of those kernels in the traced window; nothing when the
trace holds none."""

from benchmark.roofline import HBM_BPS
from benchmark.trace import xpass_launches


def read(run):
    if not run.events:
        return None
    passes, secs = xpass_launches(run.events, run.kernels)
    if passes == 0 or secs <= 0:
        return None
    return 100.0 * passes * run.x_bytes / HBM_BPS / secs
