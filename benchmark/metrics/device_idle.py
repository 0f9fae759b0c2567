"""device_idle: the share of the traced window in which the card ran no
kernel, copy or set (the union of the profiler's device intervals,
trace.busy_and_window_s)."""


def read(run):
    if not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
