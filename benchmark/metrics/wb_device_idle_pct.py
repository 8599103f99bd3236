"""The share of the wideband cell's traced window in which the device ran
neither a kernel nor a copy: the union of the profiler's device
intervals, not their sum."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
