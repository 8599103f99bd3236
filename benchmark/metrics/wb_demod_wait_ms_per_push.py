"""The wideband receiver's demod that it does not hide, on the profiler's
clock: the spans `rx.wait` (the host waits for the demod of all lanes
and its copies) and `rx.retire` (the lanes' pos and nin read back, their
carries kept) over the window's pushes, ms a push."""
from benchmark import spans

SPANS = ("rx.wait", "rx.retire")


def read(run):
    return spans.ms_per_push(run, SPANS)
