"""The candidates' decode batch, on the profiler's clock: the spans
`deframe.gather` (the windows gathered, descrambled or stripped on the
host, padded) and `deframe.bp` (the copy in, BP, CRC and the copy back
that waits for them) over the window's pushes, ms a push.  With
`rx_fetch_ms_per_push` and `uw_fsm_ms_per_push` it makes
`deframe_ms_per_push`."""
from benchmark import spans

SPANS = ("deframe.gather", "deframe.bp")


def read(run):
    return spans.ms_per_push(run, SPANS)
