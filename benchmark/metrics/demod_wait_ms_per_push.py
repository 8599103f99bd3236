"""The demod the receiver does not hide, on the profiler's clock: the
spans `rx.wait` (the host waits for the demod and its copies) and
`rx.retire` (the carry's pos and nin read back) over the window's pushes,
ms a push.  With `rx_ingest_ms_per_push` it makes `demod_ms_per_push`."""
from benchmark import spans

SPANS = ("rx.wait", "rx.retire")


def read(run):
    return spans.ms_per_push(run, SPANS)
