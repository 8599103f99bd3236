"""The receiver's card-to-host stage, on the profiler's clock: the span
`rx.fetch` (the packed soft bits, validity and stats copied and
unpacked) over the window's pushes, ms a push."""
from benchmark import spans

SPANS = ("rx.fetch",)


def read(run):
    return spans.ms_per_push(run, SPANS)
