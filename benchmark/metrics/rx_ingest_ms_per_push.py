"""The receiver's host-to-card stages a push, on the profiler's clock:
the spans `rx.buffer` (the history and the chunk joined), `rx.copy_in`
(the pageable copy to the card) and `rx.launch` (the demod and the copies
of its results queued) over the window's pushes, ms a push."""
from benchmark import spans

SPANS = ("rx.buffer", "rx.copy_in", "rx.launch")


def read(run):
    return spans.ms_per_push(run, SPANS)
