"""The host's UW acquisition, on the profiler's clock: the spans
`deframe.detect` (the soft bits appended, the hard bits), `deframe.fsm`
(the C FSM) and `deframe.consume` (the buffer cut and the FSM's state
carried, the counts) over the window's pushes, ms a push."""
from benchmark import spans

SPANS = ("deframe.detect", "deframe.fsm", "deframe.consume")


def read(run):
    return spans.ms_per_push(run, SPANS)
