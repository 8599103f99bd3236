"""The wideband receiver's host deframe, on the profiler's clock: the
spans `rx.fetch` (the packed vector of all lanes to the host, unpacked)
and the deframe leaves summed over the lanes (`deframe.detect`,
`deframe.fsm`: a UW FSM a channel; `deframe.gather`, `deframe.bp`: one
decode batch for all; `deframe.consume`) over the window's pushes, ms a
push."""
from benchmark import spans

SPANS = ("rx.fetch", "deframe.detect", "deframe.fsm", "deframe.gather",
         "deframe.bp", "deframe.consume")


def read(run):
    return spans.ms_per_push(run, SPANS)
