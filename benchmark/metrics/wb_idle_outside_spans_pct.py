"""The wideband cell's device idle time that no program span explains:
`idle_outside_spans_pct` with the wideband receiver's leaf
`rx.channelize` (the band history, the channelizer and the lane buffer)
among the receiver's eleven leaves, so that stage's host time is not
counted as unexplained; a share of the window, in percent."""
from benchmark import spans

LEAVES = spans.LEAVES + ("rx.channelize",)


def read(run):
    trace = run.trace
    if (trace is None or trace.window_s <= 0
            or spans.seconds_in_window(trace, LEAVES) is None):
        return None
    idle = dict(trace.idle_by_host(LEAVES, top=len(LEAVES) + 2))
    return 100.0 * idle.get(spans.OUTSIDE, 0.0) / trace.window_s
