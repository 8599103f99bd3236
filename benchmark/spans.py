"""The program's own stage spans in a traced run: the receiver's leaves
(`wenet_tpu_torch/utils/spans.py`), host events of the profiler on the
clock of the device's activity.  A push meets them in this order, one
after another, none inside another:

    rx.buffer rx.copy_in rx.launch rx.wait rx.retire     (its demod clock)
    rx.fetch deframe.detect deframe.fsm deframe.gather
    deframe.bp deframe.consume                           (its deframe clock)

A reader of spans returns None where none of its spans lies in the
window: a span renamed in the program shows as a missing metric, never
as 0."""
from __future__ import annotations

LEAVES = ("rx.buffer", "rx.copy_in", "rx.launch", "rx.wait", "rx.retire",
          "rx.fetch", "deframe.detect", "deframe.fsm", "deframe.gather",
          "deframe.bp", "deframe.consume")

# devtrace.Trace.idle_by_host's name for the idle time inside a timed call
# that no span given to it covers
OUTSIDE = "host: in the call, outside the traced functions"


def seconds_in_window(trace, names):
    """Summed seconds of the host spans named in `names`, each clipped to
    the traced window; None where none of them lies in the window."""
    names = set(names)
    total, found = 0.0, False
    for n, s, e in trace.host:
        if n in names and e > trace.lo and s < trace.hi:
            found = True
            total += min(e, trace.hi) - max(s, trace.lo)
    return total if found else None


def ms_per_push(run, names):
    """The spans' seconds in the window over the window's pushes, in ms."""
    if run.trace is None or not run.calls:
        return None
    s = seconds_in_window(run.trace, names)
    return None if s is None else s / len(run.calls) * 1e3


def idle_outside_pct(run):
    """The device's idle time inside the timed calls that none of the
    leaves covers, as a share of the window, in percent."""
    trace = run.trace
    if (trace is None or trace.window_s <= 0
            or seconds_in_window(trace, LEAVES) is None):
        return None
    idle = dict(trace.idle_by_host(LEAVES, top=len(LEAVES) + 2))
    return 100.0 * idle.get(OUTSIDE, 0.0) / trace.window_s
