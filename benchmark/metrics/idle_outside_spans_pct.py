"""The device's idle time that no program span explains: over the idle
gaps of the traced window, the part inside a timed push that none of the
receiver's eleven leaf spans covers (`devtrace.Trace.idle_by_host`'s
"host: in the call, outside the traced functions" given the leaves), as
a share of the window, in percent."""
from benchmark import spans


def read(run):
    return spans.idle_outside_pct(run)
