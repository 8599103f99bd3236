"""Stage clocks that are also profiler spans.

`span(name, clocks, total)` times a block on the host's perf counter and
adds the duration to `clocks[name]` and to `clocks[total]`.  While a torch
profiler records, it also opens a profiler range of that name around the
block, so the stage shows in the trace as a host event on the clock of
the device's activity, and an idle stretch of the device can be put down
to the stage the host was in.  With the profiler off it costs the perf
counter and one boolean check; with `clocks` None it does nothing.

The range is PyTorch's C++ one (`torch._C._profiler._RecordFunctionFast`,
what `torch.compile` marks its regions with), not the Python
`torch.profiler.record_function`: on an H100 host that one took about 25
us a span inside the range and more around it, which put the profiler's
sum of a push's six deframe stages 2.5-3.0 % above their perf counters
and left about 1 % of a traced window idle between the stages.

The receiver's stages (`rx.pipeline.Receiver.seconds`):

    rx.buffer rx.copy_in rx.launch rx.wait rx.retire    -> "demod"
    rx.fetch deframe.detect deframe.fsm deframe.gather
    deframe.bp deframe.consume                          -> "deframe"

The wideband receiver's (`rx.pipeline.WidebandReceiver.seconds`) add
`rx.channelize` (the band history, the channelizer, the lane buffer)
after `rx.copy_in`; its deframe stages sum over the channels
(`deframe.detect` and `deframe.fsm` once a channel, `deframe.gather`,
`deframe.bp` and `deframe.consume` once a push for all of them).
"""
from __future__ import annotations

import time

import torch


class span:
    """Context manager: one stage of a clocked path (see the module)."""

    __slots__ = ("_name", "_clocks", "_total", "_t0", "_traced")

    def __init__(self, name: str, clocks: dict | None, total: str):
        self._name, self._clocks, self._total = name, clocks, total

    def __enter__(self):
        self._traced = None
        if self._clocks is not None and torch.autograd._profiler_enabled():
            self._traced = torch._C._profiler._RecordFunctionFast(self._name)
            self._traced.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._traced is not None:
            self._traced.__exit__(*exc)
        if self._clocks is not None:
            self._clocks[self._name] += dt
            self._clocks[self._total] += dt
        return False
