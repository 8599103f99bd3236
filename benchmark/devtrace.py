"""Reading a torch.profiler trace of the measured window: the device's
busy time as the union of its intervals, kernel time by name, and the
breakdown of device operations and idle gaps."""
from __future__ import annotations

import bisect
import re

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and reach < hi:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


def kernel_base_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters ('void f<1, false>(G, P)' -> 'f')."""
    name = re.sub(r"\(.*$", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split()[-1].split("::")[-1] if out else name


class Trace:
    """Device and host events of one profiled window, times in seconds."""

    def __init__(self, device_events, host_events, window):
        self.device = device_events     # [(name, start, end)]
        self.host = host_events         # [(name, start, end)]
        self.lo, self.hi = window

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        device, host, window = [], [], None
        for e in prof.events():
            start = e.time_range.start * 1e-6
            end = e.time_range.end * 1e-6
            kind = str(getattr(e, "device_type", ""))
            if kind.endswith("CUDA"):
                if not getattr(e, "is_user_annotation", False):
                    device.append((e.name, start, end))
            else:
                host.append((e.name, start, end))
                if e.name == WINDOW_SPAN:
                    window = (start, end)
        if window is None:
            raise RuntimeError("the profile holds no window span")
        # a host span (record_function) is mirrored on the device's
        # timeline over the work it queued: not device work of its own
        spans = {n for n, _, _ in host}
        device = [d for d in device if d[0] not in spans]
        return cls(device, host, window)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device], self.lo,
                            self.hi)

    def kernel_s(self, names) -> float:
        """Summed time, inside the window, of the device kernels whose
        function name is one of names."""
        names = set(names)
        return sum(min(e, self.hi) - max(s, self.lo)
                   for n, s, e in self.device
                   if kernel_base_name(n) in names and e > self.lo
                   and s < self.hi)

    def device_ops(self, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        acc = {}
        for n, s, e in self.device:
            d = min(e, self.hi) - max(s, self.lo)
            if d > 0:
                acc[n] = acc.get(n, 0.0) + d
        return [[n, v] for n, v in sorted(acc.items(), key=lambda x: -x[1])
                [:top]]

    def idle_by_host(self, spans, top: int = 10):
        """[what the host was doing, seconds] over the device's idle time
        inside the window: the part of each idle gap that a traced span of
        the program (`spans`, named functions called one after another)
        covers is credited to it; the rest to 'host: in the call, outside
        the traced functions' inside a timed call (CALL_SPAN), else to
        'host: between calls'."""
        spans = set(spans)
        named = sorted((s, e, n) for n, s, e in self.host if n in spans)
        calls = sorted((s, e) for n, s, e in self.host if n == CALL_SPAN)
        acc = {}
        starts_named = [x[0] for x in named]
        starts_calls = [x[0] for x in calls]
        for gs, ge in idle_gaps([(s, e) for _, s, e in self.device],
                                self.lo, self.hi):
            left = ge - gs
            i = max(bisect.bisect_right(starts_named, gs) - 1, 0)
            for s_, e_, n in named[i:]:
                if s_ >= ge:
                    break
                d = min(e_, ge) - max(s_, gs)
                if d > 0:
                    acc[n] = acc.get(n, 0.0) + d
                    left -= d
            inside = 0.0
            j = max(bisect.bisect_right(starts_calls, gs) - 1, 0)
            for s_, e_ in calls[j:]:
                if s_ >= ge:
                    break
                inside += max(0.0, min(e_, ge) - max(s_, gs))
            inside = min(max(inside - (ge - gs - left), 0.0), left)
            key = "host: in the call, outside the traced functions"
            acc[key] = acc.get(key, 0.0) + inside
            acc["host: between calls"] = (acc.get("host: between calls", 0.0)
                                          + left - inside)
        return [[n, v] for n, v in sorted(acc.items(), key=lambda x: -x[1])
                [:top] if v > 0]
