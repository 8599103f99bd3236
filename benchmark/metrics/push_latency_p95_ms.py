"""The 95th percentile over the window's pushes of the time from handing
a push to the entry to the return of the payloads it completed, host
clock; the median and the count go on an earlier line."""
import numpy as np


def read(run):
    if not run.calls:
        return None
    ms = np.array([b - a for a, b, _ in run.calls]) * 1e3
    run.note("push_latency", median_ms=float(np.median(ms)),
             p95_ms=float(np.percentile(ms, 95)), max_ms=float(ms.max()),
             n=len(ms))
    return float(np.percentile(ms, 95))
