"""A kernel's share of its roofline over a traced window."""
from __future__ import annotations

from benchmark import harness


def share(run, kernel: str):
    """100 * (least time of the recorded calls' work at the card's peaks)
    / (device time of the kernel's names in the window); None where the
    card has no row of peaks, no call was recorded or no device time was
    traced.  Notes which bound applies."""
    calls = run.kernel_calls.get(kernel)
    if not calls or run.peaks is None or run.trace is None:
        return None
    kmod = harness.load_module("kernels", kernel)
    flops, bw = run.peaks["fp32_flops_per_s"], run.peaks["hbm_bytes_per_s"]
    least = t_ops = t_bytes = 0.0
    for rec, hist in calls:
        ops, nbytes = kmod.work(rec, hist)
        least += max(ops / flops, nbytes / bw)
        t_ops += ops / flops
        t_bytes += nbytes / bw
    device_s = run.trace.kernel_s(kmod.NAMES)
    if device_s <= 0:
        return None
    run.note(f"{kernel}_roofline", calls=len(calls), least_s=least,
             device_s=device_s,
             bound="operations" if t_ops >= t_bytes else "bytes")
    return 100.0 * least / device_s
