"""The polyphase channelizer's work (`csrc/channelize.cu`, launched by
`ops.channelizer.channelize_pairs` on a CUDA tensor).

NAMES lists the device kernels whose time is this kernel's; a later
implementation adds its kernel's name.  The work is counted from the
call's shapes, a frozen copy of the smoke run's `channelize_bound`: the
samples read once (8 bytes as float pairs, 2 as cu8), the selected
channels written once (8 bytes a sample); per frame the N phases' T
complex-by-real multiply-adds (4 operations each) and each selected
channel's N complex multiply-adds (8).
"""
from __future__ import annotations

OP = "wenet_tpu_torch.ops.channelizer:channelize_pairs"
NAMES = ("channelize_kernel",)
SAMPLE_BYTES = {"c64": 8, "cu8": 2}


def record(args, kwargs, result) -> dict:
    """One call's shapes; its work does not depend on the data."""
    import torch
    names = ("x", "n_channels", "taps_per_phase", "channels",
             "input_format")
    call = {"taps_per_phase": 12, "channels": None, "input_format": "c64"}
    call.update(zip(names, args), **kwargs)
    x, N = call["x"], int(call["n_channels"])
    fmt = call["input_format"]
    n = x.shape[0] // 2 if fmt == "cu8" else x.shape[0]
    nsel = N if call["channels"] is None else len(call["channels"])
    return {"n": n, "N": N, "T": int(call["taps_per_phase"]), "nsel": nsel,
            "fmt": fmt, "hist": torch.zeros(1)}


def work(rec: dict, hist) -> tuple:
    """(float operations, bytes) of one recorded call."""
    n, N, T, nsel = rec["n"], rec["N"], rec["T"], rec["nsel"]
    F = n // N
    return (F * (N * T * 4 + nsel * N * 8),
            SAMPLE_BYTES[rec["fmt"]] * n + 8 * nsel * F)
