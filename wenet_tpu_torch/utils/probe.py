"""Internal-signal tracing (src/modem_probe.c equivalent; counterpart of
wenet_tpu/utils/probe.py).

The reference compiles optional named-trace hooks into the C demod and
dumps an Octave workspace (modem_probe.c:62-141).  Here `probe_demod`
demodulates a capture in one call of the demod with its per-frame traces
on (on the card, the frame-loop kernel's PROBE variant) and returns named
per-frame arrays; `save_npz` replaces the Octave dump with an .npz
workspace.

Trace names mirror the reference's (fsk.c:631,726,909-910,1089-1099):
  t_fft_est, t_f_est, t_norm_rx_timing, t_nin, t_EbNodB, t_ppm
plus rx soft/hard outputs.  `device_trace` covers the timing side with
torch.profiler.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops import fsk


def probe_demod(cfg, iq: np.ndarray, num_frames: int | None = None,
                device="cuda") -> dict:
    """Demodulate and return named per-frame traces (numpy), as the JAX
    package's probe_demod names them, from one demod call on `device`
    (CUDA unless the caller asks for another; raises without a card).
    Frames with valid False lie past the capture's end: their fields are
    not the demod's."""
    iq = np.asarray(iq, np.complex64)
    nf = cfg.num_frames(len(iq)) if num_frames is None else num_frames
    dev = resolve_device(device)
    _, outs, tr = fsk.demod_stream(cfg, torch.from_numpy(iq).to(dev), nf,
                                   with_probe=True)
    traces = {
        "t_fft_est": tr.fft_est,
        "t_f_est": outs.f_est,
        "t_norm_rx_timing": outs.norm_rx_timing,
        "t_nin": outs.nin,
        "t_EbNodB": outs.ebno_db,
        "t_ppm": outs.ppm,
        "t_f_int": tr.f_int,
        "t_rx_timing": tr.rx_timing,
        "t_high_sample": tr.high_sample,
        "rx_sd": outs.soft,
        "rx_bits": outs.bits,
        "valid": outs.valid,
    }
    return {k: v.cpu().numpy() for k, v in traces.items()}


def eye_traces(cfg, traces: dict, frame: int = -1) -> np.ndarray:
    """Eye diagram for one probed frame (fsk_demod stats JSON
    'eye_diagram' field)."""
    valid = np.flatnonzero(traces["valid"])
    f = valid[frame]
    return fsk.eye_diagram(traces["t_f_int"][f], cfg.P,
                           traces["t_high_sample"][f], cfg.M)


def save_npz(path: str, traces: dict) -> None:
    """Dump a probe workspace (the Octave-file role of modem_probe_close)."""
    np.savez_compressed(path, **traces)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace around a region, written to `logdir` in the
    format TensorBoard's profiler plugin reads: the host's activity, and
    the card's kernels where there is a card."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
