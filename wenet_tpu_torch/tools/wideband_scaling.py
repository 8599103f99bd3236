"""Wideband (channelized) throughput against the channel count N on the
card (counterpart of tools/wideband_scaling.py).

Builds an N-channel wideband capture (an independent 12-packet v2 burst
on every channel centre), then times the fused wideband path
(`ops.channelizer.demod_multichannel(..., fused=True)`: the channelizer
kernel, the demod kernel on the N channels as lanes, top-k acquisition,
one BP batch and the CRC) on the capture already on the card, at each N.
demod_multichannel returns host payload lists, so every timed region
ends with the packets' copy to the host.

    python -m wenet_tpu_torch.tools.wideband_scaling [N ...] [--reps 2]
        [--device cpu] [--out PATH]

prints one JSON record an N: band Msamples/s, x the band's real time,
channels complete (at least 11 of 12 packets), packets decoded and sent,
the first call's and the capture build's seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from . import emitter, platform
from .captures import CACHE_DIR, make_packet_bits, save_atomic

PACKETS_PER_CHANNEL = 12


def _channel_bits(cfg, seed):
    """12 framed packets with independent content per channel (the same
    burst on every centre would add coherently), 512 random bits after
    each, behind 8 frames of random bits, padded to whole frames."""
    return make_packet_bits(cfg, PACKETS_PER_CHANNEL,
                            np.random.default_rng(seed),
                            lead_bits=cfg.Nbits * 8, lead_last=True)


def build_wideband_capture(nch: int, cfg=None, ebno_db: float = 30.0,
                           cache: bool = True):
    """N-channel wideband complex64 capture at Fs_total = nch * cfg.Fs,
    every channel occupied -> (capture, Fs_total); disk-cached under
    build/wenet_tpu_torch/ (the host synthesis takes tens of seconds at
    N = 16).

    Each channel is synthesised at the wideband rate (the exact
    integer-phase modulator at Fs_total), then mixed to its centre; the
    AWGN is sized from the whole band's power (nch channels added
    incoherently), so +10 log10(nch) makes ebno_db each channel's."""
    from ..ops import channel, channelizer, fsk
    cfg = fsk.V2_CONFIG if cfg is None else cfg
    fs_total = cfg.Fs * nch
    fp = hashlib.sha1((f"{ebno_db}_{cfg.Fs}_{cfg.Rs}_" +
                       inspect.getsource(_channel_bits) +
                       inspect.getsource(make_packet_bits) +
                       inspect.getsource(fsk.fsk_mod_np)).encode()
                      ).hexdigest()[:10]
    path = os.path.join(CACHE_DIR, f"wideband_{nch}_{fp}.npy")
    if cache and os.path.exists(path):
        try:
            return np.load(path), fs_total
        except Exception:
            pass

    cfg_wide = dataclasses.replace(cfg, Fs=fs_total)
    centres = channelizer.channel_centres(fs_total, nch)
    wide = None
    for k in range(nch):
        sig_w, _ = fsk.fsk_mod_np(cfg_wide, _channel_bits(cfg, 100 + k),
                                  2 * cfg.Rs, cfg.Rs)
        sig_w = sig_w.astype(np.complex64)
        if wide is None:           # all channels share one frame count
            nw = len(sig_w)
            t = np.arange(nw, dtype=np.float64) / fs_total
            wide = np.zeros(nw, np.complex64)
        wide += (sig_w * np.exp(2j * np.pi * centres[k] * t)
                 ).astype(np.complex64)
    wide = channel.add_awgn(wide, ebno_db + 10 * np.log10(nch), fs_total,
                            cfg.Rs, rng=np.random.default_rng(nch))
    if cache:
        save_atomic(path, wide)
    return wide, fs_total


def measure(nch: int, reps: int = 2, log=lambda *a: None,
            device="cuda", cfg=None) -> dict:
    """Build or load the N-channel capture (channels at cfg's rates,
    default the flight geometry), copy it to the device once, run the
    fused wideband path `reps` times after a first call -> the record."""
    from ..ops import channelizer, fsk
    cfg = fsk.V2_CONFIG if cfg is None else cfg
    dev = resolve_device(device)
    t0 = time.perf_counter()
    wide, fs_total = build_wideband_capture(nch, cfg)
    build_s = time.perf_counter() - t0
    wide_dev = torch.from_numpy(wide).to(dev)
    wide_dev[-4:].real.cpu()                  # the copy has landed

    t0 = time.perf_counter()
    out = channelizer.demod_multichannel(wide_dev, fs_total, nch, cfg,
                                         fused=True, device=dev)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = channelizer.demod_multichannel(wide_dev, fs_total, nch, cfg,
                                             fused=True, device=dev)
    dt = (time.perf_counter() - t0) / reps
    got = {k: len(v) for k, v in out.items()}
    complete = sum(1 for v in got.values()
                   if v >= PACKETS_PER_CHANNEL - 1)
    msps = len(wide) / dt / 1e6
    rec = {"nch": nch, "fs_total": fs_total,
           "wideband_msps": round(msps, 1),
           "band_realtime_x": round(msps * 1e6 / fs_total, 1),
           "channels_complete": complete,
           "packets_per_channel": PACKETS_PER_CHANNEL,
           "packets_ok": sum(got.values()),
           "packets_sent": nch * PACKETS_PER_CHANNEL,
           "first_call_s": round(first, 3), "exec_s": round(dt, 5),
           "capture_build_s": round(build_s, 1),
           "platform": platform(dev)}
    log(f"N={nch:3d}: {msps:,.1f} wideband Msamp/s "
        f"({rec['band_realtime_x']}x rt of the {fs_total / 1e6:.2f} MHz "
        f"band), {complete}/{nch} channels complete, first {first:.3f}s")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("channels", nargs="*", type=int, default=[4, 8, 16])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    emit = emitter(dev, args.out, lambda s: print(s, flush=True))
    for nch in args.channels:
        emit(measure(nch, args.reps, lambda s: print(s, file=sys.stderr),
                     dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
