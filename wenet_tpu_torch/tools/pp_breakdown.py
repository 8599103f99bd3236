"""Per-push time breakdown of the streaming Receiver (counterpart of
tools/pp_breakdown.py).

Splits the steady-state pushes of a serial `rx.pipeline.Receiver` into
phases, read from the Receiver's own stage clocks (`Receiver.seconds`,
`utils.spans`) after real `push` calls:
  dispatch   rx.buffer + rx.copy_in + rx.launch: stage the push, copy it
             to the device, queue the demod kernel on the carry and the
             push and the copies of its results to the host
  exec_wait  rx.wait: wait for the demod and its copies (the event)
  retire     rx.retire: the carried state's pos read on the host, the
             carry kept
  fetch      rx.fetch: the packed soft bits, validity and stats unpacked
  uw         deframe.detect + deframe.fsm: the hard bits and the UW FSM on
             the host (the C FSM for a CUDA device, its numpy version on
             the CPU, as the Receiver picks it)
  decode     deframe.gather + deframe.bp: candidate gather and host
             descramble, one BP batch and the CRC on the device

The pipelined Receiver overlaps fetch, uw and decode of chunk k with the
device's work on chunk k+1, so the speed-up it can reach is total /
(dispatch + retire + max(exec_wait, fetch + uw + decode)).  The
deframer's consume (`deframe.consume`) is in no phase.

    python -m wenet_tpu_torch.tools.pp_breakdown [v2|v1] [--seconds 8]
        [--device cpu] [--out PATH]

prints one JSON record.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..device import resolve_device
from . import emitter, platform

PHASES = ("dispatch", "retire", "fetch", "uw", "decode", "exec_wait")
# each phase's stage clocks (`rx.pipeline.Receiver.seconds`)
STAGES = {"dispatch": ("rx.buffer", "rx.copy_in", "rx.launch"),
          "exec_wait": ("rx.wait",), "retire": ("rx.retire",),
          "fetch": ("rx.fetch",), "uw": ("deframe.detect", "deframe.fsm"),
          "decode": ("deframe.gather", "deframe.bp")}


def capture(mode="v2", seconds=8.0, ebno=12.0, input_format="cu8", cfg=None):
    """The tool's capture: as many packets as fit in `seconds` less one,
    each framed and followed by 512 random bits, FSK, AWGN at ebno, peak
    normalised -> (cu8 bytes or complex64 samples, packets sent)."""
    from ..ops import channel, fsk
    from ..rx import pipeline
    from .captures import PKT_CYCLE_V2, make_packet_bits

    cfg = pipeline.MODE_CONFIGS[mode] if cfg is None else cfg
    rng = np.random.default_rng(3)
    n_packets = max(int(seconds * cfg.Rs) // PKT_CYCLE_V2 - 1, 1)
    stream = make_packet_bits(cfg, n_packets, rng, lead_bits=0, mode=mode)
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno, cfg.Fs, cfg.Rs,
                          rng=rng)
    iq = iq / (np.abs(iq).max() + 1e-9)
    return (fsk.iq_to_cu8(iq) if input_format == "cu8" else iq), n_packets


def push_size(cfg, chunk_s: float, input_format: str) -> int:
    """Raw values a push: chunk_s seconds of samples."""
    return (2 if input_format == "cu8" else 1) * int(cfg.Fs * chunk_s)


def breakdown(raw, mode, cfg, input_format="cu8", chunk=None, device="cuda"):
    """One warm pass of a Receiver over raw, then a second Receiver's
    pushes, their stage clocks summed into the phases -> (seconds summed a
    phase, pushes with samples, payloads in order)."""
    from ..rx.pipeline import Receiver

    dev = resolve_device(device)
    chunk = chunk or push_size(cfg, 2.0, input_format)
    rx = Receiver(mode=mode, with_eye=False, input_format=input_format,
                  cfg=cfg, device=dev)
    for i in range(0, len(raw), chunk):          # kernels built and warm
        rx.push(raw[i:i + chunk])

    rx = Receiver(mode=mode, with_eye=False, input_format=input_format,
                  cfg=cfg, device=dev)
    pushes, payloads = 0, []
    for i in range(0, len(raw), chunk):
        samples = rx.stats.samples
        payloads += rx.push(raw[i:i + chunk])
        pushes += rx.stats.samples > samples     # a push of samples
    acc = {p: sum(rx.seconds[k] for k in STAGES[p]) for p in PHASES}
    return acc, pushes, payloads


def record(mode, input_format, acc, pushes, packets_ok, packets_sent,
           device) -> dict:
    """The tool's record of a breakdown."""
    total = sum(acc.values())
    host_side = acc["fetch"] + acc["uw"] + acc["decode"]
    serial_floor = acc["dispatch"] + acc["retire"] + max(
        acc["exec_wait"], host_side)
    return {"mode": mode, "input_format": input_format, "pushes": pushes,
            "packets_ok": packets_ok, "packets_sent": packets_sent,
            "per_push_ms": {k: round(v / max(pushes, 1) * 1e3, 3)
                            for k, v in acc.items()},
            "total_s": round(total, 4),
            "pp_speedup_bound": round(total / max(serial_floor, 1e-9), 2),
            "platform": platform(device)}


def run(mode="v2", seconds=8.0, chunk_s=2.0, ebno=12.0, input_format="cu8",
        cfg=None, device="cuda") -> dict:
    """Build the capture, break down a Receiver's pushes -> the record."""
    from ..rx import pipeline
    cfg = pipeline.MODE_CONFIGS[mode] if cfg is None else cfg
    dev = resolve_device(device)
    raw, n_packets = capture(mode, seconds, ebno, input_format, cfg)
    acc, pushes, payloads = breakdown(raw, mode, cfg, input_format,
                                      push_size(cfg, chunk_s, input_format),
                                      dev)
    return record(mode, input_format, acc, pushes, len(payloads), n_packets,
                  dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="v2", choices=("v1", "v2"))
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    emitter(dev, args.out, lambda s: print(s, flush=True))(
        run(args.mode, args.seconds, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
