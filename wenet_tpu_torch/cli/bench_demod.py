"""PER/throughput regression sweep (benchmarking/{generate_lowsnr,
test_demod}.py equivalent).

Self-contained: synthesizes a reference capture with the native modulator
(the upstream golden capture is an off-air recording not shipped in the
repo), degrades it to calibrated Eb/N0 levels with the same noise model,
optionally applies frequency-shift / baud-error fault injection
(test_demod.py:71-73), decodes each through the full chain, and prints the
README-style table of decoded bytes + runtime (benchmarking/README.md:63-86).
Counterpart of wenet_tpu/cli/bench_demod.py; the receiver runs on the card
unless --device cpu.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def add_args(ap: argparse.ArgumentParser):
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2")
    ap.add_argument("--packets", type=int, default=20,
                    help="packets in the synthesized capture")
    ap.add_argument("--ebno-start", type=float, default=5.0)
    ap.add_argument("--ebno-stop", type=float, default=15.0)
    ap.add_argument("--ebno-step", type=float, default=0.5)
    ap.add_argument("--shift", type=float, default=0.0,
                    help="frequency shift fault injection, Hz")
    ap.add_argument("--resample", type=float, default=1.0,
                    help="sample-rate error factor (1.004 = 0.4%% baud error)")
    ap.add_argument("--fs", type=int, default=None)
    ap.add_argument("--rs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")


def run_sweep(mode="v2", packets=20, ebnos=None, shift=0.0, resample=1.0,
              cfg=None, seed=42, log=print, device="cuda"):
    """Decode the synthesized capture at each Eb/N0 level with a fresh
    Receiver on `device` (CUDA unless the caller asks for another; raises
    without a card); logs the table and returns [(ebno, decoded bytes,
    runtime s)]."""
    from ..core import framing
    from ..ops import channel, fsk, ldpc
    from ..rx.pipeline import MODE_CONFIGS, Receiver

    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    rng = np.random.default_rng(seed)
    payloads, bits = [], []
    bits.append(rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8))
    for _ in range(packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode=mode)
        bits.append(framing.frame_to_bits(frame, mode))
        bits.append(rng.integers(0, 2, 256).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    sig = sig.astype(np.complex64)
    var = channel.signal_variance(sig)
    total_bytes = packets * 256

    log(f"# mode={mode} packets={packets} capture={len(sig) / cfg.Fs:.2f}s "
        f"shift={shift}Hz resample={resample}")
    log(f"{'Eb/N0 (dB)':>10} | {'Decoded Bytes':>13} | {'%':>6} | "
        f"{'Runtime (s)':>11}")
    results = []
    for ebno in ebnos:
        iq = channel.add_awgn(sig, ebno, cfg.Fs, cfg.Rs, variance=var,
                              rng=np.random.default_rng(seed + int(ebno * 10)))
        if shift:
            iq = channel.freq_shift(iq, shift, cfg.Fs)
        if resample != 1.0:
            iq = channel.resample_linear(iq, resample)
        rx = Receiver(mode=mode, cfg=cfg, device=device)
        t0 = time.time()
        got = rx.decode_iq(iq)
        dt = time.time() - t0
        nbytes = sum(len(p) for p in got)
        results.append((ebno, nbytes, dt))
        log(f"{ebno:>10.1f} | {nbytes:>13d} | {100.0 * nbytes / total_bytes:>6.1f}"
            f" | {dt:>11.2f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)
    from ..ops import fsk
    cfg = None
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs, Rs=args.rs)
    ebnos = np.arange(args.ebno_start, args.ebno_stop, args.ebno_step)
    run_sweep(args.mode, args.packets, ebnos, args.shift, args.resample,
              cfg, args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
