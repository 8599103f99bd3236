"""RX CLI: IQ samples in, decoded packets/images/telemetry out.

The streaming branch of `python -m wenet_tpu rx` on the PyTorch port:

    python -m wenet_tpu_torch rx capture.cu8 --format cu8 --mode v2

Payloads go through `wenet_tpu.rx.router.PacketRouter` (images, JSON logs,
UDP side-channels).  The whole-capture modes of the JAX CLI (--parallel,
--slabs, --channels, --acquire) are not ported yet and exit with status 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

NOT_PORTED = ("parallel", "slabs", "channels", "acquire")


def add_args(ap: argparse.ArgumentParser):
    ap.add_argument("input", help="IQ file path, or '-' for stdin")
    ap.add_argument("--format", choices=["cu8", "cs16", "c64"],
                    default="cu8", help="input sample format")
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2",
                    help="framing mode (baud 115177 RS232 / 96000 scrambled)")
    ap.add_argument("--fs", type=int, default=None,
                    help="sample rate override (default: mode standard)")
    ap.add_argument("--rs", type=int, default=None, help="baud override")
    ap.add_argument("-b", "--est-min", type=int, default=None,
                    help="estimator lower limit, Hz (fsk_demod -b)")
    ap.add_argument("-u", "--est-max", type=int, default=None,
                    help="estimator upper limit, Hz (fsk_demod -u)")
    ap.add_argument("--image-dir", default="./rx_images")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--no-udp", action="store_true",
                    help="disable UDP side-channel emission")
    ap.add_argument("--stats-rate", type=float, default=1.0,
                    help="modem stats emission rate, Hz")
    ap.add_argument("--chunk-seconds", type=float, default=2.0)
    ap.add_argument("--pipelined", action="store_true",
                    help="overlap device demod of chunk k+1 with host "
                         "deframe of chunk k (payloads arrive one chunk "
                         "later)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    for name in NOT_PORTED:
        ap.add_argument(f"--{name}", default=None, help=argparse.SUPPRESS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)
    for name in NOT_PORTED:
        if getattr(args, name) is not None:
            print(f"--{name} is not yet ported to wenet_tpu_torch",
                  file=sys.stderr)
            return 2

    from wenet_tpu.rx import stats as rxstats
    from wenet_tpu.rx.router import PacketRouter, UDPEmitter

    from ..ops import fsk
    from ..rx.pipeline import (INPUT_CONVERTERS, MODE_CONFIGS, Receiver,
                               receiver_stats_record)

    cfg = MODE_CONFIGS[args.mode]
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs or cfg.Fs, Rs=args.rs or cfg.Rs)
    limits = None
    if args.est_min is not None or args.est_max is not None:
        limits = (args.est_min if args.est_min is not None else cfg.est_min,
                  args.est_max if args.est_max is not None else cfg.est_max)
    rx = Receiver(mode=args.mode, cfg=cfg, estimator_limits=limits,
                  pipelined=args.pipelined, input_format=args.format,
                  device=args.device)
    emitter = UDPEmitter(enabled=not args.no_udp)
    router = PacketRouter(image_dir=args.image_dir, log_dir=args.log_dir,
                          emitter=emitter)
    stats_acc = rxstats.FSKDemodStats(
        averaging_time=max(1.0 / args.stats_rate, 0.5), peak_hold=True,
        sample_rate=rx.cfg.Fs)

    _, dtype, width = INPUT_CONVERTERS[args.format]
    bytes_per_sample = np.dtype(dtype).itemsize * width
    chunk_bytes = int(rx.cfg.Fs * args.chunk_seconds) * bytes_per_sample

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    last_stats = 0.0
    t0 = time.time()
    try:
        while True:
            raw = fin.read(chunk_bytes)
            if not raw:
                break
            for payload in rx.push(np.frombuffer(raw, dtype=dtype)):
                router.handle_packet(payload)
            now = time.time()
            if not args.no_udp and now - last_stats > 1.0 / args.stats_rate:
                rec = receiver_stats_record(rx)
                if rec:
                    stats_acc.update(rec)
                    rxstats.send_modem_stats(stats_acc.to_wire())
                last_stats = now
    finally:
        for payload in rx.flush():        # drain the in-flight chunk
            router.handle_packet(payload)
        router.flush()
        if fin is not sys.stdin.buffer:
            fin.close()
    dt = time.time() - t0
    s = rx.stats
    print(f"samples={s.samples} frames={s.frames} detections={s.detections} "
          f"crc_ok={s.crc_ok} images={router.images_decoded} "
          f"wall={dt:.2f}s ({s.samples / max(dt, 1e-9) / 1e6:.2f} Msamp/s) "
          f"device={rx.device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
