"""RX CLI: IQ samples in, decoded packets/images/telemetry out.

The streaming branch of `python -m wenet_tpu rx` on the PyTorch port:

    python -m wenet_tpu_torch rx capture.cu8 --format cu8 --mode v2

Payloads go through the port's own `rx.router.PacketRouter` (images, JSON
logs, UDP side-channels).  `--acquire SECONDS` probes the head of the stream,
searches a coarse frequency-offset grid on the device
(`parallel.sweep.acquisition_search`) and, on a UW lock, mixes every chunk
by the winner on the host, phase-continuously.  `--parallel N` decodes the
whole capture in one fused device step of N overlap-save chunks
(`rx.pipeline.decode_iq_fused`); `--slabs S` cuts it into S slabs kept in
flight (`decode_iq_fused_overlap`) and alone implies `--parallel 4*S`.
`--format s16` (real s16 samples) converts on the host and pushes complex
samples.  Unless `--no-udp`, the modem-stats records carry the eye
diagram of the last valid frame.  `--channels N` takes the input as one
wideband stream at N times the mode's rate and decodes it as it streams
in: each chunk goes through the streaming wideband receiver
(`rx.pipeline.WidebandReceiver`: the channelizer, with its filter history
carried from chunk to chunk, and the N channels as lanes of one demod call
on the device, a UW FSM a channel and one decode batch on the host; cu8
bytes are converted in the channelizer kernel, other formats on the host),
pipelined as `--pipelined` makes the single-channel receiver (a chunk's
payloads come with the next chunk), so it runs live on a pipe from an
SDR set to N times the rate:

    <SDR's cu8 at 7.68 MS/s> | python -m wenet_tpu_torch rx - --format cu8 \
        --mode v2 --channels 8

`--channel-select` keeps only the channels it names.
"""
from __future__ import annotations

import argparse
import queue
import sys
import threading
import time

import numpy as np


def _chunk_reader(fin, chunk_bytes: int, depth: int = 2):
    """Background-thread chunk prefetcher: file and stdin reads overlap the
    device's work (the role the Unix pipe buffer plays between rtl_sdr and
    fsk_demod in the reference).  A read that raises ends the stream, as
    the end of the file does."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def pump():
        try:
            while True:
                raw = fin.read(chunk_bytes)
                q.put(raw)
                if not raw:
                    return
        except Exception:
            q.put(b"")

    threading.Thread(target=pump, daemon=True).start()
    while True:
        raw = q.get()
        if not raw:
            return
        yield raw


def add_args(ap: argparse.ArgumentParser):
    ap.add_argument("input", help="IQ file path, or '-' for stdin")
    ap.add_argument("--format", choices=["cu8", "cs16", "s16", "c64"],
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
    ap.add_argument("--partialupdate", type=int, default=0,
                    help="decode partial image every N packets")
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--no-udp", action="store_true",
                    help="disable UDP side-channel emission")
    ap.add_argument("--stats-rate", type=float, default=1.0,
                    help="modem stats emission rate, Hz")
    ap.add_argument("--chunk-seconds", type=float, default=2.0)
    ap.add_argument("--acquire", type=float, default=0.0, metavar="SECONDS",
                    help="probe this many seconds first and search a coarse "
                         "frequency-offset grid (parallel on the device) "
                         "when the SDR tuning is unknown; 0 = off")
    ap.add_argument("--throttle", action="store_true",
                    help="pace file input at real time")
    ap.add_argument("--pipelined", action="store_true",
                    help="overlap device demod of chunk k+1 with host "
                         "deframe of chunk k (payloads arrive one chunk "
                         "later); --channels always does")
    ap.add_argument("--parallel", type=int, default=0, metavar="N",
                    help="one-shot overlap-save decode of the whole capture "
                         "with N chunks demodulated as lanes of one device "
                         "step (whole-file throughput mode)")
    ap.add_argument("--slabs", type=int, default=0, metavar="S",
                    help="with --parallel: cut the capture into S "
                         "overlapping slabs kept 2 in flight, so the copy "
                         "of slab s+1 overlaps the work on slab s")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--channels", type=int, default=0, metavar="N",
                    help="wideband mode: the input is one band of N "
                         "channels of --fs each, channelized and "
                         "demodulated as it streams in (each chunk: the "
                         "channelizer and the channels as lanes of one "
                         "device call)")
    ap.add_argument("--channel-select", default=None, metavar="K[,K...]",
                    help="with --channels: only decode these channel indices")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)

    from ..ops import fsk
    from ..rx import stats as rxstats
    from ..rx.pipeline import (INPUT_CONVERTERS, MODE_CONFIGS, Receiver,
                               receiver_stats_record)
    from ..rx.router import PacketRouter, UDPEmitter

    cfg = MODE_CONFIGS[args.mode]
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs or cfg.Fs, Rs=args.rs or cfg.Rs)
    limits = None
    if args.est_min is not None or args.est_max is not None:
        limits = (args.est_min if args.est_min is not None else cfg.est_min,
                  args.est_max if args.est_max is not None else cfg.est_max)

    def receiver(input_format):
        return Receiver(mode=args.mode, cfg=cfg, estimator_limits=limits,
                        pipelined=args.pipelined, input_format=input_format,
                        with_eye=not args.no_udp, device=args.device)

    conv, dtype, width = INPUT_CONVERTERS[args.format]
    if args.channels:
        return _wideband(args, cfg, conv, dtype, width)
    if args.slabs > 1 and not args.parallel:
        args.parallel = 4 * args.slabs
        print(f"--slabs {args.slabs} implies --parallel {args.parallel} "
              "(fused one-step mode)", file=sys.stderr)
    if args.parallel:
        return _fused(args, cfg, conv, dtype, width)
    bytes_per_sample = np.dtype(dtype).itemsize * width
    rx = receiver("c64")
    chunk_bytes = int(rx.cfg.Fs * args.chunk_seconds) * bytes_per_sample

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")

    # optional coarse acquisition: probe the head of the stream across an
    # offset grid on the device, then mix every chunk by the winner
    mix_frac = 0.0            # offset/Fs (fractional cycles per sample)
    mix_pos = 0               # global sample index for phase continuity
    pending = b""
    if args.acquire > 0:
        from ..parallel.sweep import acquisition_search
        probe_n = int(rx.cfg.Fs * args.acquire)
        pending = fin.read(probe_n * bytes_per_sample)
        probe_iq = conv(np.frombuffer(pending, dtype=dtype))
        step = rx.cfg.Rs // 2
        grid = np.arange(-(rx.cfg.Fs // 2) + 2 * step,
                         rx.cfg.Fs // 2 - 2 * step, step, dtype=np.float32)
        best, scores = acquisition_search(rx.cfg, probe_iq, grid,
                                          mode=args.mode, device=rx.device)
        nuw = 32 if args.mode == "v2" else 40
        if scores.max() >= nuw - 2 * (4 if args.mode == "v2" else 5):
            mix_frac = float(best) / rx.cfg.Fs
            print(f"acquired coarse offset {best:+.0f} Hz "
                  f"(UW score {scores.max():.0f}/{nuw})", file=sys.stderr)
        else:
            print(f"acquisition found no UW lock (best score "
                  f"{scores.max():.0f}/{nuw}); leaving tuning unchanged",
                  file=sys.stderr)

    # without mixing, push the raw rtl_sdr / pcmcat bytes and convert on
    # the device; mixing (and s16) converts on the host
    raw_push = args.format in ("cu8", "cs16") and not mix_frac
    if raw_push:
        rx = receiver(args.format)
    emitter = UDPEmitter(enabled=not args.no_udp)
    router = PacketRouter(image_dir=args.image_dir, log_dir=args.log_dir,
                          partial_update=args.partialupdate,
                          headless=args.headless, emitter=emitter)
    stats_acc = rxstats.FSKDemodStats(
        averaging_time=max(1.0 / args.stats_rate, 0.5), peak_hold=True,
        sample_rate=rx.cfg.Fs)

    last_stats = 0.0
    t0 = time.time()
    next_deadline = t0
    try:
        reader = _chunk_reader(fin, chunk_bytes)
        while True:
            raw = pending + next(reader, b"")
            pending = b""
            if not raw:
                break
            if args.throttle:
                next_deadline += args.chunk_seconds
                delay = next_deadline - time.time()
                if delay > 0:
                    time.sleep(delay)
            buf = np.frombuffer(raw, dtype=dtype)
            if not raw_push:
                buf = conv(buf)
            if mix_frac:
                n = mix_pos + np.arange(len(buf), dtype=np.float64)
                buf = (buf * np.exp(-2j * np.pi * np.mod(n * mix_frac, 1.0))
                       ).astype(np.complex64)
                mix_pos += len(buf)
            for payload in rx.push(buf):
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


def _wideband(args, cfg, conv, dtype, width) -> int:
    """--channels N: the stream read chunk by chunk (`--chunk-seconds` of
    the band), each chunk pushed through the streaming wideband receiver
    (`rx.pipeline.WidebandReceiver`: the channelizer and the channels'
    demod on the device, a UW FSM a channel and one decode batch on the
    host); cu8 bytes go to the device as they are and are converted in
    the channelizer kernel, other formats are converted on the host;
    payloads routed in channel order one chunk after the chunk that
    completes them (the receiver is pipelined), the last at the end."""
    from ..rx.pipeline import WidebandReceiver
    from ..rx.router import PacketRouter, UDPEmitter

    native = args.format == "cu8"
    sel = ([int(k) for k in args.channel_select.split(",")]
           if args.channel_select else None)
    rx = WidebandReceiver(mode=args.mode, n_channels=args.channels,
                          channels=sel, cfg=cfg,
                          input_format="cu8" if native else "c64",
                          device=args.device)
    router = PacketRouter(image_dir=args.image_dir, log_dir=args.log_dir,
                          partial_update=args.partialupdate,
                          headless=args.headless,
                          emitter=UDPEmitter(enabled=not args.no_udp))
    chunk_bytes = (int(cfg.Fs * args.channels * args.chunk_seconds) * width
                   * np.dtype(dtype).itemsize)
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    n = n_samp = 0
    t0 = time.time()
    try:
        for raw in _chunk_reader(fin, chunk_bytes):
            buf = np.frombuffer(raw, dtype=dtype)
            n_samp += len(buf) // width
            for _, payload in rx.push(buf if native else conv(buf)):
                router.handle_packet(payload)
                n += 1
    finally:
        for _, payload in rx.flush():
            router.handle_packet(payload)
            n += 1
        router.flush()
        if fin is not sys.stdin.buffer:
            fin.close()
    dt = time.time() - t0
    # samples at the full wideband rate Fs_total = cfg.Fs * channels
    print(f"wideband: {args.channels} channels, {n} packets, "
          f"images={router.images_decoded} wall={dt:.2f}s "
          f"({n_samp / max(dt, 1e-9) / 1e6:.2f} Msamp/s)",
          file=sys.stderr)
    return 0


def _fused(args, cfg, conv, dtype, width) -> int:
    """--parallel / --slabs: the whole capture through the fused step, cu8
    and cs16 bytes converted on the device."""
    from ..rx.pipeline import decode_iq_fused, decode_iq_fused_overlap
    from ..rx.router import PacketRouter, UDPEmitter

    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    buf = np.frombuffer(fin.read(), dtype=dtype)
    if fin is not sys.stdin.buffer:
        fin.close()
    native = args.format in ("cu8", "cs16")
    data = buf if native else conv(buf)
    fmt = args.format if native else "c64"
    router = PacketRouter(image_dir=args.image_dir, log_dir=args.log_dir,
                          partial_update=args.partialupdate,
                          headless=args.headless,
                          emitter=UDPEmitter(enabled=not args.no_udp))
    t0 = time.time()
    if args.slabs > 1:
        payloads = decode_iq_fused_overlap(
            data, mode=args.mode, cfg=cfg, n_slabs=args.slabs,
            chunks_per_slab=max(args.parallel // args.slabs, 1),
            input_format=fmt, device=args.device)
    else:
        payloads = decode_iq_fused(data, mode=args.mode, cfg=cfg,
                                   n_chunks=args.parallel, input_format=fmt,
                                   device=args.device)
    for payload in payloads:
        router.handle_packet(payload)
    router.flush()
    dt = time.time() - t0
    n_samp = len(buf) // width
    print(f"parallel x{args.parallel}: samples={n_samp} "
          f"crc_ok={len(payloads)} images={router.images_decoded} "
          f"wall={dt:.2f}s ({n_samp / max(dt, 1e-9) / 1e6:.2f} Msamp/s) "
          f"device={args.device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
