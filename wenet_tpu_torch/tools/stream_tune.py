"""Sweep the fused ingest configurations on the card (counterpart of
tools/stream_tune.py), on the v2 ingest capture (`captures.stream_capture`,
--secs seconds at the flight rate).

For each --fused chunk count: the program rate of one fused step
(`rx.pipeline._FusedStep`) on the capture already on the device, then the
ingest rate of `rx.pipeline.decode_iq_fused` from the host's cu8 bytes.
For each --overlap SLABSxCPS: the ingest rate of
`rx.pipeline.decode_iq_fused_overlap` (slabs in flight on streams of
their own).  Every timed region ends with the packed results' copy to the
host.  --compile-only builds the kernels and times each first call only.

    python -m wenet_tpu_torch.tools.stream_tune [--secs 95]
        [--fused 16,32,64] [--overlap 4x16,4x8,2x32] [--reps 2]
        [--compile-only] [--device cpu] [--out PATH]

prints one JSON record a configuration and rate.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..device import resolve_device
from . import emitter


def tune(raw, n_packets: int, fused_list=(16, 32, 64),
         ov_list=((4, 16), (4, 8), (2, 32)), reps: int = 2,
         compile_only: bool = False, device="cuda", emit=None,
         cfg=None) -> dict:
    """Run the grid on the v2 cu8 capture raw (at cfg's rates, default the
    flight geometry); emit receives each record.
    Returns {config: payloads} of each run: 'fused{C}_devres' (the
    program on the device), 'fused{C}_ingest' and 'overlap{S}x{P}_ingest'
    (the last call's list)."""
    from ..rx import pipeline as P
    from .fused_where import Fused
    dev = resolve_device(device)
    cfg = P.MODE_CONFIGS["v2"] if cfg is None else cfg
    n_samples = len(raw) // 2
    emit = emit or (lambda rec: rec)
    lists = {}

    for nc in fused_list:
        t0 = time.perf_counter()
        f = Fused(raw, nc, dev, cfg)
        f.data[-1:].cpu()                    # the copy has landed
        h2d_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        packed = f.chain().cpu()
        first_s = time.perf_counter() - t0
        rec = {"config": f"fused{nc}_devres", "h2d_s": round(h2d_s, 4),
               "first_call_s": round(first_s, 4)}
        if not compile_only:
            t0 = time.perf_counter()
            for _ in range(reps):
                packed = f.chain().cpu()
            dt = (time.perf_counter() - t0) / reps
            rec.update(program_msps=round(f.n / dt / 1e6, 2),
                       program_realtime_x=round(f.n / dt / cfg.Fs, 1))
        lists[rec["config"]] = P._dedup_payloads(
            P._unpack_fused(packed.numpy(), f.starts, cfg), f.syms_pp)
        rec.update(packets_ok=len(lists[rec["config"]]),
                   packets_expected=n_packets)
        emit(rec)
        if compile_only:
            continue
        t0 = time.perf_counter()
        pk = P.decode_iq_fused(raw, "v2", cfg, n_chunks=nc,
                               input_format="cu8", device=dev)
        dt = time.perf_counter() - t0
        lists[f"fused{nc}_ingest"] = pk
        emit({"config": f"fused{nc}_ingest",
              "ingest_msps": round(n_samples / dt / 1e6, 2),
              "ingest_realtime_x": round(n_samples / dt / cfg.Fs, 1),
              "packets_ok": len(pk), "packets_expected": n_packets})

    for ns, cps in ov_list:
        def overlap():
            return P.decode_iq_fused_overlap(
                raw, "v2", cfg, n_slabs=ns, chunks_per_slab=cps,
                input_format="cu8", device=dev)
        t0 = time.perf_counter()
        pk = overlap()
        first_s = time.perf_counter() - t0
        rec = {"config": f"overlap{ns}x{cps}_ingest",
               "first_call_s": round(first_s, 4)}
        if not compile_only:
            t0 = time.perf_counter()
            for _ in range(reps):
                pk = overlap()
            dt = (time.perf_counter() - t0) / reps
            rec.update(ingest_msps=round(n_samples / dt / 1e6, 2),
                       ingest_realtime_x=round(n_samples / dt / cfg.Fs, 1))
        lists[rec["config"]] = pk
        rec.update(packets_ok=len(pk), packets_expected=n_packets)
        emit(rec)
    return lists


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--secs", type=float, default=95.0)
    ap.add_argument("--fused", default="16,32,64",
                    help="comma list of n_chunks for decode_iq_fused")
    ap.add_argument("--overlap", default="4x16,4x8,2x32",
                    help="comma list of SLABSxCPS for decode_iq_fused_overlap")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from ..ops import fsk
    from .captures import stream_capture
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    raw, n_packets = stream_capture(args.secs)
    print(f"capture ready ({time.perf_counter() - t0:.1f}s, "
          f"{len(raw) // 2 / fsk.V2_CONFIG.Fs:.1f}s, {n_packets} packets)",
          file=sys.stderr, flush=True)
    tune(raw, n_packets, [int(x) for x in args.fused.split(",") if x],
         [tuple(int(v) for v in x.split("x"))
          for x in args.overlap.split(",") if x],
         args.reps, args.compile_only, dev,
         emitter(dev, args.out, lambda s: print(s, flush=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
