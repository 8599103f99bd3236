"""Split the fused step's time into its demod and its deframe on the card
(counterpart of tools/fused_profile.py), on the v2 ingest capture
(`captures.stream_capture`) already on the device, at --chunks chunks:

  (a) demod_only  the demod kernel on the chunks as lanes, invalid and
                  warm-up frames blanked (the soft bits the deframe takes)
  (c) topk_only   the step's deframe half alone on those soft bits
                  (top-k acquisition, one BP batch, the CRC; packed rows)
  (b) full_chain  the whole fused step (`rx.pipeline._FusedStep`)

and first the capture's copy to the device (`h2d`).  The JAX tool's scan
unroll and frames-per-step variants and its --bisect ablations of the XLA
demod step tune XLA's program and have no counterpart: the demod is one
kernel.  Each timed region ends with `torch.cuda.synchronize()` and a
one-element copy to the host.

    python -m wenet_tpu_torch.tools.fused_profile [--chunks 32] [--reps 2]
        [--secs 95] [--device cpu] [--out PATH]

prints one JSON record a stage.
"""
from __future__ import annotations

import argparse
import sys
import time

from ..device import resolve_device
from . import emitter, fetch, time_call


def run(chunks: int = 32, reps: int = 2, secs: float = 95.0, device="cuda",
        emit=None) -> list:
    """The h2d record and the three stage records, in the tool's order."""
    from .captures import stream_capture
    from .fused_where import Fused
    dev = resolve_device(device)
    raw, _ = stream_capture(secs)
    t0 = time.perf_counter()
    f = Fused(raw, chunks, dev)
    fetch(f.data)
    recs = [{"stage": "h2d", "h2d_s": round(time.perf_counter() - t0, 4),
             "chunks": chunks}]
    soft = None

    def demod_only():
        nonlocal soft
        soft = f.soft()
        return soft
    for label, fn in (("demod_only", demod_only),
                      ("topk_only", lambda: f.step.topk(soft)),
                      ("full_chain", f.chain)):
        first, dt, _ = time_call(fn, reps)
        recs.append({"stage": label, "first_s": round(first, 3),
                     "exec_s": round(dt, 6), "msps": round(f.n / dt / 1e6, 2),
                     "chunks": chunks, "k": f.k})
    for rec in recs if emit is not None else ():
        emit(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--secs", type=float, default=95.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(args.chunks, args.reps, args.secs, dev,
        emitter(dev, args.out, lambda s: print(s, flush=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
