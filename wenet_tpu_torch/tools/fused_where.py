"""Where the fused receive step's time goes on the card (counterpart of
tools/fused_where.py), on the v2 ingest capture (`captures.stream_capture`)
already on the device, cut into --chunks chunks by the fused paths'
geometry (`rx.pipeline._fused_geometry`):

  where_ingest  the cu8 samples of every chunk gathered and converted to
                complex64 (sum of |z|); the demod kernel does this in its
                load, the plain version as here
  where_demod   the demod kernel on the chunks as lanes, warm-up frames
                blanked (sum of soft)
  where_chain   the whole fused step (`rx.pipeline._FusedStep`: + top-k
                acquisition, one BP batch, the CRC; packed rows)

Each timed region ends with `torch.cuda.synchronize()` and a one-element
copy to the host.

    python -m wenet_tpu_torch.tools.fused_where [--chunks 32] [--reps 2]
        [--secs 95] [--device cpu] [--out PATH]

prints one JSON record a stage.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from . import emitter, time_call


class Fused:
    """The v2 fused step of one chunk count on a cu8 capture on the
    device, with the fused paths' defaults (8 warm-up frames, 10 BP
    iterations): the step (`_FusedStep`), the raw pairs `data`, the
    warm-up frames to blank `skips`, and n samples."""

    def __init__(self, raw, chunks: int, device, cfg=None):
        from ..rx import pipeline as P
        self.cfg = cfg = P.MODE_CONFIGS["v2"] if cfg is None else cfg
        data, self.n, self.fmt = P._normalize_fused_input(raw, "cu8")
        self.syms_pp, self.chunk_len, self.starts, skips = \
            P._fused_geometry(cfg, "v2", self.n, chunks, 8)
        self.k = P._k_default(self.chunk_len, cfg, self.syms_pp)
        self.step = P._FusedStep(cfg, "v2", self.fmt, self.chunk_len,
                                 self.starts, self.k, 10, device)
        self.data = P._host_tensor(data).to(device)
        self.skips = self.step.lanes(skips)

    def iq(self) -> torch.Tensor:
        """(C, chunk_len) complex64: each chunk's samples, 0.0 past the
        capture."""
        from ..ops import fsk
        z = fsk.to_iq(self.data, self.fmt)
        idx = self.step.starts[:, None] + torch.arange(
            self.chunk_len, device=z.device)
        padded = torch.cat([z, z.new_zeros(1)])
        return padded[torch.where(idx < self.n, idx, self.n)]

    def soft(self) -> torch.Tensor:
        """(C, nf * Nbits) soft bits of the demod kernel, invalid and
        warm-up frames blanked, as the step hands them on."""
        return self.step.soft(self.data, self.skips)

    def chain(self) -> torch.Tensor:
        return self.step(self.data, self.skips)


def run(chunks: int = 32, reps: int = 2, secs: float = 95.0, device="cuda",
        emit=None) -> list:
    """The three stage records."""
    from .captures import stream_capture
    dev = resolve_device(device)
    raw, _ = stream_capture(secs)
    f = Fused(raw, chunks, dev)
    recs = []
    for label, fn, extra in (
            ("where_ingest", lambda: torch.sum(torch.abs(f.iq())), {}),
            ("where_demod", lambda: torch.sum(f.soft()), {}),
            ("where_chain", f.chain, {"k": f.k})):
        first, dt, _ = time_call(fn, reps)
        recs.append({"stage": label, "first_s": round(first, 3),
                     "exec_s": round(dt, 6), "msps": round(f.n / dt / 1e6, 2),
                     "chunks": chunks, **extra})
        if emit is not None:
            emit(recs[-1])
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
