"""Where the fused wideband call's time goes on the card (counterpart of
tools/wideband_where.py): the N-channel capture of `wideband_scaling`,
on the device, through three prefixes of the fused path of
`ops.channelizer.demod_multichannel`:

  chanz_only   the channelizer kernel (sum of |channel samples|)
  chanz_demod  + the demod kernel on the channels as lanes (sum of soft)
  full         + top-k acquisition, one BP batch and the CRC (packed rows)

Each timed region ends with `torch.cuda.synchronize()` and a one-element
copy to the host.

    python -m wenet_tpu_torch.tools.wideband_where [N] [--reps 2]
        [--device cpu] [--out PATH]

prints one JSON record a stage.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from . import emitter, time_call


def stages(cfg, nch: int):
    """(name, fn of the (n, 2) float32 pairs on the device) of each
    prefix of demod_multichannel(..., fused=True) in v2, through its own
    stage functions."""
    from ..ops import channelizer

    def chanz(x):
        return channelizer.channelize_pairs(x, nch, channels=range(nch))

    def demod(x):
        return channelizer.demod_channels(cfg, chanz(x), nch)

    def full(x):
        nf, outs = demod(x)
        return channelizer.fused_deframe(cfg, outs, nf)[1]

    return (("chanz_only", lambda x: torch.sum(torch.abs(chanz(x)))),
            ("chanz_demod", lambda x: torch.sum(demod(x)[1].soft)),
            ("full", full))


def run(nch: int = 16, reps: int = 2, device="cuda", emit=None) -> list:
    """The three stage records on the N-channel capture."""
    from ..ops import channelizer, fsk
    from .wideband_scaling import build_wideband_capture
    cfg = fsk.V2_CONFIG
    dev = resolve_device(device)
    wide, _ = build_wideband_capture(nch, cfg)
    x = channelizer._device_input(wide, dev)
    recs = []
    for label, fn in stages(cfg, nch):
        first, dt, _ = time_call(lambda: fn(x), reps)
        recs.append({"stage": label, "nch": nch, "first_s": round(first, 3),
                     "exec_s": round(dt, 6),
                     "msps": round(len(wide) / dt / 1e6, 1)})
        if emit is not None:
            emit(recs[-1])
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nch", nargs="?", type=int, default=16)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(args.nch, args.reps, dev,
        emitter(dev, args.out, lambda s: print(s, flush=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
