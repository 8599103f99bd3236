"""Normalized min-sum decoder scaling against batch size B, with the
iteration histogram, on the card (counterpart of tools/minsum_scaling.py).

Sweeps B for `ops.ldpc.decode_minsum` (the BP kernel's min-sum variant)
and, for comparison, the sum-product `ops.ldpc.decode`, on near-threshold
LLRs (random codewords, BPSK at an Es/N0 of 0.8 x Eb/N0, from numpy
`default_rng(1)` drawn batch after batch, then `sd_to_llr` on the
device).  Every timed region ends with `torch.cuda.synchronize()` and a
copy of `bits[:1]` to the host.

    python -m wenet_tpu_torch.tools.minsum_scaling
        [--batches 128,512,2048,8192] [--reps 3] [--ebno_db 7.5]
        [--device cpu] [--out PATH]

prints one JSON record a decoder and B.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import emitter, time_call

MAX_ITER = 10


def llr_batch(B: int, ebno_db: float, rng, device) -> torch.Tensor:
    """(B, 2580) float32 LLRs of B random codewords at ebno_db on
    `device`, the next draws of rng."""
    from ..ops import ldpc
    esn0 = 10 ** (ebno_db / 10.0) * 0.8        # rate-adjusted Es/N0
    ib = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8),
                       axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return ldpc.sd_to_llr(torch.as_tensor(sd.astype(np.float32),
                                          device=device))


def decoders():
    """(record name, decoder) in the tool's order."""
    from ..ops import ldpc
    return (("minsum", ldpc.decode_minsum), ("sumproduct", ldpc.decode))


def iter_hist(iters) -> list:
    """Codewords per iteration count 0..MAX_ITER."""
    it = np.asarray(iters.cpu() if isinstance(iters, torch.Tensor)
                    else iters)
    return np.bincount(np.clip(it, 0, MAX_ITER),
                       minlength=MAX_ITER + 1).tolist()


def measure(name: str, fn, llr: torch.Tensor, reps: int = 3,
            ebno_db: float = 7.5) -> dict:
    """One decoder at one B: the first call alone, then `reps` calls, each
    region ended by the fetch of bits[:1] (`time_call`) -> the record."""
    B = llr.shape[0]
    first, dt, (_, iters, ok) = time_call(lambda: fn(llr), reps)
    return {"decoder": name, "B": B,
            "codewords_per_s": round(B / dt, 0),
            "mbit_per_s": round(B * 2064 / dt / 1e6, 1),
            "first_s": round(first, 3), "exec_s": round(dt, 6),
            "ebno_db": ebno_db,
            "parity_ok_frac": round(float(ok.float().mean()), 3),
            "iter_hist": iter_hist(iters)}


def run(batches=(128, 512, 2048, 8192), reps: int = 3, ebno_db: float = 7.5,
        device="cuda", emit=None) -> list:
    """Every (B, decoder) record, in the tool's order; emit, if given,
    receives each as it is made."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    recs = []
    for B in batches:
        llr = llr_batch(B, ebno_db, rng, dev)
        for name, fn in decoders():
            recs.append(measure(name, fn, llr, reps, ebno_db))
            if emit is not None:
                emit(recs[-1])
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="128,512,2048,8192")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ebno_db", type=float, default=7.5,
                    help="near-threshold operating point (iteration churn)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run([int(b) for b in args.batches.split(",")], args.reps, args.ebno_db,
        dev, emitter(dev, args.out, lambda s: print(s, flush=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
