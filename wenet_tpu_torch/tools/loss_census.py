"""Packet-loss census of the chain (counterpart of tools/loss_census.py).

B streams x R rounds of one v2 capture (`captures.make_packet_bits`: a
2048-bit lead-in, then 12 packets with 512-bit gaps), each with its own
AWGN at an Eb/N0 of linspace(--ebno-min, --ebno-max, B), through the whole
chain (`chain_scaling.chain_lanes`), keeping every pick's CRC flag and UW
position; then every lost packet is classified by its index in the
stream:

  - index 0            -> acquisition loss (estimator warm-up)
  - index n_packets-1  -> stream-boundary / flush loss
  - interior           -> a sensitivity miss
  - position -1 picks  -> top-k exhaustion (fewer placeable windows than k)

    python -m wenet_tpu_torch.tools.loss_census [--streams B] [--rounds R]
        [--ebno-min 10.5] [--ebno-max 15.0] [--k K] [--warmup-packets W]
        [--device cpu] [--out PATH]

prints one JSON record.
"""
from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import emitter
from .captures import LEAD_BITS, PKT_CYCLE_V2, make_packet_bits


def census(oks, poss, ebnos, n_packets: int, first: int = 0,
           lead: int = LEAD_BITS, pkt_cycle: int = PKT_CYCLE_V2) -> dict:
    """Classify the misses of (R, B, k) CRC flags and UW positions of
    streams whose Eb/N0 are ebnos (B,): which packet indices >= first of
    each (round, stream) no CRC-valid pick decoded (a pick at position p
    is packet round((p - lead) / pkt_cycle)); picks at -1 count as
    exhausted, CRC-valid picks of a packet already decoded as duplicates.
    The keys and rounding of tools/loss_census.py's record."""
    oks, poss = np.asarray(oks), np.asarray(poss)
    ebnos = np.asarray(ebnos)
    R, B, k = oks.shape
    miss_hist = collections.Counter()
    miss_by_ebno = collections.Counter()
    exhausted_picks = dup_picks = total_miss = 0
    for r in range(R):
        for b in range(B):
            ok, pos = oks[r, b], poss[r, b]
            got = set()
            for j in range(k):
                if pos[j] < 0:
                    exhausted_picks += 1
                    continue
                if ok[j]:
                    pi = int(round((pos[j] - lead) / pkt_cycle))
                    if pi in got:
                        dup_picks += 1
                    got.add(pi)
            for pi in range(first, n_packets):
                if pi not in got:
                    total_miss += 1
                    miss_hist[pi - first] += 1
                    miss_by_ebno[round(float(ebnos[b]), 1)] += 1
    n_census = n_packets - first
    sent = R * B * n_census
    return {
        "streams": B, "rounds": R, "k": k, "n_packets": n_census,
        "warmup_packets": first,
        "ebno_range": [float(ebnos.min()), float(ebnos.max())],
        "sent": sent, "ok": sent - total_miss,
        "loss_pct": round(100.0 * total_miss / sent, 3),
        "miss_by_packet_index": dict(sorted(miss_hist.items())),
        "miss_first_pct": round(100.0 * miss_hist[0] / max(total_miss, 1), 1),
        "miss_last_pct": round(
            100.0 * miss_hist[n_census - 1] / max(total_miss, 1), 1),
        "miss_interior": int(sum(v for i, v in miss_hist.items()
                                 if 0 < i < n_census - 1)),
        "exhausted_picks": exhausted_picks,
        "duplicate_position_picks": dup_picks,
        "miss_by_ebno": {str(k_): v for k_, v in
                         sorted(miss_by_ebno.items())},
    }


def census_signal(cfg, warmup_packets: int = 0):
    """The census capture: (complex64 samples, mean power, n_packets)."""
    from ..ops import fsk
    from .chain_scaling import signal_power
    n_packets = 12 + warmup_packets
    bits = make_packet_bits(cfg, n_packets, np.random.default_rng(0))
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    return sig, signal_power(sig), n_packets


def run(streams: int = 16, rounds: int = 4, ebno_min: float = 10.5,
        ebno_max: float = 15.0, k: int | None = None,
        warmup_packets: int = 0, cfg=None, device="cuda",
        noise=None) -> dict:
    """The census of `rounds` rounds of `streams` lanes; noise: (R, B, n)
    complex64, else drawn on the device from a generator seeded 1."""
    from ..ops import fsk
    from .chain_scaling import chain_lanes
    cfg = fsk.V2_CONFIG if cfg is None else cfg
    dev = resolve_device(device)
    sig, var, n_packets = census_signal(cfg, warmup_packets)
    k = k or n_packets
    ebnos = np.linspace(ebno_min, ebno_max, streams).astype(np.float32)
    sig_t = torch.as_tensor(sig, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    oks, poss = [], []
    for r in range(rounds):
        ok, pos = chain_lanes(cfg, sig_t, ebnos, k, generator=gen,
                              noise=None if noise is None else noise[r],
                              device=dev, var=var)
        oks.append(ok.cpu().numpy())
        poss.append(pos.cpu().numpy())
    out = census(np.stack(oks), np.stack(poss), ebnos, n_packets,
                 warmup_packets)
    out["ebno_range"] = [ebno_min, ebno_max]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--ebno-min", type=float, default=10.5)
    ap.add_argument("--ebno-max", type=float, default=15.0)
    ap.add_argument("--k", type=int, default=None,
                    help="deframe_topk k override (default: n_packets)")
    ap.add_argument("--warmup-packets", type=int, default=0,
                    help="prepend this many extra packets, excluded from "
                         "the census (acquisition guard experiment)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    emitter(dev, args.out, lambda s: print(s, flush=True))(run(
        args.streams, args.rounds, args.ebno_min, args.ebno_max, args.k,
        args.warmup_packets, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
