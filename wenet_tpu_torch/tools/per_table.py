"""PER-vs-Eb/N0 table at the flight rates through the port's Receiver
(counterpart of tools/per_table.py, with its grid, packets and seeds).

Sweeps the reference's Eb/N0 grid at the real flight rates (v1
Fs=921416/Rs=115177 RS232 framing, v2 Fs=960000/Rs=96000) on 12-packet
captures built as the JAX tool builds them (byte-equal cu8), counts the
payloads the port's `Receiver` recovers, and holds the table to the JAX
package's golden `tests/golden/per_table_{mode}.json`: +-2 packets a row,
no packet at 5.0-6.0 dB, at most one lost at 8.5 dB and above.

    python -m wenet_tpu_torch.tools.per_table [--modes v1,v2] [--device cpu]

exits non-zero on a violation (the card by default).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import load_golden

GRID = [round(x, 1) for x in np.arange(5.0, 15.01, 0.5)]
PACKETS = 12
SEED_BASE = 7000          # the JAX tool's seeds: SEED_BASE + 10 * Eb/N0
FLOOR_DB = (5.0, 5.5, 6.0)       # no packet below the cliff
ABOVE_CLIFF_DB = 8.5             # at most one packet lost from here up


def make_flight_capture(cfg, mode, n_packets, rng, ebno_db):
    """n_packets random payloads framed, with random idle bits between
    them, FSK-modulated, AWGN at ebno_db -> (cu8 bytes, payloads); the
    construction of tools/per_table.py."""
    from ..core import framing
    from ..ops import channel, fsk, ldpc
    payloads, bits = [], [rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)]
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode=mode)
        bits.append(framing.frame_to_bits(frame, mode))
        bits.append(rng.integers(0, 2, 512).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno_db, cfg.Fs, cfg.Rs,
                          rng=rng)
    return fsk.iq_to_cu8(iq), payloads


def sweep(mode: str, log=lambda *a: None, device="cuda", grid=GRID):
    """The table at each Eb/N0 of `grid` (default: the whole grid):
    packets recovered by a Receiver on `device` (the card unless the
    caller names another)."""
    from ..ops import fsk
    from ..rx.pipeline import Receiver

    cfg = fsk.V1_CONFIG if mode == "v1" else fsk.V2_CONFIG
    rows = []
    for ebno in grid:
        rng = np.random.default_rng(SEED_BASE + int(ebno * 10))
        raw, payloads = make_flight_capture(cfg, mode, PACKETS, rng, ebno)
        rx = Receiver(mode=mode, cfg=cfg, device=device)
        t0 = time.time()
        got = rx.decode_iq(fsk.iq_from_cu8(raw))
        ok = sum(1 for p in got if p in payloads)
        rows.append({"ebno_db": ebno, "packets_ok": ok,
                     "bytes_ok": 256 * ok, "runtime_s": round(
                         time.time() - t0, 2)})
        log(f"  {mode} {ebno:5.1f} dB: {ok:2d}/{PACKETS} packets")
    return {"mode": mode, "Fs": cfg.Fs, "Rs": cfg.Rs, "packets": PACKETS,
            "seed_base": SEED_BASE, "grid": list(grid), "rows": rows}


def violations(table: dict, golden: dict) -> list:
    """Where `table` breaks the golden's bounds: a row more than 2 packets
    off the golden's at the same Eb/N0, a packet on the floor, or more than
    one lost at or above ABOVE_CLIFF_DB.  Rows the table lacks are not
    held."""
    want = {r["ebno_db"]: r["packets_ok"] for r in golden["rows"]}
    n = golden["packets"]
    out = [] if table["packets"] == n else [f"packets {table['packets']}"]
    for r in table["rows"]:
        e, ok = r["ebno_db"], r["packets_ok"]
        if e not in want:
            out.append(f"{e} dB is not in the golden grid")
        elif abs(ok - want[e]) > 2:
            out.append(f"{e} dB: {ok} packets against the golden {want[e]}")
        if e in FLOOR_DB and ok:
            out.append(f"{e} dB: {ok} packets on the floor")
        if e >= ABOVE_CLIFF_DB and ok < n - 1:
            out.append(f"{e} dB: {ok}/{n} packets above the cliff")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="v1,v2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = 0
    for mode in args.modes.split(","):
        bad = violations(sweep(mode, print, args.device),
                         load_golden(f"per_table_{mode}"))
        for b in bad:
            print(f"REGRESSION {mode} {b}")
        rc |= bool(bad)
    return rc


if __name__ == "__main__":
    sys.exit(main())
