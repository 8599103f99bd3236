"""Shift/resample robustness table at the flight rates through the port's
Receiver (counterpart of tools/robustness_table.py, with its points,
packets and seeds).

Each point resamples (baud-rate error) or frequency-shifts an 8-packet
capture built as the JAX tool builds it, adds AWGN after the impairment,
counts the payloads the port's `Receiver` recovers, and holds the table to
the JAX package's golden `tests/golden/robustness_{mode}.json`: +-2
packets a point, and the reference's envelope (0.3 % baud error and
+-Rs/2 shifts cost at most one packet, 0.6 % decodes at most one).

    python -m wenet_tpu_torch.tools.robustness_table [--modes v1,v2]
        [--device cpu]

exits non-zero on a violation (the card by default).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import load_golden

PACKETS = 8
SEED_BASE = 9100

# baud-error grid (0.997 proves the elastic nin tracks both signs) x Eb/N0
# above / near the cliff
RESAMPLE_POINTS = [(0.997, 14.0), (1.003, 14.0), (1.004, 14.0),
                   (1.005, 14.0), (1.006, 14.0),
                   (1.003, 10.0), (1.005, 10.0)]
# frequency-shift grid in units of Rs: +-Rs/2 and +-Rs
SHIFT_POINTS = [(-1.0, 12.0), (-0.5, 12.0), (0.5, 12.0), (1.0, 12.0)]
# (kind, value, Eb/N0): at least n - 1 packets; at most 1
ENVELOPE_GOOD = [("resample", 1.003, 14.0), ("resample", 0.997, 14.0),
                 ("shift", -0.5, 12.0), ("shift", 0.5, 12.0)]
ENVELOPE_FAIL = [("resample", 1.006, 14.0)]


def make_flight_capture(cfg, mode, n_packets, rng, ebno_db=None):
    """The clean capture of tools/robustness_table.py: (complex64 signal,
    payloads); noise is added after the impairment."""
    from ..core import framing
    from ..ops import fsk, ldpc
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
    return sig.astype(np.complex64), payloads


def impaired_capture(cfg, mode, kind: str, i: int, value: float,
                     ebno: float):
    """The capture of point i of `kind`: (complex64 iq, payloads)."""
    from ..ops import channel
    seed = SEED_BASE + i if kind == "resample" else SEED_BASE + 50 + i
    rng = np.random.default_rng(seed)
    sig, payloads = make_flight_capture(cfg, mode, PACKETS, rng)
    if kind == "resample":
        iq = channel.resample_linear(sig, value)
    else:
        iq = channel.freq_shift(sig, value * cfg.Rs, cfg.Fs)
    return channel.add_awgn(iq, ebno, cfg.Fs, cfg.Rs, rng=rng), payloads


def points():
    """[(kind, index within its kind, value, Eb/N0)] in the table's order."""
    return ([("resample", i, r, e) for i, (r, e) in enumerate(RESAMPLE_POINTS)]
            + [("shift", i, s, e) for i, (s, e) in enumerate(SHIFT_POINTS)])


def sweep(mode: str, log=lambda *a: None, device="cuda"):
    """The table: packets recovered by a Receiver on `device` (the card
    unless the caller names another) at every point."""
    from ..ops import fsk
    from ..rx.pipeline import Receiver

    cfg = fsk.V1_CONFIG if mode == "v1" else fsk.V2_CONFIG
    rows = []
    for kind, i, value, ebno in points():
        iq, payloads = impaired_capture(cfg, mode, kind, i, value, ebno)
        t0 = time.time()
        got = Receiver(mode=mode, cfg=cfg, device=device).decode_iq(iq)
        ok = sum(1 for p in got if p in payloads)
        rows.append({"kind": kind, "value": value, "ebno_db": ebno,
                     "packets_ok": ok,
                     "runtime_s": round(time.time() - t0, 2)})
        log(f"  {mode} {kind} {value} @ {ebno} dB: {ok}/{PACKETS}")
    return {"mode": mode, "Fs": cfg.Fs, "Rs": cfg.Rs, "packets": PACKETS,
            "seed_base": SEED_BASE, "rows": rows}


def violations(table: dict, golden: dict) -> list:
    """Where `table` breaks the golden's bounds: other points, a point more
    than 2 packets off the golden's, or the envelope broken."""
    n = golden["packets"]
    key = [(r["kind"], r["value"], r["ebno_db"]) for r in table["rows"]]
    if table["packets"] != n or key != [
            (r["kind"], r["value"], r["ebno_db"]) for r in golden["rows"]]:
        return ["the table's points differ from the golden's"]
    out = []
    for new, old in zip(table["rows"], golden["rows"]):
        if abs(new["packets_ok"] - old["packets_ok"]) > 2:
            out.append(f"{new['kind']} {new['value']} @ {new['ebno_db']} dB:"
                       f" {new['packets_ok']} packets against the golden "
                       f"{old['packets_ok']}")
    by = {k: r["packets_ok"] for k, r in zip(key, table["rows"])}
    out += [f"{k}: {by[k]}/{n} packets" for k in ENVELOPE_GOOD
            if by[k] < n - 1]
    out += [f"{k}: {by[k]} packets past the envelope" for k in ENVELOPE_FAIL
            if by[k] > 1]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="v1,v2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rc = 0
    for mode in args.modes.split(","):
        bad = violations(sweep(mode, print, args.device),
                         load_golden(f"robustness_{mode}"))
        for b in bad:
            print(f"REGRESSION {mode} {b}")
        rc |= bool(bad)
    return rc


if __name__ == "__main__":
    sys.exit(main())
