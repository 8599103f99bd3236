"""The comparisons that decide `correct`: the payloads against those the
generator framed, and the demod's frames against the plain reference's.

Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from benchmark import reference, traffic


def looped_samples(rec, g0: int, g1: int) -> np.ndarray:
    """Complex samples [g0, g1) of the recording replayed end to end in a
    loop from sample 0; zero before sample 0."""
    g = np.arange(g0, g1)
    x = np.zeros(len(g), np.complex128)
    ok = g >= 0
    idx = g[ok] % rec.n_samples
    raw = rec.raw.reshape(-1, 2)[idx].reshape(-1)
    x[ok] = traffic.cu8_to_complex(raw)
    return x


def match_stream(payloads: list, ends: np.ndarray, n_samples: int,
                 delivered: list, lo: int, hi: int) -> dict:
    """The looped recording's packets against what the receiver delivered,
    in order: each delivery is taken as the next packet of the stream with
    its bytes (a delivery that repeats a packet, or comes out of order,
    skips ahead a pass); the attempted packets are those whose last sample
    was handed over in [lo, hi); failed counts those not delivered, plus
    deliveries that match no packet."""
    P = len(payloads)
    index = {p: i for i, p in enumerate(payloads)}
    matched, spurious, g = set(), 0, 0
    for d in delivered:
        i = index.get(d)
        if i is None:
            spurious += 1
            continue
        g += (i - g) % P
        matched.add(g)
        g += 1
    attempted, lost = 0, []
    for rep in range(lo // n_samples, hi // n_samples + 1):
        last = rep * n_samples + ends - 1
        for i in np.flatnonzero((last >= lo) & (last < hi)):
            attempted += 1
            if rep * P + int(i) not in matched:
                lost.append(rep * P + int(i))
    return {"attempted": attempted, "failed": len(lost) + spurious,
            "lost": lost[:50], "spurious": spurious}


def match_list(payloads: list, delivered: list) -> tuple:
    """(lost, spurious) of one whole-recording decode: the packets in
    order, each exactly once."""
    index = {p: i for i, p in enumerate(payloads)}
    matched, spurious, nxt = 0, 0, 0
    for d in delivered:
        i = index.get(d)
        if i is None or i < nxt:
            spurious += 1
            continue
        matched += 1
        nxt = i + 1
    return len(payloads) - matched, spurious


def valid_frames(outs: dict, lane: int) -> dict:
    """One lane's valid frames of a demod call, from its host arrays."""
    v = outs["valid"][lane]
    return {"soft": outs["soft"][lane][v].astype(np.float64),
            "nin": outs["nin"][lane][v].astype(np.int64),
            "f_est": outs["f_est"][lane][v].astype(np.float64)}


def run_reference(geo, lanes: list, precision: str) -> list:
    """The reference over the lanes side by side."""
    if not lanes:
        return []
    W = max(len(l["X"]) for l in lanes)
    X = np.zeros((len(lanes), W), np.complex128)
    for i, l in enumerate(lanes):
        X[i, : len(l["X"])] = l["X"]
    shapes = {k: v.shape for k, v in reference.initial_state(geo, 1).items()}
    state = {k: np.concatenate([np.reshape(l["state"][k], shape)
                                for l in lanes])
             for k, shape in shapes.items()}
    return reference.demodulate(geo, X, np.array([l["pos"] for l in lanes]),
                                state, [l["horizons"] for l in lanes],
                                precision)


def compare_lanes(geo, lanes: list, got: list, control: bool) -> dict:
    """Frames of each lane and horizon against the reference's: frames
    that differ in count, nin or tone estimates, and the widest soft gap
    as a share of the mean |soft| of the reference's frames.  control:
    the reference at its control precision stands in for `got`."""
    ref = run_reference(geo, lanes, "float64")
    if control:
        got = run_reference(geo, lanes, "tf32")
    differ, compared, worst, total = 0, 0, 0.0, 0.0
    for ref_lane, got_lane in zip(ref, got):
        for r, g in zip(ref_lane, got_lane):
            n = min(len(r["nin"]), len(g["nin"]))
            differ += abs(len(r["nin"]) - len(g["nin"]))
            differ += int(((r["nin"][:n] != g["nin"][:n])
                           | (r["f_est"][:n] != g["f_est"][:n]).any(-1)).sum())
            if n:
                gap = np.abs(r["soft"][:n] - g["soft"][:n]).max()
                worst = max(worst, float(gap))
                total += float(np.abs(r["soft"][:n]).sum())
                compared += n
    mean = total / (compared * geo.Nbits) if compared else 0.0
    return {"soft_gap": worst / mean if mean > 0 else float("inf"),
            "frames_differ": differ, "frames_compared": compared}
