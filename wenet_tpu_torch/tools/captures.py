"""Capture builders of the measurement tools: jax-free copies of the
bench capture functions of `bench.py` (`LEAD_BITS`, `make_packet_bits`,
`decodable_packets`, `stream_capture`), giving byte-equal bits and cu8.

`stream_capture` keeps its atomic disk cache, keyed by a hash of every
input to the bytes (rates, Eb/N0, seed and the generators' sources), under
`build/wenet_tpu_torch/` of the checkout.
"""
from __future__ import annotations

import hashlib
import inspect
import os

import numpy as np

LEAD_BITS = 2048     # stream lead-in before the first frame
FRAME_BITS_V2 = 343 * 8
PKT_CYCLE_V2 = FRAME_BITS_V2 + 512           # frame + gap bits

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "wenet_tpu_torch")


def make_packet_bits(cfg, n_packets, rng, gap_bits=512, lead_bits=LEAD_BITS,
                     mode="v2", lead_last=False):
    """Framed random packets with noise-bit gaps, padded to whole frames,
    after `lead_bits` of random filler (a capture that starts with a frame
    at sample 0 loses it to the estimator's warm-up).  lead_last: the
    filler is drawn from rng after the packets (the wideband capture's
    order), though it still comes first in the stream."""
    from ..core import framing
    from ..ops import ldpc

    def filler():
        return rng.integers(0, 2, lead_bits).astype(np.uint8)
    lead = None if lead_last else filler()
    frames_bits = []
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode=mode)
        frames_bits.append(framing.frame_to_bits(frame, mode))
        frames_bits.append(rng.integers(0, 2, gap_bits).astype(np.uint8))
    bits = np.concatenate([filler() if lead_last else lead] + frames_bits)
    return np.concatenate(
        [bits, np.zeros((-len(bits)) % cfg.Nbits, np.uint8)])


def packet_payloads(n_packets, rng, gap_bits=512, lead_bits=LEAD_BITS):
    """The payloads `make_packet_bits` frames from the same generator
    state, in order (its draws replayed without framing or modulation)."""
    rng.integers(0, 2, lead_bits)
    out = []
    for _ in range(n_packets):
        out.append(rng.integers(0, 256, 256, dtype=np.uint8).tobytes())
        rng.integers(0, 2, gap_bits)
    return out


def decodable_packets(n_bits: int, n_packets: int,
                      lead_bits: int = LEAD_BITS) -> int:
    """Exact count of frames wholly inside the first n_bits of a
    make_packet_bits stream (frame i spans [lead + i*cycle,
    lead + i*cycle + FRAME_BITS))."""
    fit = (n_bits - lead_bits - FRAME_BITS_V2) // PKT_CYCLE_V2 + 1
    return max(0, min(n_packets, fit))


def _stream_packets(secs: float, cfg) -> int:
    n_bits = int(secs * cfg.Rs)
    return max((n_bits - LEAD_BITS) // PKT_CYCLE_V2 - 1, 1)


def stream_capture(secs: float, ebno_db: float = 12.0, seed: int = 3,
                   with_cache_flag: bool = False, cfg=None):
    """The deterministic v2 ingest capture at cfg's rates (default the
    flight geometry): (raw cu8 bytes, n_packets), or (raw, n_packets,
    was_cached) with with_cache_flag."""
    from ..ops import channel, fsk
    cfg = fsk.V2_CONFIG if cfg is None else cfg
    rng = np.random.default_rng(seed)
    n_packets = _stream_packets(secs, cfg)
    gen_fp = hashlib.sha1(
        (f"{ebno_db}_{LEAD_BITS}_" +
         inspect.getsource(make_packet_bits) +
         inspect.getsource(fsk.fsk_mod_np) +
         inspect.getsource(channel.add_awgn) +
         inspect.getsource(fsk.iq_to_cu8)).encode()).hexdigest()[:10]
    cap_path = os.path.join(
        CACHE_DIR,
        f"stream_cap_{int(secs)}s_{cfg.Fs}_{cfg.Rs}_seed{seed}_{gen_fp}.npy")
    if os.path.exists(cap_path):
        try:
            cap = np.load(cap_path)
            return (cap, n_packets, True) if with_cache_flag else (
                cap, n_packets)
        except Exception:
            pass
    bits = make_packet_bits(cfg, n_packets, rng)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno_db, cfg.Fs,
                          cfg.Rs, rng=rng)
    del sig
    raw = fsk.iq_to_cu8(iq / np.abs(iq).max())
    del iq
    save_atomic(cap_path, raw)
    return (raw, n_packets, False) if with_cache_flag else (raw, n_packets)


def stream_payloads(secs: float, seed: int = 3, cfg=None) -> list:
    """The payloads framed into `stream_capture(secs, seed=seed,
    cfg=cfg)`, in order."""
    from ..ops import fsk
    return packet_payloads(
        _stream_packets(secs, fsk.V2_CONFIG if cfg is None else cfg),
        np.random.default_rng(seed))


def save_atomic(path: str, array: np.ndarray):
    """np.save to a per-process file renamed into place, so a reader sees
    a whole file or none; a failure to write leaves no cache."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, array)
        os.replace(tmp, path)
    except OSError:
        pass
