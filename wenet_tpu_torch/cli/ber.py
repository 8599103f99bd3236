"""Modem-only BER test (fsk_demod --testframes / tx_known_sequence.py
equivalent): a seeded PRBS frame is modulated, degraded, demodulated, and
correlated back against the known pattern — validating the modem without
any FEC/framing in the loop (fsk_demod.c:230-343).  Counterpart of
wenet_tpu/cli/ber.py; the demod runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

TEST_FRAME_SIZE = 100


def glibc_rand_bits(seed: int, n: int) -> np.ndarray:
    """rand()&1 sequence of glibc's TYPE_3 generator — the exact testframe
    fsk_demod -f builds with srand(158324) (fsk_demod.c:235-239), so
    parity tests can synthesize the capture its oracle expects."""
    r = [0] * 34
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * r[i - 1]) % 2147483647
    for i in range(31, 34):
        r[i] = r[i - 31]
    out = []
    for i in range(34, 344 + n):
        r.append((r[i - 3] + r[i - 31]) % (1 << 32))
        if i >= 344:
            out.append((r[-1] >> 1) & 1)
    return np.asarray(out, np.uint8)


def sliding_testframe_ber(rx_bits: np.ndarray, frame: np.ndarray):
    """The C counting semantics, vectorized (fsk_demod.c:304-343): a
    100-bit window slides over EVERY rx bit; each position whose window
    mismatches the known frame in <10% of bits counts as a detected
    testframe (bitcnt += 100, biterr += errs)."""
    n, f = len(rx_bits), len(frame)
    if n < f:
        return {"bits": 0, "errs": 0, "ber": 1.0, "sync_found": False}
    win = np.lib.stride_tricks.sliding_window_view(rx_bits, f)
    errs = (win != frame[None, :]).sum(axis=1)
    det = errs < 0.1 * f
    bits = int(det.sum()) * f
    berr = int(errs[det].sum())
    return {"bits": bits, "errs": berr, "ber": berr / max(bits, 1),
            "sync_found": bool(det.any()), "frames_synced": int(det.sum())}


def make_testframe_capture(cfg, ebno_db: float, seconds: float = 2.0,
                           seed: int = 158324, shift_hz: float = 0.0,
                           rng=None):
    """Synthesize the -f testframe capture: glibc-seeded PRBS frame tiled
    for `seconds`, modulated and AWGN-degraded.  Returns (iq, frame)."""
    from ..ops import channel, fsk

    rng = np.random.default_rng(0) if rng is None else rng
    frame = glibc_rand_bits(seed, TEST_FRAME_SIZE)
    n_frames = int(seconds * cfg.Rs / TEST_FRAME_SIZE)
    tx_bits = np.tile(frame, n_frames)
    pad = (-len(tx_bits)) % cfg.Nbits
    tx_bits = np.concatenate([tx_bits, np.zeros(pad, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, tx_bits, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno_db, cfg.Fs, cfg.Rs,
                          rng=rng)
    if shift_hz:
        iq = channel.freq_shift(iq, shift_hz, cfg.Fs)
    return iq, frame


def run_ber(cfg, ebno_db: float, seconds: float = 2.0, seed: int = 158324,
            shift_hz: float = 0.0, rng=None, iq=None, frame=None,
            device="cuda"):
    """Returns dict(bits, errs, ber, sync_found).  Pass a pre-built
    (iq, frame) pair to measure an existing capture (oracle parity).  The
    demod runs on `device` (CUDA unless the caller asks for another;
    raises without a card)."""
    from ..ops import fsk

    if iq is None or frame is None:
        iq, frame = make_testframe_capture(cfg, ebno_db, seconds, seed,
                                           shift_hz, rng)
    soft, outs, _ = fsk.demod_iq_np(cfg, iq, device=device)
    rx = (soft < 0).astype(np.uint8)
    # the C binary's sliding-window counting (re-syncs continuously, so a
    # mid-capture nin slip only loses the boundary frame, fsk_demod.c:304-343)
    return sliding_testframe_ber(rx, frame)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fs", type=int, default=96000)
    ap.add_argument("--rs", type=int, default=9600)
    ap.add_argument("--ebno", type=float, nargs="*", default=[6, 8, 10, 12])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--shift", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    from ..ops import fsk
    cfg = fsk.FSKConfig(Fs=args.fs, Rs=args.rs)
    print(f"{'Eb/N0':>6} | {'bits':>8} | {'errs':>6} | {'BER':>9}")
    for e in args.ebno:
        r = run_ber(cfg, e, args.seconds, shift_hz=args.shift,
                    device=args.device)
        print(f"{e:>6.1f} | {r['bits']:>8d} | {r['errs']:>6d} | "
              f"{r['ber']:>9.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
