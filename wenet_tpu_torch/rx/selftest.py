"""Self-contained health check: TX -> AWGN channel -> full RX chain
(counterpart of wenet_tpu/rx/selftest.py).

`python -m wenet_tpu_torch.rx.selftest` exercises framing, LDPC encode, FSK
modulation, the demod, UW deframe/descramble, BP decode and the CRC gate end
to end on the card (`--device cpu` runs the plain versions on the host), and
exits nonzero on any failure.  A negative probe (noise far past the cliff)
must NOT decode, so a pass means the chain both works and actually
discriminates.

This is the equivalent of the reference's quickest smoke loop
(tx_test_images.py -> start_rx pipeline) with zero hardware and no external
binaries.
"""
from __future__ import annotations

import argparse
import sys
import time


def run(verbose: bool = True, device="cuda") -> int:
    """0 when every probe holds, 1 otherwise (a failure is said on stderr
    when verbose).  The demod, BP and CRC run on `device` (CUDA unless the
    caller asks for another; raises without a card)."""
    import numpy as np
    import torch

    from ..core import framing, packets
    from ..device import resolve_device
    from ..ops import fsk, ldpc
    from . import pipeline

    dev = resolve_device(device)
    t0 = time.time()
    say = (lambda *a: print("[selftest]", *a, file=sys.stderr)) if verbose \
        else (lambda *a: None)
    say("backend:", f"torch {torch.__version__}", "device:", str(dev),
        *((torch.cuda.get_device_name(dev),) if dev.type == "cuda" else ()))

    # 1. symbol-domain roundtrip at ~7.8 dB (positive) and far below (negative)
    msg = packets.encode_text_message("selftest", 1)
    frame = framing.frame_packet(msg, ldpc.encode_bytes, mode="v2")
    bits = framing.frame_to_bits(frame, "v2")[20 * 8:]
    rng = np.random.default_rng(0)
    for sigma, want in ((0.45, True), (1.4, False)):
        sym = 1.0 - 2.0 * bits.astype(np.float32)
        sym += rng.normal(0, sigma, sym.shape)
        desc = framing.rx_descramble_soft(sym)
        llr = ldpc.sd_to_llr(torch.as_tensor(
            desc[:2580][None], dtype=torch.float32)).numpy()
        cw, iters, ok = ldpc.decode_np(llr, device=dev)
        pc = framing.bits_to_bytes_msb(cw[0, :2064])
        crc_ok = pc[256:258] == int(
            framing.crc16_ccitt(pc[:256])).to_bytes(2, "little")
        got = bool(ok[0]) and crc_ok
        say(f"symbol-domain sigma={sigma}: parity={bool(ok[0])} "
            f"crc={crc_ok} iters={int(iters[0])}")
        if got != want:
            say("FAIL: symbol-domain probe")
            return 1
        if want and packets.decode_text_message(pc[:256])["text"] != "selftest":
            say("FAIL: payload text mismatch")
            return 1

    # 2. over-the-air: modulate, add noise, full Receiver chain
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    payloads = [packets.encode_text_message("otatest %d" % i, i)
                for i in range(3)]
    tx_bits = []
    for p in payloads:
        tx_bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode="v2"), "v2"))
    stream = np.concatenate(
        [rng.integers(0, 2, cfg.Nbits * 6).astype(np.uint8)]
        + tx_bits + [rng.integers(0, 2, cfg.Nbits * 6).astype(np.uint8)])
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    noise = rng.normal(0, 0.12, (len(sig), 2)).astype(np.float32)
    iq = (0.3 * sig + noise[:, 0] + 1j * noise[:, 1]).astype(np.complex64)

    rx = pipeline.Receiver(mode="v2", cfg=cfg, device=dev)
    got = rx.decode_iq(iq)
    want_payloads = [bytes(p) + b"\x55" * (256 - len(p)) for p in payloads]
    say(f"over-the-air: {len(got)}/{len(payloads)} packets, "
        f"EbNo={rx.stats.ebno_db:.1f} dB")
    if [g[:256] for g in got] != want_payloads:
        say("FAIL: over-the-air payload mismatch")
        return 1

    say("PASS (%.1f s)" % (time.time() - t0))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                         "plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
