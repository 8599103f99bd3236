"""TX CLI: transmit test imagery / text / canned SSDV over a software radio
(tx/tx_test_images.py + tx_known_sequence.py equivalents; a copy of
wenet_tpu/cli/tx.py, host numpy throughout).

Sinks: complex64 IQ file (feed it back to `python -m wenet_tpu_torch rx
--format c64`), one-byte-per-bit file for the C fsk modulator, or UDP link
emulation."""
from __future__ import annotations

import argparse
import sys


def add_args(ap: argparse.ArgumentParser):
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2")
    ap.add_argument("--callsign", default="N0CALL")
    ap.add_argument("--out", required=True,
                    help="output IQ .c64 file, .bits file, or udp:host:port")
    ap.add_argument("--images", nargs="*", default=[],
                    help="JPEG files to SSDV-encode and transmit")
    ap.add_argument("--ssdv", nargs="*", default=[],
                    help="pre-encoded .ssdv/.bin files to transmit")
    ap.add_argument("--text", nargs="*", default=[],
                    help="text messages to transmit")
    ap.add_argument("--idle-frames", type=int, default=2,
                    help="leading idle frames for RX estimator warm-up")
    ap.add_argument("--fs", type=int, default=None)
    ap.add_argument("--rs", type=int, default=None)
    ap.add_argument("--quality", type=int, default=6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap)
    args = ap.parse_args(argv)

    from .. import ssdv
    from ..ops import fsk
    from ..tx import BinaryDebugRadio, IQRadio, PacketTX, UDPRadio

    cfg = fsk.V2_CONFIG if args.mode == "v2" else fsk.V1_CONFIG
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs or cfg.Fs, Rs=args.rs or cfg.Rs)

    fout = None
    if args.out.startswith("udp:"):
        _, host, port = args.out.split(":")
        radio = UDPRadio(host, int(port), mode=args.mode)
    elif args.out.endswith(".bits"):
        radio = BinaryDebugRadio(args.out, mode=args.mode)
    else:
        fout = open(args.out, "wb")
        radio = IQRadio(lambda iq: fout.write(iq.tobytes()), cfg=cfg,
                        mode=args.mode)

    tx = PacketTX(radio, callsign=args.callsign)
    for _ in range(args.idle_frames):
        radio.transmit_packet(tx.idle_message)
    for msg in args.text:
        tx.transmit_text_message(msg)
    image_id = 0
    for jpg in args.images:
        with open(jpg, "rb") as f:
            pkts = ssdv.encode(f.read(), args.callsign, image_id,
                               args.quality)
        for p in pkts:
            tx.queue_image_packet(p)
        image_id = (image_id + 1) % 256
        print(f"queued {jpg}: {len(pkts)} packets", file=sys.stderr)
    for path in args.ssdv:
        tx.queue_image_file(path)

    # drain queues synchronously (batch tool, no live thread needed)
    sent = 0
    while not (tx.telemetry_queue_empty() and tx.image_queue_empty()):
        q = tx.telemetry_queue if tx.telemetry_queue.qsize() else tx.ssdv_queue
        radio.transmit_packet(q.get_nowait())
        sent += 1
    radio.transmit_packet(tx.idle_message)
    radio.shutdown()
    if fout:
        fout.close()
    print(f"transmitted {sent} packets -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
