"""Standalone SSDV transcoder CLI, argv-compatible with fsphil/ssdv.

The reference treats `ssdv` as an external binary invoked with
`ssdv -e -n -q 6 -c CALL -i N in.jpg out.bin` (tx/WenetPiCamera2.py:420-432,
test_images/compress_test_images.py:26-38) and `ssdv -d in.bin out.jpg`
(rx/rx_ssdv.py:243).  This subcommand accepts the same flags and file
conventions (stdin/stdout when a file is `-` or omitted) backed by the
native `wenet_tpu_torch.ssdv` codec, so scripts written against the binary
work unchanged against `python -m wenet_tpu_torch ssdv`.
"""
import argparse
import sys

from ..ssdv import codec

PACKET_LEN = codec.PACKET_LEN


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="wenet_tpu_torch ssdv",
        description="SSDV encode/decode (fsphil/ssdv argv contract)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("-e", action="store_true", help="encode JPEG -> SSDV")
    mode.add_argument("-d", action="store_true", help="decode SSDV -> JPEG")
    ap.add_argument("-n", action="store_true",
                    help="encode without FEC (type 0x67; Wenet's mode — the "
                         "outer LDPC supersedes RS)")
    ap.add_argument("-c", metavar="CALLSIGN", default="N0CALL",
                    help="payload callsign (base-40, up to 6 chars)")
    ap.add_argument("-i", metavar="ID", type=int, default=0,
                    help="image id 0-255")
    ap.add_argument("-q", metavar="LEVEL", type=int, default=4,
                    help="quality level 0-7 (reference uses 6)")
    ap.add_argument("-l", metavar="LENGTH", type=int, default=PACKET_LEN,
                    help="packet length (only 256 supported)")
    ap.add_argument("-t", metavar="PCT", type=int, default=None,
                    help="(accepted for compatibility; packet-loss testing "
                         "lives in the channel tools)")
    ap.add_argument("-v", action="store_true", help="verbose to stderr")
    ap.add_argument("infile", nargs="?", default="-")
    ap.add_argument("outfile", nargs="?", default="-")
    args = ap.parse_args(argv)

    if args.l != PACKET_LEN:
        print(f"ssdv: only {PACKET_LEN}-byte packets supported",
              file=sys.stderr)
        return 1
    if not 0 <= args.q <= 7:
        print("ssdv: quality level must be 0-7", file=sys.stderr)
        return 1

    fin = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    data = fin.read()
    if fin is not sys.stdin.buffer:
        fin.close()

    if args.e:
        try:
            pkts = codec.encode(data, callsign=args.c, image_id=args.i & 0xFF,
                                quality=args.q, fec=not args.n)
        except Exception as exc:
            print(f"ssdv: encode failed: {exc}", file=sys.stderr)
            return 1
        out = b"".join(pkts)
        if args.v:
            print(f"ssdv: wrote {len(pkts)} packets "
                  f"({'no-FEC 0x67' if args.n else 'FEC 0x66'}, "
                  f"q={args.q}, call={args.c}, id={args.i & 0xFF})",
                  file=sys.stderr)
    else:
        # tolerate a stream that is not packet-aligned: resync on the 0x55
        # sync byte + valid type like the real binary's scanner
        pkts, pos = [], 0
        while pos + PACKET_LEN <= len(data):
            if data[pos] == codec.SYNC and data[pos + 1] in (
                    codec.TYPE_FEC, codec.TYPE_NOFEC):
                pkts.append(data[pos:pos + PACKET_LEN])
                pos += PACKET_LEN
            else:
                pos += 1
        if not pkts:
            print("ssdv: no packets found", file=sys.stderr)
            return 1
        try:
            out = codec.decode(pkts)
        except Exception as exc:
            print(f"ssdv: decode failed: {exc}", file=sys.stderr)
            return 1
        if args.v:
            info = codec.packet_info(pkts[0])
            print(f"ssdv: decoded {len(pkts)} packets -> "
                  f"{len(out)} bytes (call={info['callsign']} "
                  f"id={info['image_id']})", file=sys.stderr)

    fout = (sys.stdout.buffer if args.outfile == "-"
            else open(args.outfile, "wb"))
    fout.write(out)
    if fout is not sys.stdout.buffer:
        fout.close()
    else:
        fout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
