"""The image corpus end to end on the card (counterpart of
tools/corpus_e2e.py, BASELINE.json config 3): every image through SSDV,
TX framing, flight-rate modulation, AWGN, the whole RX chain and SSDV
reassembly.

    python -m wenet_tpu_torch.tools.corpus_e2e [--images GLOB]
        [--mode v2|v1] [--ebno 12] [--limit N] [--fused N [--slabs S]]
        [--device cpu]

Per image, as the JAX tool: resized to 800x608 and saved as JPEG q90,
`ssdv.encode` (callsign VK5QI, the image id from the file's number), a
lead-in of 4 * Nbits random bits, the framed packets back to back,
`fsk_mod_np` at the mode's flight rate, AWGN at --ebno, zero padding to
10 M samples (27 M with --fused), cu8 bytes; then one decoder: the
streaming `Receiver` (default), `decode_iq_fused` with --fused N chunks,
or with --fused and --slabs S `decode_iq_fused_overlap` (S slabs of N / S
chunks); then `ssdv.decode` and the mean pixel difference against the
JPEG sent.  One row an image; the summary line gives x real time (the
unpadded signal's duration over the decode time).

Changes from the JAX tool:
- `--images GLOB` chooses the corpus (default the reference checkout's
  test_images/*.jpg).  Numbered files sort by number and take it as
  their image id; other names sort after them, by name, with their index
  as the id.  When nothing matches, the tool exits 1 with a message.
- Each image's noise is seeded with zlib.crc32 of its file name, which is
  the same in every process (Python's hash() of a string is not).
- The C-chain column is gone (the reference binaries are not built
  here).  In its place: the packets decoded against those sent, and
  whether `ssdv.decode` of the decoded packets equals `ssdv.decode` of
  the packets sent (`jpeg_equal`).  The exit status is 1 when an image
  is not equal.
- Pillow is imported only where images are read and compared, so the
  module imports without it.
- `--device` (the card unless `--device cpu`).
"""
from __future__ import annotations

import argparse
import glob as globmod
import io
import os
import sys
import time
import zlib

import numpy as np

from ..device import resolve_device

DEFAULT_IMAGES = "/root/reference/test_images/*.jpg"
RESOLUTION = (800, 608)
CALLSIGN = "VK5QI"
PAD_SAMPLES = 10_000_000          # the streaming decoders' capture length
PAD_SAMPLES_FUSED = 27_000_000    # --fused: an 800x608 q90 image with margin


def images(pattern: str) -> list:
    """The files matching pattern -> [(path, image id)]: numbered files by
    number (the id is the number mod 256), then the others by name (the id
    is the index mod 256)."""
    def stem(p):
        return os.path.basename(p).split(".")[0]
    paths = sorted(globmod.glob(pattern), key=lambda p: (
        not stem(p).isdigit(), int(stem(p)) if stem(p).isdigit() else 0,
        os.path.basename(p)))
    return [(p, (int(stem(p)) if stem(p).isdigit() else i) % 256)
            for i, p in enumerate(paths)]


def load_jpeg(path: str, resolution=RESOLUTION) -> bytes:
    """The image resized to `resolution`, saved as JPEG q90 (Pillow)."""
    from PIL import Image
    img = Image.open(path).convert("RGB").resize(resolution)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90)
    return buf.getvalue()


def pixel_diff(a: bytes, b: bytes) -> float:
    """Mean |difference| of two JPEGs' pixels (Pillow); nan when either
    does not decode or their shapes differ."""
    from PIL import Image
    try:
        x = np.asarray(Image.open(io.BytesIO(a)), np.float32)
        y = np.asarray(Image.open(io.BytesIO(b)), np.float32)
    except Exception:
        return float("nan")
    return float(np.abs(x - y).mean()) if x.shape == y.shape else float(
        "nan")


def seed(name: str) -> int:
    """The noise seed of an image: crc32 of its file name."""
    return zlib.crc32(name.encode())


def capture(packets: list, cfg, mode: str, ebno: float, rng,
            pad_len: int = PAD_SAMPLES):
    """The SSDV packets on the air: 4 * Nbits random lead-in bits, the
    framed packets, padded to whole frames, FSK at cfg's rates, AWGN from
    rng, zero samples to pad_len -> (cu8 bytes, unpadded samples)."""
    from ..core import framing
    from ..ops import channel, fsk, ldpc
    bits = [rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)]
    for p in packets:
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode)
        bits.append(framing.frame_to_bits(frame, mode))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig.astype(np.complex64), ebno, cfg.Fs, cfg.Rs,
                          rng=rng)
    n_signal = len(iq)
    if len(iq) < pad_len:
        iq = np.concatenate([iq, np.zeros(pad_len - len(iq), np.complex64)])
    return fsk.iq_to_cu8(iq), n_signal


def decode(raw: np.ndarray, mode: str, cfg, fused: int = 0, slabs: int = 0,
           device="cuda") -> list:
    """The capture's CRC-valid payloads: Receiver on the cu8 bytes (the
    conversion on the device), decode_iq_fused with `fused` chunks, or
    with slabs > 1 decode_iq_fused_overlap."""
    from ..rx import pipeline as P
    if not fused:
        rx = P.Receiver(mode=mode, cfg=cfg, input_format="cu8",
                        device=device)
        return rx.decode_iq(raw)
    if slabs > 1:
        return P.decode_iq_fused_overlap(
            raw, mode, cfg, n_slabs=slabs,
            chunks_per_slab=max(fused // slabs, 1), input_format="cu8",
            device=device)
    return P.decode_iq_fused(raw, mode, cfg, n_chunks=fused,
                             input_format="cu8", device=device)


def run_image(path: str, image_id: int, cfg, mode: str = "v2",
              ebno: float = 12.0, fused: int = 0, slabs: int = 0,
              device="cuda", resolution=RESOLUTION,
              pad_len: int | None = None) -> dict:
    """One image end to end -> its row: packets sent and decoded, whether
    the reassembled JPEG equals the one the packets sent make, the pixel
    difference, the signal's samples and the decode's seconds."""
    from .. import ssdv
    name = os.path.basename(path)
    jpg = load_jpeg(path, resolution)
    pkts = ssdv.encode(jpg, CALLSIGN, image_id)
    if pad_len is None:
        pad_len = PAD_SAMPLES_FUSED if fused else PAD_SAMPLES
    raw, n_signal = capture(pkts, cfg, mode, ebno,
                            np.random.default_rng(seed(name)), pad_len)
    t0 = time.perf_counter()
    ours = decode(raw, mode, cfg, fused, slabs, device)
    dt = time.perf_counter() - t0
    got = ssdv.decode(ours) if ours else b""
    return {"name": name, "packets": len(pkts), "decoded": len(ours),
            "jpeg_equal": got == ssdv.decode(pkts),
            "pixdiff": pixel_diff(jpg, got), "samples": n_signal,
            "seconds": dt}


def main(argv=None) -> int:
    from ..rx.pipeline import MODE_CONFIGS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", default=DEFAULT_IMAGES,
                    help="glob of the corpus's JPEG files")
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2")
    ap.add_argument("--ebno", type=float, default=12.0)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--fused", type=int, default=0, metavar="N",
                    help="decode via the fused path with N chunks")
    ap.add_argument("--slabs", type=int, default=0,
                    help="with --fused: slab-pipelined copy/compute overlap")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus = images(args.images)[: args.limit]
    if not corpus:
        print(f"corpus_e2e: no image matches {args.images!r}",
              file=sys.stderr)
        return 1
    cfg = MODE_CONFIGS[args.mode]
    rows = []
    for path, image_id in corpus:
        r = run_image(path, image_id, cfg, args.mode, args.ebno, args.fused,
                      args.slabs, dev, RESOLUTION)
        rows.append(r)
        print(f"{r['name']:>7} pkts={r['packets']:>3} "
              f"decoded={r['decoded']:>3} jpeg_equal={r['jpeg_equal']!s:>5} "
              f"pixdiff={r['pixdiff']:5.2f} t={r['seconds']:6.3f}s",
              flush=True)
    total_t = sum(r["seconds"] for r in rows)
    total_samples = sum(r["samples"] for r in rows)
    whole = sum(r["jpeg_equal"] for r in rows)
    print(f"\nTotal: {len(rows)} images, {total_samples / 1e6:.0f} Msamples "
          f"decoded in {total_t:.3f}s = "
          f"{total_samples / cfg.Fs / total_t:.1f}x real-time "
          f"single-stream; {whole}/{len(rows)} images equal to the JPEG "
          f"the packets sent make")
    return 0 if whole == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
