"""SSDV codec: JPEG <-> loss-tolerant fixed-size packets (fsphil/ssdv
packet layout, UKHAS guide `ukhas.org.uk/guides:ssdv` — the format the
reference shells out for: rx/rx_ssdv.py:243, tx/WenetPiCamera2.py:420-432,
and that ssdv.habhub.org expects from the uploader, ssdvuploader.py:101).

Architecture (same as fsphil's): entropy-level transcode of baseline JPEG —
re-quantisation onto standard Annex K tables scaled by a 3-bit quality
level, standard JPEG Huffman coding into a continuous bitstream packetised
into 256-byte packets.  The first MCU to begin inside each packet starts
byte-aligned with absolute (predictor-reset) DC values, and the header
records its byte offset and MCU index, so any packet is independently
enterable; lost packets cost only the MCUs they carried.

Packet layout (no-FEC, type 0x67 — Wenet's `ssdv -e -n` configuration; the
outer LDPC supersedes RS FEC.  FEC-mode 0x66 packets are also decoded,
with the RS codes ignored):

  [0]     0x55 sync          [1]     0x66 FEC / 0x67 no-FEC
  [2:6]   callsign (base-40) [6]     image_id
  [7:9]   packet_id (BE)     [9]     width/16      [10] height/16
  [11]    flags: b0-1 subsampling (0=2x2, 1=1x2, 2=2x1, 3=1x1),
                 b2 EOI, b3-5 quality level
  [12]    mcu_offset: payload byte where the first fresh MCU starts
          (0xFF = continuation-only packet)
  [13:15] mcu_id (BE) of that fresh MCU (0xFFFF = none)
  [15:252]   payload, 237 B  (no-FEC)     [252:256] CRC32 [1:252] (BE)
  [15:220]   payload, 205 B  (FEC)        [220:224] CRC32 [1:220] (BE)
                                          [224:256] RS(255,223) parity

Grayscale input is encoded as 1x1-subsampled color with all-zero chroma
blocks (the wire format has no grayscale mode).

Interop status: header layout, CRC and packetisation conventions follow
the published UKHAS format above.  The quality-level -> quantisation-table
ladder (QUALITY_LADDER) follows libjpeg's `jpeg_set_quality` convention
and is LOCKED byte-for-byte against PIL/libjpeg-produced DQT tables at all
8 ladder qualities (tests/test_ssdv_quant.py); end-to-end bit interop with
the fsphil/ssdv binary itself is not verified (no binary or golden
corpus in the repository).  If tests/golden/ssdv/ contains
captures from the real binary, tests/test_ssdv.py locks decode against
them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..core.packets import ssdv_decode_callsign, ssdv_encode_callsign
from . import jpeg as J

SYNC = 0x55
TYPE_FEC = 0x66
TYPE_NOFEC = 0x67
HEADER_LEN = 15
PAYLOAD_LEN = 237          # no-FEC
PAYLOAD_LEN_FEC = 205
PACKET_LEN = 256

# subsampling mode (flags b0-1) <-> component-0 (h, v) sampling factors
MCU_MODES = {0: (2, 2), 1: (1, 2), 2: (2, 1), 3: (1, 1)}
MCU_MODE_OF = {v: k for k, v in MCU_MODES.items()}

# Annex K base quantisation tables (zigzag order)
_BASE_LUM = np.array([
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101,
    103, 99], np.int32)
_BASE_CHR = np.array([
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int32)

# quality level 0..7 -> libjpeg-style quality factor (see interop note)
QUALITY_LADDER = [20, 30, 40, 50, 60, 70, 77, 85]


def quant_tables(quality_idx: int):
    q = QUALITY_LADDER[quality_idx & 7]
    scale = 5000 // q if q < 50 else 200 - 2 * q
    lum = np.clip((_BASE_LUM * scale + 50) // 100, 1, 255)
    chr_ = np.clip((_BASE_CHR * scale + 50) // 100, 1, 255)
    return lum.astype(np.int32), chr_.astype(np.int32)


def _requantize(img: J.JpegImage, quality_idx: int) -> J.JpegImage:
    """Map source-quantised coefficients onto the standard tables."""
    lum, chr_ = quant_tables(quality_idx)
    bcomp = img.block_component()
    new = img.mcus.astype(np.int64).copy()
    for ci, comp in enumerate(img.components):
        src_q = img.qtables[comp.tq].astype(np.int64)
        dst_q = (lum if ci == 0 else chr_).astype(np.int64)
        sel = [b for b in range(img.blocks_per_mcu) if bcomp[b] == ci]
        vals = new[:, sel, :] * src_q[None, None, :]
        new[:, sel, :] = np.round(vals / dst_q[None, None, :]).astype(np.int64)
    out = J.JpegImage(img.width, img.height,
                      [J.Component(c.cid, c.h, c.v, 0 if i == 0 else 1)
                       for i, c in enumerate(img.components)],
                      {0: lum} if len(img.components) == 1 else
                      {0: lum, 1: chr_},
                      np.clip(new, -2047, 2047).astype(np.int32),
                      img.restart_interval)
    return out


def _expand_grayscale(img: J.JpegImage, quality: int) -> J.JpegImage:
    """Grayscale -> 1x1 color with zero chroma (wire format has no gray)."""
    n = img.mcus.shape[0]
    mcus = np.zeros((n, 3, 64), np.int32)
    mcus[:, 0, :] = img.mcus[:, 0, :]
    comps = [J.Component(1, 1, 1, 0), J.Component(2, 1, 1, 1),
             J.Component(3, 1, 1, 1)]
    return J.JpegImage(img.width, img.height, comps,
                       {0: img.qtables[0], 1: quant_tables(quality)[1]},
                       mcus, img.restart_interval)


def _decode_components(mcu_mode: int):
    h, v = MCU_MODES[mcu_mode]
    return [J.Component(1, h, v, 0), J.Component(2, 1, 1, 1),
            J.Component(3, 1, 1, 1)]


# ----------------------------------------------------------------- encode


def encode(jpeg_bytes: bytes, callsign: str = "N0CALL", image_id: int = 0,
           quality: int = 6, fec: bool = False) -> list:
    """JPEG -> list of 256-byte SSDV packets.

    fec=False (default, `ssdv -e -n`): type 0x67, 237 B payload.
    fec=True: type 0x66, 205 B payload + RS(255,223) parity over bytes
    [1:224] (the standard SSDV configuration for unprotected links).
    """
    img = _requantize(J.parse_jpeg(jpeg_bytes), quality)
    if len(img.components) == 1:
        img = _expand_grayscale(img, quality)
    if img.width % 16 or img.height % 16:
        raise ValueError("SSDV requires dimensions that are multiples of 16 "
                         f"(got {img.width}x{img.height})")
    c0 = img.components[0]
    if (c0.h, c0.v) not in MCU_MODE_OF:
        raise ValueError(f"unsupported subsampling {c0.h}x{c0.v}")
    mcu_mode = MCU_MODE_OF[(c0.h, c0.v)]
    n_mcus = img.mcus.shape[0]
    call = ssdv_encode_callsign(callsign)
    wb, hb = img.width // 16, img.height // 16
    flags_base = mcu_mode | ((quality & 7) << 3)
    plen = PAYLOAD_LEN_FEC if fec else PAYLOAD_LEN
    ptype = TYPE_FEC if fec else TYPE_NOFEC

    packets = []
    pend = b""          # pending continuation bits (byte-padded at source)
    pend_bits = 0       # true bit length of pend
    m = 0

    def emit(payload: bytes, off, mcu_id, eoi):
        pid = len(packets)
        flags = flags_base | (0x04 if eoi else 0)
        hdr = bytes([SYNC, ptype]) + call + bytes([image_id & 0xFF]) + \
            struct.pack(">H", pid) + bytes([wb & 0xFF, hb & 0xFF, flags,
                                            off & 0xFF]) + \
            struct.pack(">H", mcu_id)
        # 0xFF padding decodes as an invalid Huffman code, so a decoder
        # walking off the real payload stops cleanly
        body = hdr + payload.ljust(plen, b"\xff")
        body += struct.pack(">I", zlib.crc32(body[1:HEADER_LEN + plen]))
        if fec:
            from . import rs
            body += rs.encode(body[1:1 + rs.KK])
        packets.append(body)

    while m < n_mcus or pend_bits:
        payload = bytearray()
        # 1. continuation bits from a split MCU
        if pend_bits:
            take_bytes = min(len(pend), plen)
            payload += pend[:take_bytes]
            if take_bytes * 8 < pend_bits:      # still not finished
                pend = pend[take_bytes:]
                pend_bits -= take_bytes * 8
                emit(bytes(payload), 0xFF, 0xFFFF, False)
                continue
            pend, pend_bits = b"", 0
        off = len(payload)
        if m >= n_mcus:
            emit(bytes(payload), 0xFF, 0xFFFF, True)
            break
        # 2. fresh run: byte-aligned, predictors reset (DC coded absolute)
        space_bits = (plen - off) * 8
        preds = [0] * len(img.components)
        run = bytearray()
        run_bits = 0
        first_id = m
        while m < n_mcus and run_bits <= space_bits:
            chunk, nbits = _encode_mcu_bits_cont(img, m, preds, run, run_bits)
            run, run_bits = chunk, nbits
            m += 1
        if run_bits <= space_bits:
            payload += run
            emit(bytes(payload), off, first_id, m >= n_mcus)
        else:
            fit_bytes = plen - off
            payload += run[:fit_bytes]
            pend = bytes(run[fit_bytes:])
            pend_bits = run_bits - fit_bytes * 8
            emit(bytes(payload), off, first_id, False)
    return packets


def _encode_mcu_bits_cont(img, m, preds, prev_bytes, prev_bits):
    """Append MCU m to an existing bitstream (prev_bytes with prev_bits
    valid bits); returns (new_bytes, new_bits)."""
    bw = J.BitWriter()
    # reload the partial byte
    if prev_bits % 8:
        bw.out = bytearray(prev_bytes[: prev_bits // 8])
        bw.acc = prev_bytes[prev_bits // 8] >> (8 - prev_bits % 8)
        bw.nacc = prev_bits % 8
    else:
        bw.out = bytearray(prev_bytes[: prev_bits // 8])
    bcomp = img.block_component()
    for b in range(img.blocks_per_mcu):
        ci = bcomp[b]
        dc = J.ENC_DC_LUM if ci == 0 else J.ENC_DC_CHR
        ac = J.ENC_AC_LUM if ci == 0 else J.ENC_AC_CHR
        preds[ci] = J.encode_block(bw, img.mcus[m, b], dc, ac, preds[ci])
    nbits = bw.bit_length()
    return bytearray(bw.flush(fill=1)), nbits


# ----------------------------------------------------------------- decode


def _payload_len(pkt_type: int) -> int:
    return PAYLOAD_LEN_FEC if pkt_type == TYPE_FEC else PAYLOAD_LEN


def packet_info(pkt: bytes) -> dict:
    plen = _payload_len(pkt[1])
    crc_rx = struct.unpack(">I", pkt[HEADER_LEN + plen:
                                     HEADER_LEN + plen + 4])[0]
    return {
        "type": "FEC" if pkt[1] == TYPE_FEC else "No-FEC",
        "callsign": ssdv_decode_callsign(pkt[2:6]),
        "image_id": pkt[6],
        "packet_id": struct.unpack(">H", pkt[7:9])[0],
        "width": pkt[9] * 16, "height": pkt[10] * 16,
        "mcu_mode": pkt[11] & 0x03,
        "eoi": bool(pkt[11] & 0x04), "quality": (pkt[11] >> 3) & 7,
        "mcu_offset": pkt[12],
        "mcu_id": struct.unpack(">H", pkt[13:15])[0],
        "crc_ok": crc_rx == zlib.crc32(pkt[1:HEADER_LEN + plen]),
    }


class _StreamReader(J.BitReader):
    def seek_byte(self, byte_pos: int):
        self.pos = byte_pos
        self.nbits = 0


def decode(packets: list) -> bytes:
    """SSDV packets (possibly with gaps) -> reconstructed baseline JPEG."""
    pkts = []
    for p in packets:
        if len(p) != PACKET_LEN or p[0] != SYNC or \
                p[1] not in (TYPE_FEC, TYPE_NOFEC):
            continue
        info = packet_info(p)
        if not info["crc_ok"] and p[1] == TYPE_FEC:
            # FEC packets: attempt RS(255,223) correction (<=16 byte errors)
            from . import rs
            fixed, nerr = rs.correct(p[1:])
            if nerr >= 0:
                p = p[:1] + fixed
                info = packet_info(p)
        if info["crc_ok"]:
            pkts.append((info, p[HEADER_LEN:HEADER_LEN + _payload_len(p[1])]))
    if not pkts:
        raise ValueError("no valid SSDV packets")
    pkts.sort(key=lambda x: x[0]["packet_id"])
    info0 = pkts[0][0]
    width, height = info0["width"], info0["height"]
    quality = info0["quality"]
    lum, chr_ = quant_tables(quality)
    comps = _decode_components(info0["mcu_mode"])
    qtables = {0: lum, 1: chr_}
    img = J.JpegImage(width, height, comps, qtables,
                      np.zeros((0, 0, 64), np.int32))
    n_mcus = img.mcus_x * img.mcus_y
    bpm = img.blocks_per_mcu
    mcus = np.zeros((n_mcus, bpm, 64), np.int32)
    got = np.zeros(n_mcus, bool)
    bcomp = img.block_component()

    # split into contiguous packet runs; continuation is only meaningful
    # within a run, so each run decodes independently from its first fresh
    # marker and stops at its own end
    runs = []
    cur_stream, cur_markers, prev_pid = bytearray(), [], None
    for info, payload in pkts:
        if prev_pid is not None and info["packet_id"] != prev_pid + 1:
            runs.append((bytes(cur_stream), cur_markers))
            cur_stream, cur_markers = bytearray(), []
        base = len(cur_stream)
        cur_stream += payload
        if info["mcu_offset"] != 0xFF and info["mcu_id"] != 0xFFFF:
            cur_markers.append((base + info["mcu_offset"], info["mcu_id"]))
        prev_pid = info["packet_id"]
    runs.append((bytes(cur_stream), cur_markers))

    for stream, markers in runs:
        if not markers:
            continue
        br = _StreamReader(stream)
        br.seek_byte(markers[0][0])
        preds = [0] * len(comps)
        m = markers[0][1]
        mi = 1
        end_bits = len(stream) * 8
        while m < n_mcus:
            # a later fresh marker for this m: skip pad bits, reset preds
            if mi < len(markers) and markers[mi][1] == m:
                br.seek_byte(markers[mi][0])
                preds = [0] * len(comps)
                mi += 1
            try:
                blocks = []
                for b in range(bpm):
                    ci = bcomp[b]
                    dc = J.DEC_DC_LUM if ci == 0 else J.DEC_DC_CHR
                    ac = J.DEC_AC_LUM if ci == 0 else J.DEC_AC_CHR
                    blk, preds[ci] = J.decode_block(br, dc, ac, preds[ci])
                    blocks.append(blk)
            except (EOFError, ValueError, IndexError):
                break
            if br.bits_consumed() > end_bits:
                break                      # ran into padding/next run
            mcus[m] = np.stack(blocks)
            got[m] = True
            m += 1

    # fill missing MCUs with flat blocks (DC carried forward per component)
    last_dc = np.zeros(bpm, np.int32)
    for i in range(n_mcus):
        if got[i]:
            last_dc = mcus[i, :, 0]
        else:
            mcus[i, :, 0] = last_dc
    img.mcus = mcus
    return J.write_jpeg(img)


def decode_file(bin_path: str, jpg_path: str) -> bool:
    """rx_ssdv-compatible entry: packets file -> JPEG file."""
    with open(bin_path, "rb") as f:
        data = f.read()
    packets = [data[i:i + PACKET_LEN] for i in range(0, len(data), PACKET_LEN)]
    try:
        out = decode(packets)
    except Exception:
        return False
    with open(jpg_path, "wb") as f:
        f.write(out)
    return True


def encode_file(jpg_path: str, bin_path: str, callsign: str = "N0CALL",
                image_id: int = 0, quality: int = 6) -> bool:
    with open(jpg_path, "rb") as f:
        data = f.read()
    try:
        pkts = encode(data, callsign, image_id, quality)
    except Exception:
        return False
    with open(bin_path, "wb") as f:
        f.write(b"".join(pkts))
    return True
