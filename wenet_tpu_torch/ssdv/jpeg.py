"""Minimal baseline-JPEG entropy codec: parse a JFIF stream into quantized
DCT coefficient blocks, and write blocks back out as a standard JPEG.

This is the foundation of the native SSDV codec (wenet_tpu_torch.ssdv.codec): the
reference system shells out to the external `ssdv` binary
(tx/WenetPiCamera2.py:420-432, rx/rx_ssdv.py:243) which performs exactly
this kind of entropy-level transcoding; here it is implemented natively.

Supported: baseline sequential DCT (SOF0), 8-bit, 1 or 3 components,
arbitrary sampling factors, restart intervals.  Progressive/arithmetic are
out of scope (the Pi camera and PIL emit baseline).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int32)

# ITU-T T.81 Annex K standard Huffman tables: (bits[1..16], values)
STD_DC_LUM = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
              list(range(12)))
STD_DC_CHR = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
STD_AC_LUM = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
STD_AC_CHR = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


# --------------------------------------------------------------- Huffman


class HuffDecoder:
    """Canonical Huffman decoder built from (bits, values)."""

    def __init__(self, bits, values):
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        code, k = 0, 0
        for l in range(1, 17):
            self.valptr[l] = k
            self.mincode[l] = code
            code += bits[l - 1]
            k += bits[l - 1]
            self.maxcode[l] = code - 1
            code <<= 1
        self.values = values

    def decode(self, br) -> int:
        code, l = 0, 0
        while True:
            code = (code << 1) | br.read_bit()
            l += 1
            if l > 16:
                raise ValueError("bad Huffman code")
            if self.maxcode[l] >= self.mincode[l] and code <= self.maxcode[l]:
                return self.values[self.valptr[l] + code - self.mincode[l]]


class HuffEncoder:
    def __init__(self, bits, values):
        self.codes = {}
        code = 0
        k = 0
        for l in range(1, 17):
            for _ in range(bits[l - 1]):
                self.codes[values[k]] = (code, l)
                code += 1
                k += 1
            code <<= 1

    def __getitem__(self, v):
        return self.codes[v]


DEC_DC_LUM = HuffDecoder(*STD_DC_LUM)
DEC_DC_CHR = HuffDecoder(*STD_DC_CHR)
DEC_AC_LUM = HuffDecoder(*STD_AC_LUM)
DEC_AC_CHR = HuffDecoder(*STD_AC_CHR)
ENC_DC_LUM = HuffEncoder(*STD_DC_LUM)
ENC_DC_CHR = HuffEncoder(*STD_DC_CHR)
ENC_AC_LUM = HuffEncoder(*STD_AC_LUM)
ENC_AC_CHR = HuffEncoder(*STD_AC_CHR)


class BitReader:
    """MSB-first bit reader over JPEG entropy data (0xFF00 unstuffed by the
    caller) or raw bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bitbuf = 0
        self.nbits = 0

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                raise EOFError
            self.bitbuf = self.data[self.pos]
            self.pos += 1
            self.nbits = 8
        self.nbits -= 1
        return (self.bitbuf >> self.nbits) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def bits_consumed(self) -> int:
        return self.pos * 8 - self.nbits

    def align(self):
        self.nbits = 0


class BitWriter:
    def __init__(self, stuff: bool = False):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0
        self.stuff = stuff          # JPEG 0xFF00 byte stuffing

    def write_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nacc += 1
            if self.nacc == 8:
                self.out.append(self.acc)
                if self.stuff and self.acc == 0xFF:
                    self.out.append(0x00)
                self.acc = 0
                self.nacc = 0

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.nacc

    def flush(self, fill: int = 1):
        while self.nacc:
            self.write_bits(fill, 1)
        return bytes(self.out)


def _magnitude(v: int):
    """(size, bits) encoding of a DC diff / AC value (T.81 F.1.2.1)."""
    if v == 0:
        return 0, 0
    a = abs(v)
    size = a.bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _extend(bits: int, size: int) -> int:
    if size == 0:
        return 0
    return bits if bits >= (1 << (size - 1)) else bits - (1 << size) + 1


def decode_block(br: BitReader, dc_dec, ac_dec, pred: int):
    """Decode one 8x8 block -> (zigzag int32[64], new DC predictor)."""
    blk = np.zeros(64, np.int32)
    size = dc_dec.decode(br)
    diff = _extend(br.read_bits(size), size) if size else 0
    pred += diff
    blk[0] = pred
    k = 1
    while k < 64:
        rs = ac_dec.decode(br)
        r, s = rs >> 4, rs & 0xF
        if s == 0:
            if r == 15:
                k += 16
                continue
            break                      # EOB
        k += r
        if k > 63:
            raise ValueError("AC index overflow")
        blk[k] = _extend(br.read_bits(s), s)
        k += 1
    return blk, pred


def encode_block(bw: BitWriter, blk: np.ndarray, dc_enc, ac_enc, pred: int) -> int:
    """Encode one zigzag block; returns new DC predictor."""
    diff = int(blk[0]) - pred
    size, bits = _magnitude(diff)
    code, length = dc_enc[size]
    bw.write_bits(code, length)
    if size:
        bw.write_bits(bits, size)
    run = 0
    last_nz = 0
    nz = np.nonzero(blk[1:])[0]
    last_nz = (nz[-1] + 1) if len(nz) else 0
    for k in range(1, 64):
        v = int(blk[k])
        if k > last_nz:
            break
        if v == 0:
            run += 1
            continue
        while run > 15:
            code, length = ac_enc[0xF0]
            bw.write_bits(code, length)
            run -= 16
        size, bits = _magnitude(v)
        code, length = ac_enc[(run << 4) | size]
        bw.write_bits(code, length)
        bw.write_bits(bits, size)
        run = 0
    if last_nz < 63:
        code, length = ac_enc[0x00]
        bw.write_bits(code, length)
    return int(blk[0])


# ------------------------------------------------------------ JPEG parsing


@dataclasses.dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int            # quant table index
    td: int = 0        # DC huffman table
    ta: int = 0        # AC huffman table


@dataclasses.dataclass
class JpegImage:
    width: int
    height: int
    components: list          # [Component]
    qtables: dict             # idx -> np.int32[64] (zigzag order)
    mcus: np.ndarray          # (n_mcus, blocks_per_mcu, 64) int32 zigzag
    restart_interval: int = 0

    @property
    def mcu_w(self) -> int:
        return 8 * max(c.h for c in self.components)

    @property
    def mcu_h(self) -> int:
        return 8 * max(c.v for c in self.components)

    @property
    def mcus_x(self) -> int:
        return -(-self.width // self.mcu_w)

    @property
    def mcus_y(self) -> int:
        return -(-self.height // self.mcu_h)

    @property
    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    def block_component(self):
        """Per-MCU block index -> component index."""
        out = []
        for ci, c in enumerate(self.components):
            out.extend([ci] * (c.h * c.v))
        return out


def parse_jpeg(data: bytes) -> JpegImage:
    """Parse a baseline JPEG into quantized coefficient MCUs."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    qtables, dc_tabs, ac_tabs = {}, {}, {}
    comps, width = [], 0
    height = 0
    restart = 0
    scan_data = None
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2: pos + seglen]
        if marker == 0xDB:                      # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 0xF
                p += 1
                if pq:
                    tab = np.frombuffer(seg[p:p + 128], ">u2").astype(np.int32)
                    p += 128
                else:
                    tab = np.frombuffer(seg[p:p + 64], np.uint8).astype(np.int32)
                    p += 64
                qtables[tq] = tab
        elif marker == 0xC0:                    # SOF0 baseline
            height, width = struct.unpack(">HH", seg[1:5])
            n = seg[5]
            comps = []
            for i in range(n):
                cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
                comps.append(Component(cid, hv >> 4, hv & 0xF, tq))
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError(f"unsupported SOF marker 0xFF{marker:02X} "
                             "(only baseline SOF0)")
        elif marker == 0xC4:                    # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0xF
                bits = list(seg[p + 1: p + 17])
                nval = sum(bits)
                values = list(seg[p + 17: p + 17 + nval])
                dec = HuffDecoder(bits, values)
                if tc == 0:
                    dc_tabs[th] = dec
                else:
                    ac_tabs[th] = dec
                p += 17 + nval
        elif marker == 0xDD:                    # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:                    # SOS
            n = seg[0]
            for i in range(n):
                cs, tdta = seg[1 + 2 * i: 3 + 2 * i]
                for c in comps:
                    if c.cid == cs:
                        c.td, c.ta = tdta >> 4, tdta & 0xF
            # entropy data runs until the next non-RST marker; unstuff
            # 0xFF00 and split into restart segments as we go
            p = pos + seglen
            segs = []
            cur = bytearray()
            while p < len(data) - 1:
                byte = data[p]
                if byte == 0xFF:
                    nxt = data[p + 1]
                    if nxt == 0x00:
                        cur.append(0xFF)
                        p += 2
                        continue
                    if 0xD0 <= nxt <= 0xD7:
                        segs.append(bytes(cur))
                        cur = bytearray()
                        p += 2
                        continue
                    break
                cur.append(byte)
                p += 1
            segs.append(bytes(cur))
            scan_data = segs
            pos = p
            continue
        pos += seglen
    if scan_data is None or not comps:
        raise ValueError("no scan data")

    img = JpegImage(width, height, comps, qtables,
                    np.zeros((0, 0, 64), np.int32), restart)
    n_mcus = img.mcus_x * img.mcus_y
    bpm = img.blocks_per_mcu
    mcus = np.zeros((n_mcus, bpm, 64), np.int32)
    m = 0
    for seg_bytes in scan_data:          # one segment per restart interval
        br = BitReader(seg_bytes)
        preds = {ci: 0 for ci in range(len(comps))}
        limit = restart if restart else n_mcus
        for _ in range(limit):
            if m >= n_mcus:
                break
            b = 0
            for ci, c in enumerate(comps):
                for _ in range(c.h * c.v):
                    blk, preds[ci] = decode_block(
                        br, dc_tabs[c.td], ac_tabs[c.ta], preds[ci])
                    mcus[m, b] = blk
                    b += 1
            m += 1
    img.mcus = mcus
    return img


# ------------------------------------------------------------ JPEG writing


def _dht_segment(tc, th, bits, values) -> bytes:
    payload = bytes([(tc << 4) | th]) + bytes(bits) + bytes(values)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(payload)) + payload


def write_jpeg(img: JpegImage) -> bytes:
    """Re-emit a baseline JPEG from coefficient MCUs using the standard
    Annex K Huffman tables."""
    out = bytearray(b"\xff\xd8")
    for tq, tab in sorted(img.qtables.items()):
        out += b"\xff\xdb" + struct.pack(">H", 67) + bytes([tq]) + bytes(
            np.asarray(tab, np.int32).clip(1, 255).astype(np.uint8))
    ncomp = len(img.components)
    sof = bytes([8]) + struct.pack(">HH", img.height, img.width) + bytes([ncomp])
    for c in img.components:
        sof += bytes([c.cid, (c.h << 4) | c.v, c.tq])
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    out += _dht_segment(0, 0, *STD_DC_LUM)
    out += _dht_segment(1, 0, *STD_AC_LUM)
    if ncomp > 1:
        out += _dht_segment(0, 1, *STD_DC_CHR)
        out += _dht_segment(1, 1, *STD_AC_CHR)
    sos = bytes([ncomp])
    for i, c in enumerate(img.components):
        t = 0 if i == 0 else 1
        sos += bytes([c.cid, (t << 4) | t])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos

    bw = BitWriter(stuff=True)
    preds = [0] * ncomp
    bcomp = img.block_component()
    for m in range(img.mcus.shape[0]):
        for b in range(img.blocks_per_mcu):
            ci = bcomp[b]
            dc = ENC_DC_LUM if ci == 0 else ENC_DC_CHR
            ac = ENC_AC_LUM if ci == 0 else ENC_AC_CHR
            preds[ci] = encode_block(bw, img.mcus[m, b], dc, ac, preds[ci])
    out += bw.flush()
    out += b"\xff\xd9"
    return bytes(out)
