"""Wenet wire-format primitives: CRC table, frame layout, scramblers, RS232
words (copy of wenet_tpu/core/framing.py; every public name of it is here).

Frame layout (both modes):

    preamble 16*0x55 | UW 0xABCDEF01 | 256B payload | CRC16-LE | 65B parity

v1 "classic": every byte is expanded to a 10-bit RS232 word
    (start=0, data bits LSB-first, stop=1) before hitting the air.
v2: raw bytes MSB-first, XOR-scrambled with a 125-byte sequence
    (multiplicative +/-1 descramble of 1000 entries on the RX side).
"""
from __future__ import annotations

import os

import numpy as np

PAYLOAD_BYTES = 256
CRC_BYTES = 2
PARITY_BYTES = 65
PARITY_BITS = 516
PREAMBLE = b"\x55" * 16
UNIQUE_WORD = b"\xab\xcd\xef\x01"
IDLE_SEQUENCE = b"\x56" * PAYLOAD_BYTES

# v2 deframer parameters (wenet_ldpc.c:65-73)
V2_UW_BITS = 32
V2_UW_ALLOWED_ERRORS = 4
V2_SYMBOLS_PER_PACKET = (PAYLOAD_BYTES + CRC_BYTES + PARITY_BYTES) * 8  # 2584
V2_CODEWORD_BITS = 2580  # first 2580 of the 2584 collected are the codeword
# v1 deframer parameters (drs232_ldpc.c:65-73)
V1_UW_BITS = 40
V1_UW_ALLOWED_ERRORS = 5
V1_BITS_PER_BYTE = 10
V1_SYMBOLS_PER_PACKET = (PAYLOAD_BYTES + CRC_BYTES + PARITY_BYTES) * 10  # 3230

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _make_crc16_table(poly: int = 0x1021) -> np.ndarray:
    entries = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        entries.append(crc)
    return np.array(entries, dtype=np.uint16)


CRC16_TABLE = _make_crc16_table()


def crc16_ccitt(data: bytes | np.ndarray) -> int:
    """CRC16/CCITT-FALSE (init 0xFFFF, poly 0x1021)."""
    crc = 0xFFFF
    for b in np.frombuffer(bytes(data), dtype=np.uint8):
        crc = ((crc << 8) & 0xFFFF) ^ int(CRC16_TABLE[((crc >> 8) ^ b) & 0xFF])
    return crc


def crc16_ccitt_batch(packets: np.ndarray) -> np.ndarray:
    """CRC16 over a batch: packets (B, L) uint8 -> (B,) uint16, the byte
    axis in order and the batch axis at once."""
    packets = np.asarray(packets, dtype=np.uint8)
    crc = np.full(packets.shape[0], 0xFFFF, dtype=np.uint16)
    for i in range(packets.shape[1]):
        idx = ((crc >> 8) ^ packets[:, i]).astype(np.uint16) & 0xFF
        crc = ((crc << 8) ^ CRC16_TABLE[idx]).astype(np.uint16)
    return crc


def load_scramble_tables():
    """(scramble_pm1 (1000,) float32, tx_xor (125,) uint8)."""
    d = np.load(os.path.join(_DATA_DIR, "scramble.npz"))
    return d["scramble_pm1"].astype(np.float32), d["tx_xor"].astype(np.uint8)


SCRAMBLE_PM1, TX_XOR = load_scramble_tables()


def tx_scramble(data: bytes) -> bytes:
    """v2 TX byte-XOR scramble."""
    buf = np.frombuffer(data, dtype=np.uint8)
    reps = -(-len(buf) // len(TX_XOR))
    return (buf ^ np.tile(TX_XOR, reps)[: len(buf)]).tobytes()


def rx_descramble_soft(symbols: np.ndarray) -> np.ndarray:
    """v2 RX multiplicative descramble of the soft symbols collected after
    the UW: symbol[i] * scramble_pm1[i % 1000]."""
    n = symbols.shape[-1]
    reps = -(-n // len(SCRAMBLE_PM1))
    return symbols * np.tile(SCRAMBLE_PM1, reps)[:n]


def bytes_to_bits_msb(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bytes_msb(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def rs232_expand(data: bytes) -> np.ndarray:
    """v1: bytes -> 10-bit RS232 words: 0, b0..b7 LSB-first, 1."""
    bits = bytes_to_bits_msb(data).reshape(-1, 8)[:, ::-1]
    words = np.zeros((bits.shape[0], 10), dtype=np.uint8)
    words[:, 1:9] = bits
    words[:, 9] = 1
    return words.reshape(-1)


def rs232_strip_soft(symbols: np.ndarray) -> np.ndarray:
    """v1 RX: drop start/stop symbols and un-reverse each byte's bit order."""
    w = symbols.reshape(*symbols.shape[:-1], -1, 10)
    return w[..., 8:0:-1].reshape(*symbols.shape[:-1], -1)


# UW bit patterns as they appear on air (hard bits)
UW_BITS_V2 = bytes_to_bits_msb(UNIQUE_WORD)               # 32 bits
UW_BITS_V1 = rs232_expand(UNIQUE_WORD)                    # 40 bits


def pad_payload(packet: bytes, payload_length: int = PAYLOAD_BYTES) -> bytes:
    """Clip/pad a payload to the fixed length with 0x55."""
    packet = packet[:payload_length]
    return packet + b"\x55" * (payload_length - len(packet))


def frame_packet(packet: bytes, ldpc_encode_fn, mode: str = "v2") -> bytes:
    """Full TX framing: pad -> CRC16-LE -> LDPC parity ->
    preamble|UW|body, the body XOR-scrambled in v2.  ``ldpc_encode_fn`` maps
    the 258-byte payload+crc to the 65-byte parity block."""
    packet = pad_payload(packet)
    crc = int(crc16_ccitt(packet)).to_bytes(2, "little")
    body = packet + crc + ldpc_encode_fn(packet + crc)
    if mode == "v2":
        body = tx_scramble(body)
    return PREAMBLE + UNIQUE_WORD + body


def frame_to_bits(frame: bytes, mode: str = "v2") -> np.ndarray:
    """Framed packet -> on-air bits: v2 MSB-first bytes, v1 RS232 words."""
    if mode == "v2":
        return bytes_to_bits_msb(frame)
    return rs232_expand(frame)
