"""The benchmark's traffic generator: framed random packets, FSK-modulated,
with AWGN at a set Eb/N0, quantised to the cu8 bytes an RTL-SDR gives.

Frames follow each other as the flight transmitter sends them (a packet,
else an idle packet, without pause), after an optional lead-in of random
bits; a recording ends where its last frame ends.

A frozen copy of the port's capture functions (`make_packet_bits`,
`fsk_mod_np`, `add_awgn`, `iq_to_cu8` of `wenet_tpu_torch`), so that a
change to the program cannot change the traffic it is measured on.  The
bits are drawn with numpy in the port's order; the modulator and the noise
run on the device (`torch.Generator`), in a few large calls.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

PREAMBLE = b"\x55" * 16
UNIQUE_WORD = b"\xab\xcd\xef\x01"
PAYLOAD_BYTES = 256
FRAME_BYTES = 16 + 4 + 256 + 2 + 65            # 343


@dataclasses.dataclass(frozen=True)
class Deployment:
    """The fields of a configuration file that the generator and the
    reference read."""
    name: str
    mode: str              # 'v2' (scrambled bytes) or 'v1' (RS232 words)
    Fs: int
    Rs: int
    M: int
    Nsym: int
    tones_hz: tuple        # the M tones in the SDR's baseband
    max_iter: int

    @property
    def Ts(self) -> int:
        return self.Fs // self.Rs

    @property
    def frame_bits(self) -> int:
        return FRAME_BYTES * (8 if self.mode == "v2" else 10)

    @classmethod
    def from_file(cls, d: dict) -> "Deployment":
        return cls(name=d["name"], mode=d["mode"], Fs=int(d["Fs"]),
                   Rs=int(d["Rs"]), M=int(d["M"]), Nsym=int(d["Nsym"]),
                   tones_hz=tuple(int(f) for f in d["tones_hz"]),
                   max_iter=int(d["ldpc_max_iter"]))


# ------------------------------------------------------------------ framing


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
        table[byte] = crc
    return table


CRC_TABLE = _crc_table()


def crc16(packets: np.ndarray) -> np.ndarray:
    """CRC16/CCITT-FALSE of each row of (B, L) uint8 -> (B,) uint16."""
    crc = np.full(packets.shape[0], 0xFFFF, np.uint16)
    for i in range(packets.shape[1]):
        idx = ((crc >> 8) ^ packets[:, i]) & 0xFF
        crc = ((crc << 8) ^ CRC_TABLE[idx]).astype(np.uint16)
    return crc


def _tables():
    code = np.load(os.path.join(DATA, "h2064_516.npz"))
    scr = np.load(os.path.join(DATA, "scramble.npz"))
    return ((code["Enc_rows"] - 1).astype(np.int64),
            scr["tx_xor"].astype(np.uint8))


def frame_packets(payloads: np.ndarray, mode: str) -> np.ndarray:
    """(B, 256) uint8 payloads -> (B, frame_bits) uint8 on-air bits:
    payload | CRC16-LE | 65 bytes of H2064_516 parity, the body
    XOR-scrambled in v2, after the preamble and the unique word; v2 sends
    bytes MSB first, v1 each byte as a 10-bit RS232 word."""
    taps, tx_xor = _tables()
    B = payloads.shape[0]
    crc = crc16(payloads)
    body = np.concatenate([payloads, (crc & 0xFF).astype(np.uint8)[:, None],
                           (crc >> 8).astype(np.uint8)[:, None]], axis=1)
    ibits = np.unpackbits(body, axis=1)                          # (B, 2064)
    parity = np.cumsum(ibits[:, taps].sum(-1), axis=-1) & 1      # (B, 516)
    body = np.concatenate([body, np.packbits(parity.astype(np.uint8),
                                             axis=1)], axis=1)   # (B, 323)
    if mode == "v2":
        body = body ^ np.tile(tx_xor, -(-body.shape[1] // len(tx_xor)))[
            : body.shape[1]]
    head = np.frombuffer(PREAMBLE + UNIQUE_WORD, np.uint8)
    frame = np.concatenate([np.broadcast_to(head, (B, len(head))), body],
                           axis=1)
    if mode == "v2":
        return np.unpackbits(frame, axis=1)
    lsb = np.unpackbits(frame, axis=1).reshape(B, -1, 8)[:, :, ::-1]
    words = np.zeros((B, lsb.shape[1], 10), np.uint8)
    words[:, :, 1:9] = lsb
    words[:, :, 9] = 1
    return words.reshape(B, -1)


def packet_bits(dep: Deployment, n_packets: int, rng: np.random.Generator,
                gap_bits: int, lead_bits: int):
    """lead_bits random bits, then n_packets random-payload frames, each
    followed by gap_bits random bits: (bits uint8, payloads (n, 256)
    uint8).  The draws follow the port's `make_packet_bits` (the lead-in,
    then per packet its payload and its gap)."""
    lead = rng.integers(0, 2, lead_bits).astype(np.uint8)
    payloads = np.zeros((n_packets, PAYLOAD_BYTES), np.uint8)
    gaps = np.zeros((n_packets, gap_bits), np.uint8)
    for i in range(n_packets):
        payloads[i] = rng.integers(0, 256, PAYLOAD_BYTES, dtype=np.uint8)
        gaps[i] = rng.integers(0, 2, gap_bits).astype(np.uint8)
    frames = frame_packets(payloads, dep.mode)
    body = np.concatenate([frames, gaps], axis=1).reshape(-1)
    return np.concatenate([lead, body]), payloads


# --------------------------------------------------------------- modulation


def modulate(dep: Deployment, bits: torch.Tensor) -> torch.Tensor:
    """Continuous-phase FSK from an exact integer phase accumulator (as the
    port's `fsk_mod_np`): bits (n,) on the device -> complex64 (n/b * Ts,)
    of amplitude 2, the angle formed in float64."""
    dev = bits.device
    b = bits.long()
    if dep.M == 4:
        b = 2 * b[0::2] + b[1::2]
    freqs = torch.as_tensor(dep.tones_hz, dtype=torch.int64, device=dev)[b]
    adv = (freqs * dep.Ts) % dep.Fs
    start = (torch.cumsum(adv, 0) - adv) % dep.Fs
    j = torch.arange(1, dep.Ts + 1, dtype=torch.int64, device=dev)
    acc = (start[:, None] + freqs[:, None] * j) % dep.Fs
    theta = acc.double() * (2.0 * np.pi / dep.Fs)
    return torch.polar(torch.full_like(theta, 2.0), theta).reshape(-1).to(
        torch.complex64)


def add_noise(dep: Deployment, sig: torch.Tensor, ebno_db: float,
              gen: torch.Generator) -> torch.Tensor:
    """AWGN calibrated to Eb/N0 from the signal's variance (noise variance
    = var * Fs / (Rs * Eb/N0 * bits a symbol)), then peak-normalised."""
    s = sig.to(torch.complex128)
    var = float((s.abs() ** 2).mean() - s.mean().abs() ** 2)
    nvar = var * dep.Fs / (dep.Rs * 10.0 ** (ebno_db / 10.0)
                           * (1 if dep.M == 2 else 2))
    n = torch.randn((2, sig.shape[0]), generator=gen, device=sig.device,
                    dtype=torch.float32)
    noisy = sig + np.float32(np.sqrt(nvar / 2.0)) * torch.complex(n[0], n[1])
    return noisy / noisy.abs().max()


def to_cu8(iq: torch.Tensor) -> torch.Tensor:
    """complex64 in [-1, 1] -> interleaved uint8 I/Q, round(x*128 + 127)
    clipped to [0, 255] (rtl_sdr's format)."""
    x = torch.view_as_real(iq.contiguous()).reshape(-1)
    return torch.clamp(torch.round(x * 128.0 + 127.0), 0, 255).to(
        torch.uint8)


@dataclasses.dataclass
class Recording:
    """One recording: its cu8 bytes in host memory, the payloads it
    carries in order, and the sample index just past each packet's last
    symbol."""
    raw: np.ndarray            # (2 n,) uint8, writable
    payloads: list             # [bytes], in air order
    ends: np.ndarray           # (n_packets,) int64 samples
    n_samples: int


def make_recording(dep: Deployment, seconds: float, ebno_db: float,
                   seed: int, index: int, gap_bits: int, lead_bits: int,
                   device) -> Recording:
    """Recording `index` of `seed`: the lead-in, then as many packets with
    their gaps as fit in seconds * Rs symbols; it ends where the last
    packet's gap ends, so that without a lead-in and gaps it replays in a
    loop as an unbroken stream of frames."""
    bps = 1 if dep.M == 2 else 2
    n_bits = int(round(seconds * dep.Rs)) * bps
    cycle = dep.frame_bits + gap_bits
    n_packets = (n_bits - lead_bits) // cycle
    rng = np.random.default_rng([index, seed % 2 ** 63])
    bits, payloads = packet_bits(dep, n_packets, rng, gap_bits, lead_bits)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + index) % 2 ** 63)
    sig = modulate(dep, torch.from_numpy(bits).to(device))
    raw = to_cu8(add_noise(dep, sig, ebno_db, gen))
    del sig
    ends = (lead_bits + np.arange(n_packets, dtype=np.int64) * cycle
            + dep.frame_bits) // bps * dep.Ts
    return Recording(raw=raw.cpu().numpy(),
                     payloads=[p.tobytes() for p in payloads], ends=ends,
                     n_samples=len(bits) // bps * dep.Ts)


def cu8_to_complex(raw: np.ndarray, dtype=np.complex128) -> np.ndarray:
    """Interleaved cu8 bytes -> complex samples, (x - 127) / 128."""
    x = raw.astype(np.float64).reshape(-1, 2)
    return ((x[:, 0] - 127.0) + 1j * (x[:, 1] - 127.0)).astype(dtype) / 128.0
