"""CRC16-CCITT on tensors (counterpart of wenet_tpu/ops/crc.py): a 256-entry
table lookup per byte, batched over packets.

`packet_crc_ok` and `crc_pack` take the tensor's device as their guide: a
CUDA tensor launches the CRC kernel (`kernels.crc_pack`, one launch for
the byte packing, the CRC over 256 bytes, the trailer compare and the
output rows), a CPU tensor runs the plain versions here (`crc16`'s
256-step loop).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.framing import CRC16_TABLE

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)
PACKET_BYTES = 258          # payload + little-endian CRC trailer
PACKET_BITS = PACKET_BYTES * 8


@functools.lru_cache(maxsize=8)
def _table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(CRC16_TABLE.astype(np.int32), device=device)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8k) {0,1} -> (..., k) int32 bytes, MSB-first."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32) * w).sum(
        dim=-1, dtype=torch.int32)


def crc16(data_bytes: torch.Tensor) -> torch.Tensor:
    """data_bytes (..., L) int32 in [0, 256) -> (...,) int32
    CRC16/CCITT-FALSE (init 0xFFFF, poly 0x1021)."""
    table = _table(data_bytes.device)
    crc = torch.full(data_bytes.shape[:-1], 0xFFFF, dtype=torch.int32,
                     device=data_bytes.device)
    for i in range(data_bytes.shape[-1]):
        idx = ((crc >> 8) ^ data_bytes[..., i]) & 0xFF
        crc = ((crc << 8) & 0xFFFF) ^ table[idx]
    return crc


def _bytes_and_ok(codeword_bits: torch.Tensor):
    pbytes = bits_to_bytes(codeword_bits[..., :PACKET_BITS])
    rx = crc16(pbytes[..., :256])
    tx = pbytes[..., 256] | (pbytes[..., 257] << 8)
    return pbytes, rx == tx


def packet_crc_ok_reference(codeword_bits: torch.Tensor) -> torch.Tensor:
    """The plain version of `packet_crc_ok`, on any device."""
    return _bytes_and_ok(codeword_bits)[1]


def crc_pack_reference(bits: torch.Tensor, iters: torch.Tensor | None = None,
                       positions: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `crc_pack`, on any device."""
    if (iters is None) == (positions is None):
        raise ValueError("crc_pack: iters or positions, one of them")
    pbytes, ok = _bytes_and_ok(bits)
    cols = [pbytes.to(torch.uint8), ok[..., None].to(torch.uint8)]
    if iters is not None:
        cols.append(torch.clamp(iters, 0, 255)[..., None].to(torch.uint8))
    else:
        pu = positions.to(torch.int64) & 0xFFFFFFFF
        cols += [((pu >> s) & 0xFF).to(torch.uint8)[..., None]
                 for s in (0, 8, 16, 24)]
    return torch.cat(cols, dim=-1)


def packet_crc_ok(codeword_bits: torch.Tensor) -> torch.Tensor:
    """codeword_bits (..., >= 2064) -> (...,) bool: CRC trailer check over
    the 256-byte payload (trailer little-endian)."""
    if codeword_bits.device.type == "cuda":
        from ..kernels import crc_pack as kernel
        lead = codeword_bits.shape[:-1]
        flat = codeword_bits.reshape(-1, codeword_bits.shape[-1])
        return kernel.crc_ok(flat).reshape(lead)
    return packet_crc_ok_reference(codeword_bits)


def crc_pack(bits: torch.Tensor, iters: torch.Tensor | None = None,
             positions: torch.Tensor | None = None) -> torch.Tensor:
    """Decoded codewords -> packed uint8 rows, one per codeword.

    bits: (B, >= 2064) uint8.  Each row holds the 258 payload and trailer
    bytes (MSB-first), the CRC flag, then with `iters` (B,) the iteration
    count clamped to [0, 255] (`decode_windows`' (B, 260) layout), or with
    `positions` (B,) int32 the position as 4 little-endian bytes
    (`deframe_topk(packed=True)`'s (B, 263) layout, which
    `deframe.unpack_decode_results` reads).  One of the two is required.
    """
    if bits.device.type == "cuda":
        from ..kernels import crc_pack as kernel
        return kernel.pack(bits, iters, positions)
    return crc_pack_reference(bits, iters, positions)
