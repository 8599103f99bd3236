"""CRC16-CCITT on tensors (counterpart of wenet_tpu/ops/crc.py): a 256-entry
table lookup per byte, batched over packets."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.framing import CRC16_TABLE

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


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


def packet_crc_ok(codeword_bits: torch.Tensor) -> torch.Tensor:
    """codeword_bits (..., >= 2064) -> (...,) bool: CRC trailer check over
    the 256-byte payload (trailer little-endian)."""
    pbytes = bits_to_bytes(codeword_bits[..., : 258 * 8])
    rx = crc16(pbytes[..., :256])
    tx = pbytes[..., 256] | (pbytes[..., 257] << 8)
    return rx == tx
