"""Wrapper of the CRC and byte-packing kernel (`csrc/crc_pack.cu`).

The kernel replaces the XLA scan of `wenet_tpu/ops/crc.py::crc16` /
`packet_crc_ok` with the byte packing of `wenet_tpu/ops/deframe.py`
(`decode_windows`, `pack_decode_results`); its plain PyTorch version is
`wenet_tpu_torch.ops.crc.crc_pack_reference` (and
`packet_crc_ok_reference`).  `ops.crc` takes the plain versions for CPU
tensors; `pack` and `crc_ok` here take CUDA tensors only and launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import crc as dcrc
from . import load

TAIL_ITERS, TAIL_POS = 1, 2
TAIL_BYTES = {TAIL_ITERS: 1, TAIL_POS: 4}

launches = 0          # kernel launches, counted where the launch succeeds


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("crc_pack")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.crc_pack_launch.restype = I
    lib.crc_pack_launch.argtypes = [P, I, ctypes.c_longlong, P, P, I, I, P, P,
                                    P]
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def _check_bits(bits: torch.Tensor):
    if bits.device.type != "cuda":
        raise ValueError(f"crc_pack: needs a CUDA tensor, got {bits.device}")
    if bits.dtype != torch.uint8:
        raise TypeError(f"crc_pack: needs uint8 bits, got {bits.dtype}")
    if bits.dim() != 2 or bits.shape[1] < dcrc.PACKET_BITS:
        raise ValueError(f"crc_pack: needs shape (B, >= {dcrc.PACKET_BITS}),"
                         f" got {tuple(bits.shape)}")
    if bits.stride(1) != 1:
        raise ValueError("crc_pack: needs rows of unit stride")


def _launch(bits: torch.Tensor, rows, tail: int, extra, ok_out):
    global launches
    B = bits.shape[0]
    table = dcrc._table(bits.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = _lib().crc_pack_launch(
            bits.data_ptr(), B, max(bits.stride(0), dcrc.PACKET_BITS),
            table.data_ptr(), ptr(rows),
            0 if rows is None else rows.shape[1], tail, ptr(extra),
            ptr(ok_out), stream)
    if rc != 0:
        raise RuntimeError(f"crc_pack launch failed (B={B}): cudaError_t {rc}")
    launches += B > 0


def pack(bits: torch.Tensor, iters: torch.Tensor | None = None,
         positions: torch.Tensor | None = None) -> torch.Tensor:
    """bits (B, >= 2064) uint8 CUDA tensor -> rows (B, 259 + tail) uint8,
    the layout of `ops.crc.crc_pack` (tail: iters clamped to one byte, or
    positions as 4 little-endian bytes)."""
    _check_bits(bits)
    if (iters is None) == (positions is None):
        raise ValueError("crc_pack: iters or positions, one of them")
    B = bits.shape[0]
    for kind, t in ((TAIL_ITERS, iters), (TAIL_POS, positions)):
        if t is None:
            continue
        if t.device != bits.device or t.shape != (B,):
            raise ValueError(f"crc_pack: needs a ({B},) tensor on "
                             f"{bits.device} beside the bits")
        tail, extra = kind, t.to(torch.int32).contiguous()
    rows = torch.empty((B, dcrc.PACKET_BYTES + 1 + TAIL_BYTES[tail]),
                       dtype=torch.uint8, device=bits.device)
    _launch(bits, rows, tail, extra, None)
    return rows


def crc_ok(bits: torch.Tensor) -> torch.Tensor:
    """bits (B, >= 2064) uint8 CUDA tensor -> (B,) bool CRC flags."""
    _check_bits(bits)
    ok = torch.empty((bits.shape[0],), dtype=torch.bool, device=bits.device)
    _launch(bits, None, TAIL_ITERS, None, ok)
    return ok
