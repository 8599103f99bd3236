"""Wrapper of the CRC and byte-packing kernel (`csrc/crc_pack.cu`).

The kernel replaces the XLA scan of `wenet_tpu/ops/crc.py::crc16` /
`packet_crc_ok` with the byte packing of `wenet_tpu/ops/deframe.py`
(`decode_windows`, `pack_decode_results`); its plain PyTorch version is
`wenet_tpu_torch.ops.crc.crc_pack_reference` (and
`packet_crc_ok_reference`).  `ops.crc` takes the plain versions for CPU
tensors; `pack` and `crc_ok` here take CUDA tensors only and launch the
kernel or raise.

The kernel takes each lane's 8-byte CRC from state 0 and joins the lanes
through the CRC's linearity; `crc_tables` builds the tables it needs.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.framing import CRC16_TABLE
from ..ops import crc as dcrc
from . import launch_context, load

TAIL_ITERS, TAIL_POS = 1, 2
TAIL_BYTES = {TAIL_ITERS: 1, TAIL_POS: 4}
LANE_BYTES = 8                   # payload bytes a lane CRCs
LEVELS = 5                       # joins of 8, 16, 32, 64, 128 bytes

launches = 0          # kernel launches, counted where the launch succeeds


def advance(state, n_zero_bytes: int):
    """CRC16/CCITT-FALSE register state(s) after n zero bytes."""
    table = CRC16_TABLE.astype(np.uint32)
    s = np.asarray(state, np.uint32)
    for _ in range(n_zero_bytes):
        s = ((s << 8) & 0xFFFF) ^ table[(s >> 8) & 0xFF]
    return s


@functools.lru_cache(maxsize=1)
def crc_tables() -> np.ndarray:
    """(256 + LEVELS * 512,) uint16: the byte table, then for each level l
    the advance of a state over 8 * 2**l zero bytes as two tables, of the
    state's high byte (h << 8) and of its low byte; the advance of x is
    high[x >> 8] ^ low[x & 0xFF] (the CRC is linear over GF(2))."""
    b = np.arange(256, dtype=np.uint32)
    parts = [CRC16_TABLE.astype(np.uint32)]
    for level in range(LEVELS):
        n = LANE_BYTES << level
        parts += [advance(b << 8, n), advance(b, n)]
    return np.concatenate(parts).astype(np.uint16)


# the CRC of 256 bytes from init 0xFFFF is their CRC from state 0 XOR this
INIT_TERM = int(advance(0xFFFF, dcrc.PACKET_BYTES - 2))


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(crc_tables().view(np.int16), device=device)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("crc_pack")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.crc_pack_launch.restype = I
    lib.crc_pack_launch.argtypes = [P, I, ctypes.c_longlong, P,
                                    ctypes.c_uint32, P, I, I, P, P, P]
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
    lib = _lib()
    tables = _device_tables(bits.device)
    ctx, stream = launch_context(bits.device)
    with ctx:
        rc = lib.crc_pack_launch(
            bits.data_ptr(), B, max(bits.stride(0), dcrc.PACKET_BITS),
            tables.data_ptr(), INIT_TERM,
            None if rows is None else rows.data_ptr(),
            0 if rows is None else rows.shape[1], tail,
            None if extra is None else extra.data_ptr(),
            None if ok_out is None else ok_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crc_pack launch failed (B={B}): cudaError_t {rc}")
    launches += B > 0


def pack(bits: torch.Tensor, iters: torch.Tensor | None = None,
         positions: torch.Tensor | None = None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """bits (B, >= 2064) uint8 CUDA tensor -> rows (B, 259 + tail) uint8,
    the layout of `ops.crc.crc_pack` (tail: iters clamped to one byte, or
    positions as 4 little-endian bytes); `out`, where given, the
    contiguous uint8 rows to write them into (a view of a larger buffer
    that goes to the host in one copy)."""
    _check_bits(bits)
    if (iters is None) == (positions is None):
        raise ValueError("crc_pack: iters or positions, one of them")
    B = bits.shape[0]
    tail, extra = ((TAIL_ITERS, iters) if positions is None
                   else (TAIL_POS, positions))
    if extra.device != bits.device or extra.shape != (B,):
        raise ValueError(f"crc_pack: needs a ({B},) tensor on "
                         f"{bits.device} beside the bits")
    if extra.dtype != torch.int32 or not extra.is_contiguous():
        extra = extra.to(torch.int32).contiguous()
    shape = (B, dcrc.PACKET_BYTES + 1 + TAIL_BYTES[tail])
    if out is None:
        rows = torch.empty(shape, dtype=torch.uint8, device=bits.device)
    elif (out.shape != shape or out.dtype != torch.uint8
          or out.device != bits.device or not out.is_contiguous()):
        raise ValueError(f"crc_pack: out must be contiguous uint8 {shape} "
                         f"on {bits.device}")
    else:
        rows = out
    _launch(bits, rows, tail, extra, None)
    return rows


def crc_ok(bits: torch.Tensor) -> torch.Tensor:
    """bits (B, >= 2064) uint8 CUDA tensor -> (B,) bool CRC flags."""
    _check_bits(bits)
    ok = torch.empty((bits.shape[0],), dtype=torch.bool, device=bits.device)
    _launch(bits, None, TAIL_ITERS, None, ok)
    return ok
