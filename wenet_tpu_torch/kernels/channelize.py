"""Wrapper of the polyphase channelizer kernel (`csrc/channelize.cu`).

The kernel replaces `wenet_tpu/ops/channelizer.py::channelize` (XLA on the
TPU); its plain PyTorch version is
`wenet_tpu_torch.ops.channelizer.channelize_reference`.
`ops.channelizer.channelize_pairs` takes the plain version for CPU
tensors; `channelize` here takes CUDA tensors only and launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import load

SMEM_LIMIT = 232448
MAX_TILE = 128                     # frames a block

launches = 0          # kernel launches, counted where the launch succeeds


class Args(ctypes.Structure):
    """`ChanArgs` of csrc/channelize.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("x", "hp", "tw", "out")]
                + [("F", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in ("N", "T", "nsel", "tile")])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("channelize")
    lib.channelize_launch.restype = ctypes.c_int
    lib.channelize_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.channelize_smem_bytes.restype = ctypes.c_longlong
    lib.channelize_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def smem_bytes(N: int, T: int, tile: int) -> int:
    """Dynamic shared memory of one block (`channelize_smem_bytes` of
    csrc/channelize.cu, mirrored so that a tile can be sized without the
    card)."""
    def a16(b):
        return (b + 15) // 16 * 16
    return a16((tile + T) * N * 8) + a16(N * (tile + 1) * 8) + a16(T * N * 4)


def tile_frames(N: int, T: int) -> int:
    """Frames a block takes: MAX_TILE, halved until the block's shared
    memory fits."""
    tile = MAX_TILE
    while tile > 1 and smem_bytes(N, T, tile) > SMEM_LIMIT:
        tile //= 2
    if smem_bytes(N, T, tile) > SMEM_LIMIT:
        raise ValueError(f"channelize: N={N}, T={T} does not fit a block")
    return tile


@functools.lru_cache(maxsize=16)
def _tables(N: int, T: int, channels: tuple, device: torch.device):
    """(taps (T, N) float32, twiddles (Nsel, N, 2) float32) on `device`:
    the prototype's phases, and for channel k the float32 cos/sin of
    `utils.compat._dft_matrix(N)` at bin (-k) mod N, built in float64 as
    there."""
    from ..ops.channelizer import prototype_lowpass
    hp = prototype_lowpass(N, T).reshape(T, N)
    p = np.arange(N, dtype=np.float64)[None, :]
    b = np.asarray([(-k) % N for k in channels], np.float64)[:, None]
    ang = (-2.0 * np.pi / N) * (p * b)
    tw = np.stack([np.cos(ang).astype(np.float32),
                   np.sin(ang).astype(np.float32)], axis=-1)
    return (torch.as_tensor(np.ascontiguousarray(hp), device=device),
            torch.as_tensor(np.ascontiguousarray(tw), device=device))


def channelize(pairs: torch.Tensor, n_channels: int, taps_per_phase: int,
               channels) -> torch.Tensor:
    """pairs (n, 2) float32 contiguous CUDA tensor -> (Nsel F, 2) float32,
    the selected channels (in the order given) one after the other,
    F = n // n_channels frames each."""
    global launches
    if pairs.device.type != "cuda":
        raise ValueError(f"channelize: needs a CUDA tensor, got "
                         f"{pairs.device}")
    if pairs.dtype != torch.float32:
        raise TypeError(f"channelize: needs float32 pairs, got {pairs.dtype}")
    if pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"channelize: needs shape (n, 2), got "
                         f"{tuple(pairs.shape)}")
    if not pairs.is_contiguous():
        raise ValueError("channelize: needs a contiguous tensor")
    N, T = int(n_channels), int(taps_per_phase)
    channels = tuple(int(k) for k in channels)
    if any(not 0 <= k < N for k in channels):
        raise ValueError(f"channelize: channels {channels} outside [0, {N})")
    dev = pairs.device
    if pairs.data_ptr() % 8:
        pairs = pairs.clone()
    F = pairs.shape[0] // N
    out = torch.empty((len(channels) * F, 2), dtype=torch.float32,
                      device=dev)
    hp, tw = _tables(N, T, channels, dev)
    args = Args(pairs.data_ptr(), hp.data_ptr(), tw.data_ptr(),
                out.data_ptr(), F, N, T, len(channels),
                tile_frames(N, T))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().channelize_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"channelize launch failed (N={N}, F={F}, "
                           f"{len(channels)} channels): cudaError_t {rc}")
    launches += F * len(channels) > 0
    return out
