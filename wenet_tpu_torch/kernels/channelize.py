"""Wrapper of the polyphase channelizer kernel (`csrc/channelize.cu`).

The kernel replaces `wenet_tpu/ops/channelizer.py::channelize` (XLA on the
TPU); its plain PyTorch version is
`wenet_tpu_torch.ops.channelizer.channelize_reference`.
`ops.channelizer.channelize_pairs` takes the plain version for CPU
tensors; `channelize` here takes CUDA tensors only and launches the kernel
or raises.  Its input is float32 (re, im) pairs ("c64") or the capture's
raw interleaved cu8 bytes ("cu8"), converted in the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import launch_context, load

SMEM_LIMIT = 232448
TAPS = 12                          # taps a phase every caller passes
KF = 9                             # frames a FIR thread filters
FIR_THREADS = 224                  # FIR threads a tile where N allows
SG = 4                             # channels a DFT item
IN_FLIGHT = 2                      # tiles copied ahead of the one filtered
#                                    (fewer at run time where a block does
#                                    not fit otherwise)
TEMPLATED_N = (4, 8, 16)           # N a template constant (with T = 12)
BLOCKS_PER_SM = 2
SM_SMEM = 233472                   # shared memory of an SM (1 KiB a block
#                                    reserved)
FORMATS = {"c64": (0, 8), "cu8": (1, 2)}         # code, bytes a sample

launches = 0          # kernel launches, counted where the launch succeeds


class Args(ctypes.Structure):
    """`ChanArgs` of csrc/channelize.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("x", "hp", "tw", "out")]
                + [("F", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in ("N", "T", "nsel", "fmt",
                                               "tile", "tw_smem", "blocks",
                                               "tiles_per_block",
                                               "in_flight")])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("channelize")
    lib.channelize_launch.restype = ctypes.c_int
    lib.channelize_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.channelize_init.restype = ctypes.c_int
    lib.channelize_smem_bytes.restype = ctypes.c_longlong
    lib.channelize_smem_bytes.argtypes = [ctypes.c_int] * 7
    return lib


_ready: set[int] = set()          # devices whose kernel attributes are set


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def fir_groups(N: int) -> int:
    """FIR groups of N phases in a tile of whole groups: FIR_THREADS // N
    rounded down to even, at least 2."""
    return max((FIR_THREADS // N) & ~1, 2)


def dft_split(items: int) -> int:
    """Lanes of a warp that share a DFT item in the run-time instantiation:
    the largest power of two up to 32 with items * S <= 256 threads (the
    templated instantiation: 1)."""
    S = 1
    while S < 32 and items * 2 * S <= 256:
        S *= 2
    return S


def y_stride(tile: int) -> int:
    """Row stride of the FIR outputs (frames a phase's row): for a tile of
    whole FIR groups padded, even and not a multiple of 8; a tile shrunk
    below two groups is not padded (a 1-frame tile: to 2)."""
    if tile < 2 * KF:
        return tile + tile % 2
    ys = tile + 2
    return ys if ys % 8 else ys + 2


def ring_samples(N: int, T: int, tile: int, fmt: str = "c64",
                 in_flight: int = IN_FLIGHT) -> int:
    """Samples the ring holds: the tile filtered, in_flight tiles and T
    frames of history, rounded up to whole 16-byte chunks, and one chunk
    more (a tile's end chunks reach up to 15 bytes past its samples)."""
    u = 16 // FORMATS[fmt][1]
    return -(-((in_flight + 1) * tile + T) * N // u) * u + u


def smem_bytes(N: int, T: int, tile: int, nsel: int, fmt: str = "c64",
               tw_smem: bool = True, in_flight: int = IN_FLIGHT) -> int:
    """Dynamic shared memory of one block (`channelize_smem_bytes` of
    csrc/channelize.cu, mirrored so that a launch can be planned without
    the card): the ring, the FIR outputs and, with tw_smem, the selected
    channels' twiddles (rounded up to a multiple of SG)."""
    return (ring_samples(N, T, tile, fmt, in_flight) * FORMATS[fmt][1]
            + N * y_stride(tile) * 8
            + (-(-nsel // SG) * SG * N * 8 if tw_smem else 0))


@functools.lru_cache(maxsize=256)
def plan(N: int, T: int, nsel: int, fmt: str = "c64") -> tuple:
    """(frames a tile, twiddles in shared memory, tiles in flight) of a
    call: IN_FLIGHT tiles in flight and a tile of whole FIR groups
    (fir_groups(N) * KF frames), halved (to even) until the block fits;
    where not even a 2-frame tile fits, one tile in flight, then none, and
    last a 1-frame tile; the twiddles in shared memory where they fit
    beside it.  Raises ValueError where nothing fits."""
    def fits(tile, d):
        return smem_bytes(N, T, tile, nsel, fmt, False, d) <= SMEM_LIMIT
    for d in range(IN_FLIGHT, -1, -1):
        tile = fir_groups(N) * KF
        while tile > 2 and not fits(tile, d):
            tile = max((tile // 2) & ~1, 2)
        if d == 0 and not fits(tile, d):
            tile = 1
        if fits(tile, d):
            return (tile, smem_bytes(N, T, tile, nsel, fmt, True, d)
                    <= SMEM_LIMIT, d)
    raise ValueError(f"channelize: N={N}, T={T} does not fit a block")


def templated(N: int, T: int, tile: int, tw_smem: bool = True,
              in_flight: int = IN_FLIGHT) -> bool:
    """True where the call runs the instantiation with N a template
    constant (T = 12, N in TEMPLATED_N, a tile of whole FIR groups, the
    twiddles in shared memory, IN_FLIGHT tiles in flight)."""
    return (N in TEMPLATED_N and T == TAPS and tile == fir_groups(N) * KF
            and tw_smem and in_flight == IN_FLIGHT)


def geometry(F: int, tile: int, sms: int, smem: int = 0):
    """(blocks, tiles a block) of an F-frame call on a card of `sms` SMs:
    persistent blocks of `smem` bytes of shared memory, BLOCKS_PER_SM a
    SM where two fit its SM_SMEM bytes (else one), each on a contiguous
    run of tiles."""
    per_sm = BLOCKS_PER_SM if BLOCKS_PER_SM * (smem + 1024) <= SM_SMEM else 1
    ntiles = max(-(-F // tile), 1)
    blocks = min(ntiles, per_sm * sms)
    per = -(-ntiles // blocks)
    return -(-ntiles // per), per


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=16)
def _tables(N: int, T: int, channels: tuple, device: torch.device):
    """(taps (T, N) float32, twiddles (nsel rounded up to SG, N, 2)
    float32) on `device`: the prototype's phases, and for each selected
    channel k the float32 cos/sin of `utils.compat._dft_matrix(N)` at bin
    (-k) mod N, built in float64 as there (padding rows of zeros)."""
    from ..ops.channelizer import prototype_lowpass
    hp = prototype_lowpass(N, T).reshape(T, N)
    bins = np.asarray([(-k) % N for k in channels], np.float64)
    ang = (-2.0 * np.pi / N) * np.outer(bins, np.arange(N, dtype=np.float64))
    tw = np.zeros((-(-len(channels) // SG) * SG, N, 2), np.float32)
    tw[:len(channels), :, 0] = np.cos(ang).astype(np.float32)
    tw[:len(channels), :, 1] = np.sin(ang).astype(np.float32)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (hp, tw))


def _init(lib, index: int):
    """The kernel's shared-memory attributes, once a device."""
    if index not in _ready:
        rc = lib.channelize_init()
        if rc != 0:
            raise RuntimeError(f"channelize init failed: cudaError_t {rc}")
        _ready.add(index)


def launch_args(x: torch.Tensor, out: torch.Tensor, N: int, T: int,
                channels: tuple, input_format: str) -> Args:
    """The kernel's arguments for a call on x (checked by `channelize`)
    into out, on the current device."""
    fmt, sb = FORMATS[input_format]
    F = x.numel() * x.element_size() // sb // N
    tile, tw_smem, in_flight = plan(N, T, len(channels), input_format)
    hp, tw = _tables(N, T, channels, x.device)
    blocks, per = geometry(F, tile, _sms(torch.cuda.current_device()),
                           smem_bytes(N, T, tile, len(channels),
                                      input_format, tw_smem, in_flight))
    return Args(x.data_ptr(), hp.data_ptr(), tw.data_ptr(), out.data_ptr(),
                F, N, T, len(channels), fmt, tile, int(tw_smem), blocks, per,
                in_flight)


def channelize(x: torch.Tensor, n_channels: int, taps_per_phase: int,
               channels, input_format: str = "c64") -> torch.Tensor:
    """x: (n, 2) float32 pairs ("c64") or n interleaved cu8 sample pairs
    as a uint8 tensor of 2 n bytes ("cu8"), contiguous, on a CUDA device
    -> (Nsel F, 2) float32: the selected channels (in the order given, each
    in [0, N)) one after the other, F = n // n_channels frames each."""
    global launches
    if input_format not in FORMATS:
        raise ValueError(f"channelize: input_format must be 'c64' or 'cu8', "
                         f"got {input_format!r}")
    if x.device.type != "cuda":
        raise ValueError(f"channelize: needs a CUDA tensor, got {x.device}")
    _, sb = FORMATS[input_format]
    if input_format == "c64":
        if x.dtype != torch.float32:
            raise TypeError(f"channelize: needs float32 pairs, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 2:
            raise ValueError(f"channelize: needs shape (n, 2), got "
                             f"{tuple(x.shape)}")
    else:
        if x.dtype != torch.uint8:
            raise TypeError(f"channelize: cu8 needs uint8 bytes, got "
                            f"{x.dtype}")
        if x.numel() % 2:
            raise ValueError("channelize: cu8 needs an even number of bytes")
    if not x.is_contiguous():
        raise ValueError("channelize: needs a contiguous tensor")
    N, T = int(n_channels), int(taps_per_phase)
    if N < 1 or T < 1:
        raise ValueError(f"channelize: N={N}, T={T}: both must be >= 1")
    channels = tuple(int(k) for k in channels)
    if any(not 0 <= k < N for k in channels):
        raise ValueError(f"channelize: channels {channels} outside [0, {N})")
    plan(N, T, len(channels), input_format)     # raises where nothing fits
    dev = x.device
    if x.data_ptr() % sb:                 # a sample split across words
        x = x.clone()
    F = x.numel() * x.element_size() // sb // N
    out = torch.empty((len(channels) * F, 2), dtype=torch.float32,
                      device=dev)
    lib = _lib()
    ctx, stream = launch_context(dev)
    with ctx:
        args = launch_args(x, out, N, T, channels, input_format)
        _init(lib, torch.cuda.current_device())
        rc = lib.channelize_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"channelize launch failed (N={N}, T={T}, F={F}, "
                           f"{len(channels)} channels, {input_format}): "
                           f"cudaError_t {rc}")
    launches += F * len(channels) > 0
    return out
