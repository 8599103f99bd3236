"""Wrapper of the streaming receivers' UW acquisition kernel
(`csrc/uw_detect.cu`).

The kernel replaces no TPU kernel: the JAX package runs the reference's
acquisition FSM on the host (`wenet_tpu/native/deframe_fsm.c`), as the
port's host path does (`csrc/deframe_fsm.c`).  It runs that FSM bit for
bit on the card, over L lanes' soft-bit buffers where the demod left
them, with each lane's carried register in front of its buffer and the
buffer's tail rule (`ops.deframe.StreamDeframer.consume`) after it.  Its
plain PyTorch version is `wenet_tpu_torch.ops.deframe.
uw_detect_lanes_reference`; `ops.deframe.uw_detect_lanes` takes the plain
version for CPU tensors, and `detect` here takes CUDA tensors only and
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import framing
from . import launch_context, load

SMEM_LIMIT = 232448 - 2048         # shared memory the pick kernel takes

launches = 0          # kernel launches, counted where the launch succeeds


class Args(ctypes.Structure):
    """`UwArgs` of csrc/uw_detect.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "soft", "lanes", "init", "meta", "pos", "scratch")]
        + [("W", ctypes.c_longlong), ("uw", ctypes.c_ulonglong)]
        + [(f, ctypes.c_int) for f in ("L", "nuw", "allowed", "syms")])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("uw_detect")
    lib.uw_detect_launch.restype = ctypes.c_int
    lib.uw_detect_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_longlong,
                                     ctypes.c_void_p]
    lib.uw_detect_init.restype = ctypes.c_int
    lib.uw_detect_words.restype = ctypes.c_longlong
    lib.uw_detect_words.argtypes = [ctypes.c_longlong]
    return lib


_ready: set[int] = set()          # devices whose kernel attributes are set


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


@functools.lru_cache(maxsize=None)
def mode_params(mode: str):
    """(UW as the FSM's register, UW bit 0 at bit nuw - 1; nuw; the errors
    allowed; symbols a packet) of a framing mode."""
    if mode == "v2":
        uw, allowed, syms = (framing.UW_BITS_V2, framing.V2_UW_ALLOWED_ERRORS,
                             framing.V2_SYMBOLS_PER_PACKET)
    elif mode == "v1":
        uw, allowed, syms = (framing.UW_BITS_V1, framing.V1_UW_ALLOWED_ERRORS,
                             framing.V1_SYMBOLS_PER_PACKET)
    else:
        raise ValueError("mode must be 'v1' or 'v2'")
    nuw = len(uw)
    reg = sum(int(b) << (nuw - 1 - i) for i, b in enumerate(uw))
    return reg, nuw, int(allowed), int(syms)


def words(n_max: int) -> int:
    """Scratch words a lane takes for lanes of at most n_max symbols (whole
    score blocks of 1,024 symbols, at least one)."""
    return max(-(-n_max // 1024), 1) * 32


def on_chip(n_max: int) -> bool:
    """Whether the pick kernel copies a lane's words into shared memory
    (lanes up to about 900,000 symbols) or works on the global scratch."""
    return 8 * words(n_max) <= SMEM_LIMIT


def _init(lib, index: int):
    """The pick kernel's shared memory attribute, once a device."""
    if index not in _ready:
        rc = lib.uw_detect_init()
        if rc != 0:
            raise RuntimeError(f"uw_detect init failed: cudaError_t {rc}")
        _ready.add(index)


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"uw_detect: {name} needs a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"uw_detect: {name} needs {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"uw_detect: {name} needs shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"uw_detect: {name} needs a contiguous tensor")


def detect(soft: torch.Tensor, lanes: torch.Tensor, init: torch.Tensor,
           meta: torch.Tensor, pos: torch.Tensor, mode: str, n_max: int):
    """Queue the acquisition of L lanes on the soft tensor's card.

    soft: (S,) float32, the lanes' buffers one after another; lanes: (L,
    4) int64, a lane's offset in soft, its symbols n, its first position
    slot and its capacity; init: (L, 4) int32, the last push's meta (the
    register in front of each buffer in columns 2 and 3; zeros at the
    stream's start); n_max: the longest lane's n.  Writes meta (L, 4)
    int32 (count, cut, the register after the cut, low and high 32 bits)
    and each lane's UW-end positions into pos (int32) from its first slot,
    at most its capacity of them (a count above it means they did not
    fit).  init and meta may be one tensor: a lane's register is read
    before its row is written.  Two launches, counted as one."""
    global launches
    L = lanes.shape[0] if lanes.dim() == 2 else -1
    _check(soft, "soft", torch.float32)
    _check(lanes, "lanes", torch.int64, (L, 4))
    _check(init, "init", torch.int32, (L, 4))
    _check(meta, "meta", torch.int32, (L, 4))
    _check(pos, "pos", torch.int32)
    if L < 1 or len({soft.device, lanes.device, init.device, meta.device,
                     pos.device}) != 1:
        raise ValueError("uw_detect: needs L >= 1 lanes, every tensor on "
                         "one device")
    uw, nuw, allowed, syms = mode_params(mode)
    lib = _lib()
    W = words(n_max)
    scratch = torch.empty((2 * L * W,), dtype=torch.int32, device=soft.device)
    args = Args(soft.data_ptr(), lanes.data_ptr(), init.data_ptr(),
                meta.data_ptr(), pos.data_ptr(), scratch.data_ptr(), W, uw,
                L, nuw, allowed, syms)
    ctx, stream = launch_context(soft.device)
    with ctx:
        _init(lib, torch.cuda.current_device())
        rc = lib.uw_detect_launch(ctypes.byref(args), n_max, stream)
    if rc != 0:
        raise RuntimeError(f"uw_detect launch failed (L={L}, n_max={n_max}):"
                           f" cudaError_t {rc}")
    launches += 1
