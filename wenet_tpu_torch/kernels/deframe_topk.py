"""Wrapper of the top-k UW acquisition kernel (`csrc/deframe_topk.cu`),
and of its window code's second entry, the streaming receivers' windows
(`fsm_llrs`).

The kernel replaces `wenet_tpu/ops/deframe.py::deframe_topk` up to its BP
call (correlation, k first-maximum picks with blanking, window gather,
descramble or strip, `sd_to_llr`; XLA on the TPU).  Its plain PyTorch
version is `wenet_tpu_torch.ops.deframe.topk_windows_reference` followed by
`ops.ldpc.sd_to_llr`; `ops.deframe.deframe_topk` takes the plain version
for CPU tensors, and `llrs` here takes CUDA tensors only and launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import framing
from ..core import ldpc_tables as T
from . import launch_context, load

SMEM_LIMIT = 232448 - 2048         # shared memory the pick kernel takes
TILE = 64                          # starts a tile of the pick kernel

launches = 0          # kernel launches, counted where the launch succeeds
window_launches = 0   # `fsm_llrs` launches (the streaming receivers' windows)


class Args(ctypes.Structure):
    """`TopkArgs` of csrc/deframe_topk.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "soft", "code", "llr", "sd_out", "pos", "exhausted", "scratch")]
        + [("scratch_bytes", ctypes.c_longlong), ("n", ctypes.c_longlong),
           ("uw", ctypes.c_ulonglong)]
        + [(f, ctypes.c_int) for f in ("C", "k", "nuw", "syms", "v2",
                                       "nlive", "ntiles")])


class WindowArgs(ctypes.Structure):
    """`FsmWindowArgs` of csrc/deframe_topk.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "soft", "code", "lanes", "pos", "meta", "llr", "pos_out", "n_live")]
        + [(f, ctypes.c_int) for f in ("L", "v2")])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("deframe_topk")
    lib.deframe_topk_launch.restype = ctypes.c_int
    lib.deframe_topk_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.fsm_windows_launch.restype = ctypes.c_int
    lib.fsm_windows_launch.argtypes = [ctypes.POINTER(WindowArgs),
                                       ctypes.c_longlong, ctypes.c_void_p]
    lib.deframe_topk_init.restype = ctypes.c_int
    lib.deframe_topk_scratch_bytes.restype = ctypes.c_longlong
    lib.deframe_topk_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.deframe_topk_pick_smem_bytes.restype = ctypes.c_longlong
    lib.deframe_topk_pick_smem_bytes.argtypes = [ctypes.c_int] * 2
    return lib


_ready: set[int] = set()          # devices whose kernel attributes are set


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


@functools.lru_cache(maxsize=None)
def mode_params(mode: str):
    """(UW bits as an integer, bit j = UW bit j; UW length; symbols a
    packet) of a framing mode."""
    if mode == "v2":
        uw, syms = framing.UW_BITS_V2, framing.V2_SYMBOLS_PER_PACKET
    elif mode == "v1":
        uw, syms = framing.UW_BITS_V1, framing.V1_SYMBOLS_PER_PACKET
    else:
        raise ValueError("mode must be 'v1' or 'v2'")
    return int(sum(int(b) << j for j, b in enumerate(uw))), len(uw), syms


def _align16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=64)
def geometry(n: int, mode: str, C: int = 1):
    """(placeable starts, tiles of TILE starts, global scratch bytes of C
    streams, shared memory bytes of the pick kernel's on-chip copy of a
    stream's scores and tile maxima) of n-symbol streams; past SMEM_LIMIT
    (about 110,000 symbols) the pick kernel works on them in the global
    scratch."""
    _, nuw, syms = mode_params(mode)
    nlive = max(n - syms - nuw + 1, 0)
    ntiles = -(-nlive // TILE)
    stride = -(-nlive // 8) * 8            # int16 scores a stream keeps
    scratch = 2 * C * stride + _align16(4 * C * ntiles) + C * ntiles
    return nlive, ntiles, scratch, 2 * stride + _align16(4 * ntiles) + ntiles


@functools.lru_cache(maxsize=8)
def _code(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.resize(framing.SCRAMBLE_PM1, T.CODE_LEN),
                           device=device)


def _init(lib, index: int):
    """The pick kernel's shared memory attribute, once a device."""
    if index not in _ready:
        rc = lib.deframe_topk_init()
        if rc != 0:
            raise RuntimeError(f"deframe_topk init failed: cudaError_t {rc}")
        _ready.add(index)


def llrs(soft: torch.Tensor, mode: str, k: int, with_sd: bool = False):
    """soft (C, n) float32 contiguous CUDA tensor -> (llr (C k, 2580)
    float32, positions (C, k) int32, exhausted (C, k) bool[, sd (C k,
    2580) float32, the descrambled or stripped windows]).

    One call issues the kernel's three launches (scores, picks, windows)
    and counts as one launch."""
    global launches
    if soft.device.type != "cuda":
        raise ValueError(f"deframe_topk: needs a CUDA tensor, got "
                         f"{soft.device}")
    if soft.dtype != torch.float32:
        raise TypeError(f"deframe_topk: needs float32, got {soft.dtype}")
    if soft.dim() != 2 or soft.shape[1] < 1:
        raise ValueError(f"deframe_topk: needs shape (C, n >= 1), got "
                         f"{tuple(soft.shape)}")
    if not soft.is_contiguous():
        raise ValueError("deframe_topk: needs a contiguous tensor")
    uw, nuw, syms = mode_params(mode)
    C, n = soft.shape
    dev = soft.device
    lib = _lib()
    nlive, ntiles, scratch_bytes, _ = geometry(n, mode, C)
    llr = torch.empty((C * k, T.CODE_LEN), dtype=torch.float32, device=dev)
    sd = torch.empty_like(llr) if with_sd else None
    pos = torch.empty((C, k), dtype=torch.int32, device=dev)
    exhausted = torch.empty((C, k), dtype=torch.bool, device=dev)
    scratch = torch.empty((max(scratch_bytes, 1),), dtype=torch.uint8,
                          device=dev)
    args = Args(soft.data_ptr(), _code(dev).data_ptr(), llr.data_ptr(),
                None if sd is None else sd.data_ptr(), pos.data_ptr(),
                exhausted.data_ptr(), scratch.data_ptr(), scratch_bytes, n,
                uw, C, k, nuw, syms, int(mode == "v2"), nlive, ntiles)
    ctx, stream = launch_context(dev)
    with ctx:
        _init(lib, torch.cuda.current_device())
        rc = lib.deframe_topk_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"deframe_topk launch failed (C={C}, n={n}, k={k}):"
                           f" cudaError_t {rc}")
    launches += C * k > 0
    return (llr, pos, exhausted, sd) if with_sd else (llr, pos, exhausted)


def fsm_llrs(soft: torch.Tensor, lanes: torch.Tensor, pos: torch.Tensor,
             meta: torch.Tensor, mode: str, rows: int):
    """The streaming receivers' windows (`ops.deframe.LaneDeframer`): the
    UW-end positions the acquisition kernel (`kernels.uw_detect`) wrote,
    gathered lane after lane into one compact batch, descrambled or
    stripped and turned into LLRs by the window code the top-k kernel
    uses.  soft, lanes, pos, meta: `uw_detect.detect`'s, on one card; rows:
    the lanes' capacities summed.  -> (llr (rows, 2580) float32, positions
    (rows,) int32, n_live (1,) int32): the first n_live rows (the
    detections of all lanes, counted on the card) written, each row's
    position beside it; the rest left unwritten.  Its plain version is `ops.deframe.fsm_windows_reference`, then
    `ops.ldpc.sd_to_llr`."""
    global window_launches
    dev = soft.device
    for name, t, dtype in (("soft", soft, torch.float32),
                           ("lanes", lanes, torch.int64),
                           ("pos", pos, torch.int32),
                           ("meta", meta, torch.int32)):
        if t.device != dev or dev.type != "cuda" or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"fsm_windows: {name} needs a contiguous "
                             f"{dtype} tensor on the soft's CUDA device")
    L = lanes.shape[0]
    if rows < 1 or lanes.shape != (L, 4) or meta.shape != (L, 4):
        raise ValueError("fsm_windows: needs rows >= 1 and (L, 4) lanes and "
                         "meta")
    llr = torch.empty((rows, T.CODE_LEN), dtype=torch.float32, device=dev)
    pos_out = torch.empty((rows,), dtype=torch.int32, device=dev)
    n_live = torch.empty((1,), dtype=torch.int32, device=dev)
    args = WindowArgs(soft.data_ptr(), _code(dev).data_ptr(),
                      lanes.data_ptr(), pos.data_ptr(), meta.data_ptr(),
                      llr.data_ptr(), pos_out.data_ptr(), n_live.data_ptr(),
                      L, int(mode == "v2"))
    lib = _lib()
    ctx, stream = launch_context(dev)
    with ctx:
        rc = lib.fsm_windows_launch(ctypes.byref(args), rows, stream)
    if rc != 0:
        raise RuntimeError(f"fsm_windows launch failed (L={L}, rows={rows}):"
                           f" cudaError_t {rc}")
    window_launches += 1
    return llr, pos_out, n_live
