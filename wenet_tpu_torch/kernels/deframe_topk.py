"""Wrapper of the top-k UW acquisition kernel (`csrc/deframe_topk.cu`).

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
from . import load

SMEM_LIMIT = 232448 - 2048         # dynamic shared memory the kernel takes

launches = 0          # kernel launches, counted where the launch succeeds


class Args(ctypes.Structure):
    """`TopkArgs` of csrc/deframe_topk.cu."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "soft", "code", "llr", "sd_out", "pos", "exhausted", "g_words",
        "g_scores")]
        + [("n", ctypes.c_longlong), ("uw", ctypes.c_ulonglong)]
        + [(f, ctypes.c_int) for f in ("C", "k", "nuw", "syms", "v2",
                                       "nlive", "nwords")])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("deframe_topk")
    lib.deframe_topk_launch.restype = ctypes.c_int
    lib.deframe_topk_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.deframe_topk_smem_bytes.restype = ctypes.c_longlong
    lib.deframe_topk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


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


def geometry(n: int, mode: str):
    """(placeable starts, hard-bit words, shared memory bytes on chip) of
    an n-symbol stream."""
    _, nuw, syms = mode_params(mode)
    nlive = max(n - syms - nuw + 1, 0)
    nwords = -(-n // 32) + 2
    return nlive, nwords, (nwords * 4 + 15) // 16 * 16 + 2 * nlive


@functools.lru_cache(maxsize=8)
def _code(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.resize(framing.SCRAMBLE_PM1, T.CODE_LEN),
                           device=device)


def llrs(soft: torch.Tensor, mode: str, k: int, with_sd: bool = False):
    """soft (C, n) float32 contiguous CUDA tensor -> (llr (C k, 2580)
    float32, positions (C, k) int32, exhausted (C, k) bool[, sd (C k,
    2580) float32, the descrambled or stripped windows]).

    The correlation scores stay in shared memory where they fit, else in a
    global scratch buffer."""
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
    nlive, nwords, smem = geometry(n, mode)
    llr = torch.empty((C * k, T.CODE_LEN), dtype=torch.float32, device=dev)
    sd = torch.empty_like(llr) if with_sd else None
    pos = torch.empty((C, k), dtype=torch.int32, device=dev)
    exhausted = torch.empty((C, k), dtype=torch.bool, device=dev)
    g_words = g_scores = None
    if smem > SMEM_LIMIT:
        g_words = torch.empty((C, nwords), dtype=torch.int32, device=dev)
        g_scores = torch.empty((C, max(nlive, 1)), dtype=torch.int16,
                               device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = Args(soft.data_ptr(), _code(dev).data_ptr(), llr.data_ptr(),
                ptr(sd), pos.data_ptr(), exhausted.data_ptr(), ptr(g_words),
                ptr(g_scores), n, uw, C, k, nuw, syms, int(mode == "v2"),
                nlive, nwords)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().deframe_topk_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"deframe_topk launch failed (C={C}, n={n}, k={k}):"
                           f" cudaError_t {rc}")
    launches += C * k > 0
    return (llr, pos, exhausted, sd) if with_sd else (llr, pos, exhausted)
