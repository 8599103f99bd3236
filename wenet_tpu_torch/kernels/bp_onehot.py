"""Wrapper of the one-hot tensor-core BP kernel (`csrc/bp_onehot.cu`).

The kernel replaces `wenet_tpu/ops/ldpc_pallas.py::_bp_kernel`.  Its plain
PyTorch version is `wenet_tpu_torch.ops.ldpc_onehot.decode_onehot_reference`,
which `ops.ldpc_onehot.decode_onehot` takes for CPU tensors; this wrapper
takes CUDA tensors only and launches the kernel or raises.  The tile lists
it reads are built on the host by `ops.ldpc_onehot.kernel_tables`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import ldpc_tables as T
from . import load
from .bp_decode import check_llr

# the kernel's compile-time layout (csrc/bp_onehot.cu)
CHECKS_P = 640            # 516 checks padded
SLOTS_P = 16              # 14 edge slots padded
EDGES_P = CHECKS_P * SLOTS_P          # 10240, slot-major: e = s * 640 + c
VARS_P = 2688             # 2580 vars padded
BATCH_TILE = 16           # codewords per block: the M of mma.m16n8k16

launches = 0              # kernel launches, counted where the launch succeeds


class KernelTables(NamedTuple):
    """Device tables of the kernel: the broadcast tile list (ptr per edge
    tile, k-tile and B fragment per entry), the three edge->var slot lists
    concatenated (ptr indexed k * 336 + var tile), and the padded edge
    layout."""
    bc_ptr: torch.Tensor      # (1281,) int32
    bc_k: torch.Tensor        # (T_b,) int32
    bc_frag: torch.Tensor     # (T_b, 32, 4) bfloat16
    sl_ptr: torch.Tensor      # (3 * 336 + 1,) int32
    sl_k: torch.Tensor        # (T_s,) int32
    sl_frag: torch.Tensor     # (T_s, 32, 4) bfloat16
    edge_var: torch.Tensor    # (EDGES_P,) int32
    emask: torch.Tensor       # (EDGES_P,) uint8


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("bp_onehot")
    P = ctypes.c_void_p
    lib.bp_onehot_launch.restype = ctypes.c_int
    lib.bp_onehot_launch.argtypes = [P] * 16 + [ctypes.c_int] * 3 + [P]
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def decode(llr: torch.Tensor, tables: KernelTables,
           max_iter: int = T.MAX_ITER):
    """llr (B, 2580) float32 contiguous CUDA tensor ->
    bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool."""
    global launches
    check_llr(llr, "bp_onehot")
    B = llr.shape[0]
    dev = llr.device
    Bp = -(-B // BATCH_TILE) * BATCH_TILE
    if B == 0:
        return (torch.empty((0, T.CODE_LEN), dtype=torch.uint8, device=dev),
                torch.empty((0,), dtype=torch.int32, device=dev),
                torch.empty((0,), dtype=torch.bool, device=dev))
    lib = _lib()
    llr_p = torch.zeros((Bp, VARS_P), dtype=torch.float32, device=dev)
    llr_p[:B, : T.CODE_LEN] = llr
    qi = torch.empty((Bp, VARS_P), dtype=torch.float32, device=dev)
    vmsg = torch.empty((Bp, EDGES_P), dtype=torch.float32, device=dev)
    rmsg = torch.empty((Bp, EDGES_P), dtype=torch.float32, device=dev)
    vsgn = torch.empty((Bp, EDGES_P), dtype=torch.uint8, device=dev)
    bits_p = torch.empty((Bp, VARS_P), dtype=torch.uint8, device=dev)
    iters = torch.empty((Bp,), dtype=torch.int32, device=dev)
    parity_ok = torch.empty((Bp,), dtype=torch.bool, device=dev)
    ptrs = [t.data_ptr() for t in (llr_p, qi, vmsg, rmsg, vsgn, bits_p,
                                   iters, parity_ok, *tables)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bp_onehot_launch(*ptrs, Bp, B, int(max_iter), stream)
    if rc != 0:
        raise RuntimeError(f"bp_onehot launch failed: cudaError_t {rc}")
    launches += 1
    return bits_p[:B, : T.CODE_LEN].contiguous(), iters[:B], parity_ok[:B]
