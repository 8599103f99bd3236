"""Wrapper of the sum-product BP kernel (`csrc/bp_decode.cu`).

The kernel replaces `wenet_tpu/ops/ldpc_pallas2.py::_bp_kernel`.  Its plain
PyTorch version is `wenet_tpu_torch.ops.ldpc.decode_reference`, which
`ops.ldpc.decode` takes for CPU tensors; this wrapper takes CUDA tensors
only and launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import ldpc_tables as T
from . import load

launches = 0          # kernel launches, counted where the launch succeeds


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("bp_decode")
    P = ctypes.c_void_p
    lib.bp_decode_launch.restype = ctypes.c_int
    lib.bp_decode_launch.argtypes = [P, P, P, P, P, P, P, P, ctypes.c_int,
                                     ctypes.c_int, P]
    return lib


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """Flat int32/uint8 index tables of the code on `device`."""
    var_idx, mask = T.check_edges()
    vslots, vmask = T.var_edges()

    def put(a, dtype):
        return torch.as_tensor(a.reshape(-1)).to(dtype).to(device).contiguous()

    return (put(var_idx, torch.int32), put(mask, torch.uint8),
            put(vslots, torch.int32), put(vmask, torch.uint8))


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def decode(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """llr (B, 2580) float32 contiguous CUDA tensor ->
    bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool."""
    global launches
    if llr.device.type != "cuda":
        raise ValueError(f"bp_decode: needs a CUDA tensor, got {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"bp_decode: needs float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != T.CODE_LEN:
        raise ValueError(f"bp_decode: needs shape (B, {T.CODE_LEN}), "
                         f"got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("bp_decode: needs a contiguous tensor")
    B = llr.shape[0]
    lib = _lib()
    var_idx, emask, vslots, vmask = _tables(llr.device)
    bits = torch.empty((B, T.CODE_LEN), dtype=torch.uint8, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    parity_ok = torch.empty((B,), dtype=torch.bool, device=llr.device)
    if B == 0:
        return bits, iters, parity_ok
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream(llr.device).cuda_stream
        rc = lib.bp_decode_launch(
            llr.data_ptr(), var_idx.data_ptr(), emask.data_ptr(),
            vslots.data_ptr(), vmask.data_ptr(), bits.data_ptr(),
            iters.data_ptr(), parity_ok.data_ptr(), B, int(max_iter), stream)
    if rc != 0:
        raise RuntimeError(f"bp_decode launch failed: cudaError_t {rc}")
    launches += 1
    return bits, iters, parity_ok
