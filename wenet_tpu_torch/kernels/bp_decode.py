"""Wrappers of the BP kernel (`csrc/bp_decode.cu`) and its min-sum variant.

The sum-product kernel replaces `wenet_tpu/ops/ldpc_pallas2.py::_bp_kernel`;
its plain PyTorch version is `wenet_tpu_torch.ops.ldpc.decode_reference`.
The min-sum variant computes `wenet_tpu/ops/ldpc.py::decode_minsum`; its
plain version is `ops.ldpc.decode_minsum_reference`.  `ops.ldpc` takes the
plain versions for CPU tensors; these wrappers take CUDA tensors only and
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import ldpc_tables as T
from . import load

launches = 0          # sum-product launches, counted where the launch succeeds
minsum_launches = 0   # min-sum launches, likewise


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("bp_decode")
    P = ctypes.c_void_p
    lib.bp_decode_launch.restype = ctypes.c_int
    lib.bp_decode_launch.argtypes = [P, P, P, P, P, P, P, P, ctypes.c_int,
                                     ctypes.c_int, P]
    lib.bp_minsum_launch.restype = ctypes.c_int
    lib.bp_minsum_launch.argtypes = [P, P, P, P, P, P, P, P, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float, P]
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


def check_llr(llr: torch.Tensor, name: str):
    """Raise unless llr is a contiguous (B, 2580) float32 CUDA tensor."""
    if llr.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[1] != T.CODE_LEN:
        raise ValueError(f"{name}: needs shape (B, {T.CODE_LEN}), "
                         f"got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")


def _run(llr: torch.Tensor, max_iter: int, scale: float | None):
    """Launch the sum-product (scale None) or min-sum kernel; returns the
    outputs and whether a kernel was launched (not for an empty batch)."""
    B = llr.shape[0]
    lib = _lib()
    var_idx, emask, vslots, vmask = _tables(llr.device)
    bits = torch.empty((B, T.CODE_LEN), dtype=torch.uint8, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    parity_ok = torch.empty((B,), dtype=torch.bool, device=llr.device)
    if B == 0:
        return bits, iters, parity_ok, False
    args = (llr.data_ptr(), var_idx.data_ptr(), emask.data_ptr(),
            vslots.data_ptr(), vmask.data_ptr(), bits.data_ptr(),
            iters.data_ptr(), parity_ok.data_ptr(), B, int(max_iter))
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream(llr.device).cuda_stream
        if scale is None:
            rc = lib.bp_decode_launch(*args, stream)
        else:
            rc = lib.bp_minsum_launch(*args, float(scale), stream)
    if rc != 0:
        kind = "bp_decode" if scale is None else "bp_minsum"
        raise RuntimeError(f"{kind} launch failed: cudaError_t {rc}")
    return bits, iters, parity_ok, True


def decode(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """Sum-product: llr (B, 2580) float32 contiguous CUDA tensor ->
    bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool."""
    global launches
    check_llr(llr, "bp_decode")
    bits, iters, parity_ok, launched = _run(llr, max_iter, None)
    launches += launched
    return bits, iters, parity_ok


def decode_minsum(llr: torch.Tensor, max_iter: int = T.MAX_ITER,
                  scale: float = 0.8):
    """Normalized min-sum, same contract as `decode`."""
    global minsum_launches
    check_llr(llr, "bp_minsum")
    bits, iters, parity_ok, launched = _run(llr, max_iter, scale)
    minsum_launches += launched
    return bits, iters, parity_ok
