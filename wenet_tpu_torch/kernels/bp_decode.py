"""Wrappers of the BP kernel (`csrc/bp_decode.cu`) and its min-sum variant.

The sum-product kernel replaces `wenet_tpu/ops/ldpc_pallas2.py::_bp_kernel`;
its plain PyTorch version is `wenet_tpu_torch.ops.ldpc.decode_reference`.
The min-sum variant computes `wenet_tpu/ops/ldpc.py::decode_minsum`; its
plain version is `ops.ldpc.decode_minsum_reference`.  `ops.ldpc` takes the
plain versions for CPU tensors; these wrappers take CUDA tensors only and
launch the kernel or raise.

The kernel reads the code through two packed uint16 tables built here
(`packed_tables`) and runs in the launch shape that `launch_shape` picks
from the batch: at small batches (sum-product) one codeword per cluster of
4 or 2 blocks, else one block per codeword, up to a persistent grid whose
blocks draw codewords from a queue.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import ldpc_tables as T
from . import load

VALID = 0x8000        # valid bit of a packed table entry
VAR_MASK = 0x0FFF     # variable index of a check-table entry
EDGE_MASK = 0x1FFF    # edge index (slot * 516 + check) of a var-table entry

launches = 0          # sum-product launches, counted where the launch succeeds
minsum_launches = 0   # min-sum launches, likewise


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("bp_decode")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bp_decode_launch.restype = I
    lib.bp_decode_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    lib.bp_minsum_launch.restype = I
    lib.bp_minsum_launch.argtypes = [P, P, P, P, P, P, P, I, I,
                                     ctypes.c_float, I, I, P]
    lib.bp_decode_blocks_per_sm.restype = I
    lib.bp_decode_blocks_per_sm.argtypes = [I, ctypes.POINTER(I)]
    return lib


def packed_tables() -> tuple[np.ndarray, np.ndarray]:
    """The code as the kernel reads it, slot-major uint16:
    ctab (14, 516): the variable on slot s of check c, | VALID;
    vtab (3, 2580): the edge s * 516 + c on each variable slot, | VALID.
    Invalid entries are 0."""
    var_idx, mask = T.check_edges()                 # (516, 14)
    vslots, vmask = T.var_edges()                   # (2580, 3): c * 14 + s
    ctab = np.where(mask, var_idx | VALID, 0).T
    c, s = np.divmod(vslots, T.MAX_CHECK_DEG)
    vtab = np.where(vmask, (s * T.N_PARITY + c) | VALID, 0).T
    return (np.ascontiguousarray(ctab, np.uint16),
            np.ascontiguousarray(vtab, np.uint16))


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The packed tables on `device` (int16 tensors of the uint16 bits)."""
    return tuple(torch.from_numpy(a.view(np.int16)).to(device)
                 for a in packed_tables())


def launch_shape(batch: int, num_sms: int, blocks_per_sm: int,
                 minsum: bool = False):
    """(cluster size, grid in blocks) for a batch.  Sum-product splits a
    codeword over a cluster of 4 blocks (4 lanes per check) while the
    clusters take at most half the SMs, and over 2 while they fit on the
    SMs; past that, and always for min-sum (whose cheap check update gains
    less than the cluster barriers cost), one block per codeword, at most
    num_sms * blocks_per_sm of them, which draw the codewords past the grid
    from a queue."""
    if batch <= 0:
        return 1, 0
    if not minsum:
        if 4 * batch <= num_sms // 2:
            return 4, 4 * batch
        if 2 * batch <= num_sms:
            return 2, 2 * batch
    return 1, min(batch, num_sms * blocks_per_sm)


@functools.lru_cache(maxsize=16)
def card_shape(device: torch.device, minsum: bool = False):
    """(SMs, resident unclustered blocks per SM) of the kernel on `device`."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().bp_decode_blocks_per_sm(int(minsum), ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"bp_decode occupancy query failed: "
                           f"cudaError_t {rc}, {blocks.value} blocks per SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, blocks.value


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
    ctab, vtab = _tables(llr.device)
    bits = torch.empty((B, T.CODE_LEN), dtype=torch.uint8, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    parity_ok = torch.empty((B,), dtype=torch.bool, device=llr.device)
    if B == 0:
        return bits, iters, parity_ok, False
    minsum = scale is not None
    cluster, grid = launch_shape(B, *card_shape(llr.device, minsum), minsum)
    queue = None                       # the grid's codeword queue, if any
    if grid < B:
        queue = torch.empty((1,), dtype=torch.int32, device=llr.device)
    args = (llr.data_ptr(), ctab.data_ptr(), vtab.data_ptr(),
            bits.data_ptr(), iters.data_ptr(), parity_ok.data_ptr(),
            None if queue is None else queue.data_ptr(), B, int(max_iter))
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream(llr.device).cuda_stream
        if scale is None:
            rc = lib.bp_decode_launch(*args, cluster, grid, stream)
        else:
            rc = lib.bp_minsum_launch(*args, float(scale), cluster, grid,
                                      stream)
    if rc != 0:
        kind = "bp_decode" if scale is None else "bp_minsum"
        raise RuntimeError(f"{kind} launch failed (cluster {cluster}, grid "
                           f"{grid}): cudaError_t {rc}")
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
