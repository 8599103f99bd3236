"""Wrapper of the one-hot tensor-core BP kernel (`csrc/bp_onehot.cu`).

The kernel replaces `wenet_tpu/ops/ldpc_pallas.py::_bp_kernel`.  Its plain
PyTorch version is `wenet_tpu_torch.ops.ldpc_onehot.decode_onehot_reference`,
which `ops.ldpc_onehot.decode_onehot` takes for CPU tensors; this wrapper
takes CUDA tensors only and launches the kernel or raises.

A tile of 8 codewords (the N of `mma.m16n8k16`) runs on a cluster of 8
blocks, each owning a share of the checks and of the variables; the
clusters walk the tiles with a fixed stride.  The tables the kernel reads
(one packed uint16 region per block of the cluster) are built on the host
by `ops.ldpc_onehot.kernel_tables`; the constants below are the kernel's
compile-time layout and must match `csrc/bp_onehot.cu`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import ldpc_tables as T
from . import load
from .bp_decode import check_llr

CLUSTER = 8               # blocks per tile of codewords
TILE_CW = 8               # codewords per tile: the N of mma.m16n8k16
CHECKS_B = 65             # checks of a block (516 = 4 * 65 + 4 * 64): the
#                           slot stride of its edges, e = s * 65 + c
EDGES_B = 912             # a block's edge slots, 14 * 65 padded to 16
LOCAL_VARS_B = 768        # variables a block's checks touch, at most
OWN_VARS_B = 324          # variables a block owns (2580 / 8), padded
THREADS = 544             # 17 warps: a thread per (check, codeword)
HEADER = 24               # uint16 header of a block's table region

# dynamic shared memory in front of the table region, bytes: qi of the
# local variables and r of the edges, each in float32 and in bf16 pieces
# (the phi buffer shares r's pieces), the var-side sums, llr and qi of the
# owned variables, the vote flags
FIXED_SMEM = (LOCAL_VARS_B * TILE_CW * (4 + 6) + EDGES_B * TILE_CW * (4 + 6)
              + 3 * OWN_VARS_B * TILE_CW * 4 + 2 * OWN_VARS_B * TILE_CW * 4
              + 64 * 4)
SMEM_LIMIT = 232448       # shared memory a block can use on sm_90

launches = 0              # kernel launches, counted where the launch succeeds


class LaunchShape(NamedTuple):
    cluster: int          # blocks per cluster (per tile of codewords)
    blocks: int           # grid size in blocks
    smem_bytes: int       # dynamic shared memory per block


def smem_bytes(region_len: int) -> int:
    """Dynamic shared memory of a block whose table region holds
    `region_len` uint16 (a multiple of 8)."""
    return FIXED_SMEM + 2 * region_len


def launch_shape(batch: int, max_clusters: int, region_len: int
                 ) -> LaunchShape:
    """One cluster per tile of 8 codewords while the tiles fit on the card
    (`max_clusters` resident clusters); past that a persistent grid of
    `max_clusters` clusters, each walking every max_clusters-th tile."""
    tiles = -(-batch // TILE_CW)
    clusters = min(tiles, max_clusters)
    return LaunchShape(CLUSTER, clusters * CLUSTER, smem_bytes(region_len))


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("bp_onehot")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bp_onehot_launch.restype = I
    lib.bp_onehot_launch.argtypes = [P, P, I, P, P, P, I, I, I, P]
    lib.bp_onehot_max_clusters.restype = I
    lib.bp_onehot_max_clusters.argtypes = [I, ctypes.POINTER(I)]
    lib.bp_onehot_smem_bytes.restype = I
    lib.bp_onehot_smem_bytes.argtypes = [I]
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


@functools.lru_cache(maxsize=16)
def card_clusters(device: torch.device, region_len: int) -> int:
    """Clusters of the kernel that the card can hold at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().bp_onehot_max_clusters(region_len, ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"bp_onehot cluster occupancy query failed: "
                           f"cudaError_t {rc}, {n.value} clusters")
    return n.value


def decode(llr: torch.Tensor, tables: torch.Tensor,
           max_iter: int = T.MAX_ITER):
    """llr (B, 2580) float32 contiguous CUDA tensor, tables (8, L) int16
    (`ops.ldpc_onehot.kernel_tables`) ->
    bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool."""
    global launches
    check_llr(llr, "bp_onehot")
    if (tables.device != llr.device or tables.dtype != torch.int16
            or tables.dim() != 2 or tables.shape[0] != CLUSTER
            or tables.shape[1] % 8 or not tables.is_contiguous()):
        raise ValueError("bp_onehot: tables must be ops.ldpc_onehot."
                         "kernel_tables on the llr's device")
    B = llr.shape[0]
    dev = llr.device
    bits = torch.empty((B, T.CODE_LEN), dtype=torch.uint8, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    parity_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return bits, iters, parity_ok
    region = tables.shape[1]
    shape = launch_shape(B, card_clusters(dev, region), region)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bp_onehot_launch(
            llr.data_ptr(), tables.data_ptr(), region, bits.data_ptr(),
            iters.data_ptr(), parity_ok.data_ptr(), B, int(max_iter),
            shape.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"bp_onehot launch failed (cluster "
                           f"{shape.cluster}, {shape.blocks} blocks, "
                           f"{shape.smem_bytes} bytes of shared memory): "
                           f"cudaError_t {rc}")
    launches += 1
    return bits, iters, parity_ok
