"""Sum-product BP with the var<->edge maps as one-hot matrix products
(counterpart of wenet_tpu/ops/ldpc_pallas.py).

`decode_onehot` keeps `decode_pallas`'s public contract: llr (B, 2580)
float32 in; bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool
out; a ragged last batch tile does not disturb the output.  A CUDA tensor
launches the tensor-core kernel (`wenet_tpu_torch.kernels.bp_onehot`); a
CPU tensor takes `decode_onehot_reference`, the plain-torch emulation of
the same tiled products.  Both equal `ops.ldpc.decode_reference` exactly.

Layout (the Pallas kernel's): edges slot-major, edge e = s * 640 + c for
check c < 516 (padded to 640) and slot s < 14 (padded to 16), so
EDGES_P = 10240; vars padded to VARS_P = 2688.

The maps are one-hot matrices, cut into the tiles of one
`mma.sync.m16n8k16` B operand (16 rows of K by 8 columns of N, bf16) and
kept as lists of the nonzero tiles only:

  * var->edge broadcast: K = vars, N = edges, 5,867 nonzero tiles of
    215,040;
  * edge->var, one matrix per var slot k = 0..2 (the k-th edge of each var
    in check order): K = edges, N = vars, 2,028 + 2,107 + 1,963 tiles.

Every output column of each matrix has at most one 1, so a product only
moves a value.  Tensor cores take bf16, not float32: the float32 operand is
cut into three bf16 pieces by `split3`, each piece goes through the product
exactly (one nonzero term per column, float32 sums), and the pieces are
summed back in float32, exactly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import ldpc_tables as T
from ..kernels import bp_onehot
from ..kernels.bp_onehot import BATCH_TILE, CHECKS_P, EDGES_P, VARS_P
from ..kernels.bp_onehot import SLOTS_P as SLOTS
from .ldpc import _parity_ok, decoder_tables, phi0

TILE_K = 16               # mma.sync.m16n8k16: K depth of a B tile
TILE_N = 8                # and its N width


# ------------------------------------------------------------ host tables


@functools.lru_cache(maxsize=1)
def edge_layout():
    """Padded slot-major edge layout (numpy):
    edge_var (EDGES_P,) int32 (0 where invalid), edge_mask (EDGES_P,) bool,
    var_edge (CODE_LEN, 3) int32: padded edge index of each var's k-th edge
    in check order (0 where none), var_mask (CODE_LEN, 3) bool."""
    var_idx, mask = T.check_edges()                     # (516, 14)
    vi = np.zeros((SLOTS, CHECKS_P), np.int32)
    mk = np.zeros((SLOTS, CHECKS_P), bool)
    vi[: T.MAX_CHECK_DEG, : T.N_PARITY] = var_idx.T
    mk[: T.MAX_CHECK_DEG, : T.N_PARITY] = mask.T
    vslots, vmask = T.var_edges()                       # flat c * 14 + s
    c, s = vslots // T.MAX_CHECK_DEG, vslots % T.MAX_CHECK_DEG
    var_edge = np.where(vmask, s * CHECKS_P + c, 0).astype(np.int32)
    return vi.reshape(-1), mk.reshape(-1), var_edge, vmask


class TileList(NamedTuple):
    """Nonzero 16x8 tiles of a one-hot (K, N) matrix, grouped by output
    tile: the entries of output tile n are ptr[n]..ptr[n+1]-1."""
    K: int
    N: int
    ptr: np.ndarray           # (N / 8 + 1,) int32
    ktile: np.ndarray         # (T,) int32: k-tile of each entry
    ntile: np.ndarray         # (T,) int32: output tile of each entry
    tiles: np.ndarray         # (T, 16, 8) uint8 one-hot tile


def _tile_list(rows: np.ndarray, cols: np.ndarray, K: int, N: int) -> TileList:
    """Tile list of the one-hot matrix with ones at (rows[i], cols[i])."""
    nk = K // TILE_K
    key = (cols // TILE_N).astype(np.int64) * nk + rows // TILE_K
    uniq, inv = np.unique(key, return_inverse=True)
    tiles = np.zeros((len(uniq), TILE_K, TILE_N), np.uint8)
    tiles[inv, rows % TILE_K, cols % TILE_N] = 1
    ntile = (uniq // nk).astype(np.int32)
    counts = np.bincount(ntile, minlength=N // TILE_N)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return TileList(K, N, ptr, (uniq % nk).astype(np.int32), ntile, tiles)


@functools.lru_cache(maxsize=1)
def tile_lists():
    """(broadcast, (slot0, slot1, slot2)): the tile lists of the var->edge
    broadcast (K = VARS_P, N = EDGES_P) and of the three per-slot edge->var
    matrices (K = EDGES_P, N = VARS_P)."""
    edge_var, edge_mask, var_edge, var_mask = edge_layout()
    e = np.flatnonzero(edge_mask)
    bcast = _tile_list(edge_var[e], e, VARS_P, EDGES_P)
    slots = []
    for k in range(T.MAX_COL_W):
        v = np.flatnonzero(var_mask[:, k])
        slots.append(_tile_list(var_edge[v, k], v, EDGES_P, VARS_P))
    return bcast, tuple(slots)


def densify(tl: TileList) -> np.ndarray:
    """The (K, N) 0/1 matrix a tile list stands for."""
    out = np.zeros((tl.K, tl.N), np.uint8)
    for t in range(len(tl.ktile)):
        k0, n0 = tl.ktile[t] * TILE_K, tl.ntile[t] * TILE_N
        out[k0:k0 + TILE_K, n0:n0 + TILE_N] |= tl.tiles[t]
    return out


def fragment_order(tiles: np.ndarray) -> np.ndarray:
    """(T, 16, 8) B tiles -> (T, 32, 4): for lane l = 4 g + q, the four
    elements of its mma.m16n8k16 B fragment, rows 2q, 2q+1, 2q+8, 2q+9 of
    column g (PTX ISA, matrix fragments for mma.m16n8k16 .bf16)."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    rows = np.stack([2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9], axis=1)
    return tiles[:, rows, g[:, None]]


def split3(x: torch.Tensor):
    """float32 -> three bf16 pieces (hi, mid, lo) with
    (hi + mid) + lo == x exactly in float32.

    Each piece keeps the top 8 significant bits of what is left (a
    truncation by bit mask, as the kernel does it; the subtractions are
    exact).  Exact for |x| >= 2**-110 and for x == 0 (also for -0, inf
    excepted).  Below 2**-110 the lowest bits of x lie under bf16's
    smallest subnormal, 2**-133: lo drops them, so the sum differs from x
    by less than 2**-133 toward zero (and is 0 for |x| < 2**-133).  BP
    never meets such values: messages are 0 or at least phi0(10) ~ 9.1e-5,
    and an LLR that small decides nothing.
    """
    mask = torch.tensor(-65536, dtype=torch.int32)       # 0xFFFF0000
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    r1 = x - hi
    mid = (r1.view(torch.int32) & mask).view(torch.float32)
    r2 = r1 - mid
    lo = (r2.view(torch.int32) & mask).view(torch.float32)
    return (hi.to(torch.bfloat16), mid.to(torch.bfloat16),
            lo.to(torch.bfloat16))


class DeviceTiles(NamedTuple):
    """A tile list on a torch device, for `onehot_product_reference`."""
    K: int
    N: int
    ktile: torch.Tensor       # (T,) int64
    ntile: torch.Tensor       # (T,) int64
    tiles: torch.Tensor       # (T, 16, 8) float32


@functools.lru_cache(maxsize=8)
def device_tables(device: torch.device):
    """(broadcast, slots, edge mask (EDGES_P,) bool) on `device`."""
    bcast, slots = tile_lists()
    _, edge_mask, _, _ = edge_layout()

    def put(tl: TileList) -> DeviceTiles:
        return DeviceTiles(
            tl.K, tl.N,
            torch.as_tensor(tl.ktile, dtype=torch.int64, device=device),
            torch.as_tensor(tl.ntile, dtype=torch.int64, device=device),
            torch.as_tensor(tl.tiles, dtype=torch.float32, device=device))

    return (put(bcast), tuple(put(s) for s in slots),
            torch.as_tensor(edge_mask, device=device))


def onehot_product_reference(x: torch.Tensor, tiles: DeviceTiles
                             ) -> torch.Tensor:
    """x (B, K) float32 @ the one-hot (K, N) matrix -> (B, N) float32, as
    the kernel computes it: each bf16 piece of `split3(x)` times each
    nonzero 16x8 tile, float32 sums per output tile, the three pieces
    summed back as (hi + mid) + lo."""
    B = x.shape[0]
    if x.shape[1] != tiles.K:
        raise ValueError(f"onehot_product_reference: x has {x.shape[1]} "
                         f"columns, the matrix {tiles.K} rows")
    cols = tiles.ktile[:, None] * TILE_K + torch.arange(TILE_K,
                                                        device=x.device)
    parts = []
    for piece in split3(x.contiguous()):
        a = piece.float()[:, cols]                            # (B, T, 16)
        prod = torch.einsum("btk,tkn->btn", a, tiles.tiles)   # (B, T, 8)
        acc = torch.zeros(B, tiles.N // TILE_N, TILE_N, dtype=torch.float32,
                          device=x.device)
        parts.append(acc.index_add_(1, tiles.ntile, prod).reshape(B, tiles.N))
    return (parts[0] + parts[1]) + parts[2]


@functools.lru_cache(maxsize=8)
def kernel_tables(device: torch.device) -> bp_onehot.KernelTables:
    """The kernel's tables on `device`: tile lists with their B tiles in
    mma fragment order, the slot lists concatenated (the entries of var
    tile n, slot k start at sl_ptr[k * 336 + n]), and the edge layout."""
    bcast, slots = tile_lists()
    edge_var, edge_mask, _, _ = edge_layout()
    offs = np.cumsum([0] + [len(s.ktile) for s in slots])
    sl_ptr = np.concatenate([s.ptr[:-1] + o for s, o in zip(slots, offs)]
                            + [offs[-1:]])

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    def frags(tiles):
        return put(fragment_order(tiles), torch.bfloat16)

    return bp_onehot.KernelTables(
        put(bcast.ptr, torch.int32), put(bcast.ktile, torch.int32),
        frags(bcast.tiles), put(sl_ptr, torch.int32),
        put(np.concatenate([s.ktile for s in slots]), torch.int32),
        frags(np.concatenate([s.tiles for s in slots])),
        put(edge_var, torch.int32), put(edge_mask, torch.uint8))


# ------------------------------------------------------------------ decode


def decode_onehot_reference(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """Plain-torch emulation of the one-hot kernel (any device): the same
    padded slot-major layout and the same tiled products in bf16 pieces.
    Returns bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool."""
    bcast, slots, emask = device_tables(llr.device)
    B = llr.shape[0]
    fmask = emask.to(torch.float32)
    llr_p = torch.zeros(B, VARS_P, dtype=torch.float32, device=llr.device)
    llr_p[:, : T.CODE_LEN] = llr

    llr_e = onehot_product_reference(llr_p, bcast)            # (B, EDGES_P)
    vmsg = phi0(torch.abs(llr_e)) * fmask
    vsgn = ((llr_e < 0) & emask).int()
    bits = torch.zeros(B, VARS_P, dtype=torch.uint8, device=llr.device)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=llr.device)
    converged = torch.zeros(B, dtype=torch.bool, device=llr.device)

    for it in range(max_iter):
        # check side in slot order 0..13 over the 640-wide slot stride
        v = vmsg.view(B, SLOTS, CHECKS_P)
        sg = vsgn.view(B, SLOTS, CHECKS_P)
        phi_sum = v[:, 0]
        for s in range(1, T.MAX_CHECK_DEG):
            phi_sum = phi_sum + v[:, s]
        sgn_tot = sg.sum(dim=1, keepdim=True) & 1             # (B, 1, 640)
        r_mag = phi0(phi_sum[:, None, :] - v)
        r_sgn = (sgn_tot ^ sg) & 1
        rmsg = (torch.where(r_sgn == 1, -r_mag, r_mag).reshape(B, EDGES_P)
                * fmask)
        checks_ok = torch.all(sgn_tot[:, 0] == 0, dim=-1)     # padded: ok

        # var side: three edge->var products, summed in slot order
        g = [onehot_product_reference(rmsg, t) for t in slots]
        qi = llr_p + ((g[0] + g[1]) + g[2])
        new_bits = (qi < 0).to(torch.uint8)
        q_e = onehot_product_reference(qi, bcast) - rmsg
        new_vmsg = phi0(torch.abs(q_e)) * fmask
        new_vsgn = ((q_e <= 0) & emask).int()

        data_zero = torch.all(new_bits[:, : T.N_DATA] == 0, dim=-1)
        trigger = data_zero | checks_ok

        upd = ~converged
        vmsg = torch.where(upd[:, None], new_vmsg, vmsg)
        vsgn = torch.where(upd[:, None], new_vsgn, vsgn)
        bits = torch.where(upd[:, None], new_bits, bits)
        iters = torch.where(upd, torch.tensor(it + 1, dtype=torch.int32,
                                              device=llr.device), iters)
        converged = converged | trigger
        if bool(converged.all()):
            break

    bits = bits[:, : T.CODE_LEN].contiguous()
    var_idx, mask, _, _ = decoder_tables(llr.device)
    return bits, iters, _parity_ok(bits, var_idx, mask)


def decode_onehot(llr: torch.Tensor, max_iter: int = T.MAX_ITER,
                  batch_tile: int = BATCH_TILE):
    """One-hot BP decode: the tensor-core kernel for a CUDA tensor, the
    plain emulation for a CPU tensor.  The batch is cut into tiles of 16
    codewords (the mma's M); no other `batch_tile` is taken."""
    if batch_tile != BATCH_TILE:
        raise ValueError(f"decode_onehot: the batch tile is {BATCH_TILE}, "
                         f"got {batch_tile}")
    if llr.device.type == "cuda":
        return bp_onehot.decode(llr, kernel_tables(llr.device), max_iter)
    if llr.device.type == "cpu":
        return decode_onehot_reference(llr, max_iter)
    raise ValueError(f"decode_onehot: unsupported device {llr.device}")
