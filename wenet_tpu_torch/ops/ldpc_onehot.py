"""Sum-product BP with the var<->edge maps as one-hot matrix products
(counterpart of wenet_tpu/ops/ldpc_pallas.py).

`decode_onehot` keeps `decode_pallas`'s public contract: llr (B, 2580)
float32 in; bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool
out; a ragged last batch tile does not disturb the output.  A CUDA tensor
launches the tensor-core kernel (`wenet_tpu_torch.kernels.bp_onehot`, on
the tables `kernel_tables` builds below); a CPU tensor takes
`decode_onehot_reference`, the plain-torch emulation of the Pallas
kernel's tiled products.  Both equal `ops.ldpc.decode_reference` exactly.

The plain version keeps the Pallas kernel's layout: edges slot-major,
edge e = s * 640 + c for check c < 516 (padded to 640) and slot s < 14
(padded to 16), so EDGES_P = 10240; vars padded to VARS_P = 2688.  Its
maps are one-hot matrices cut into 16x8 tiles (16 rows of K by 8 columns
of N), kept as lists of the nonzero tiles only:

  * var->edge broadcast: K = vars, N = edges, 5,867 nonzero tiles of
    215,040;
  * edge->var, one matrix per var slot k = 0..2 (the k-th edge of each var
    in check order): K = edges, N = vars, 2,028 + 2,107 + 1,963 tiles.

Every output column of each matrix has at most one 1, so a product only
moves a value.  Tensor cores take bf16, not float32: the float32 operand is
cut into three bf16 pieces by `split3`, each piece goes through the product
exactly (one nonzero term per column, float32 sums), and the pieces are
summed back in float32, exactly.  The kernel does the same with its own
layout (see "the kernel's tables").
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import ldpc_tables as T
from ..kernels import bp_onehot
from .ldpc import _parity_ok, decoder_tables, phi0

CHECKS_P = 640            # the plain version's (Pallas) layout
SLOTS = 16
EDGES_P = CHECKS_P * SLOTS            # e = s * 640 + c
VARS_P = 2688
TILE_K = 16               # a tile of the plain version: K depth
TILE_N = 8                # and N width


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


# ------------------------------------------------- the kernel's tables
#
# The CUDA kernel runs a tile of 8 codewords on a cluster of 8 blocks.
# Block b owns checks [516 b / 8, 516 (b + 1) / 8) and variables
# [2580 b / 8, 2580 (b + 1) / 8).  Its edges are slot-major over its checks,
# e = s * 65 + c; its local variables are the variables of those edges,
# numbered j in order of first appearance along e.  The one-hot matrices
# take the A operand of mma.m16n8k16 (16 output rows by 16 of K) and the
# codewords its N: per 16-row output tile, a list of visits, each the
# k-tile and a code of 16 bytes, the column of the one in each row (0xFF:
# none).  Each row of each matrix has at most one 1.
#
#   broadcast (var -> edge): rows = the block's edges e, K = its local
#     variables j;
#   edge -> var: rows = the block's (variable, slot) pairs (j, k), sorted,
#     where edge e is the k-th edge (in check order) of variable j; K = e.
#
# Every var's k-th edge lies in exactly one block, so that block's product
# gives the exact value, which it sends to the var's owner.


class RankTables(NamedTuple):
    """The tables of one block of the cluster (numpy)."""
    c0: int                   # first check
    n_checks: int
    v0: int                   # first owned variable
    n_own: int
    loc_vars: np.ndarray      # (n_loc,) global variable of local var j
    bc_ptr: np.ndarray        # (58,) visits of broadcast output tile t
    bc_mask: np.ndarray       # (57,) valid rows (edges) of each tile
    bc_k: np.ndarray          # (V_b,) k-tile (local vars) of each visit
    bc_code: np.ndarray       # (V_b, 16) uint8 row codes
    ev_ptr: np.ndarray        # (ceil(n_rows / 16) + 1,) n_rows: the
    #                           block's (variable, slot) pairs, by variable
    ev_k: np.ndarray          # (V_e,) k-tile (edges) of each visit
    ev_code: np.ndarray       # (V_e, 16) uint8
    ev_dest: np.ndarray       # (n_rows,) owner << 11 | k << 9 | its index
    own_hold: np.ndarray      # (n_own, 3) holder << 12 | j there; 0xFFFF


# header of a block's packed region: uint16 field indices
(H_C0, H_NC, H_V0, H_NV, H_NL, H_NBC, H_BC_PTR, H_BC_MASK, H_BC_CODE,
 H_NER, H_NEV, H_EV_PTR, H_EV_CODE, H_EV_DEST, H_OWN_HOLD) = range(15)


def code_list(rows: np.ndarray, cols: np.ndarray, n_rows: int):
    """The one-hot (n_rows, K) matrix with ones at (rows[i], cols[i]), at
    most one per row, as visits per 16-row output tile: (ptr, k-tile,
    code (V, 16) uint8, valid-row mask per output tile)."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    if len(np.unique(rows)) != len(rows):
        raise ValueError("code_list: a row holds two ones")
    n_out = -(-n_rows // 16)
    big = int(cols.max(initial=0)) // 16 + 1
    uniq, inv = np.unique(rows // 16 * big + cols // 16, return_inverse=True)
    code = np.full((len(uniq), 16), 0xFF, np.uint8)
    code[inv, rows % 16] = cols % 16
    ptr = np.concatenate([[0], np.cumsum(
        np.bincount(uniq // big, minlength=n_out))]).astype(np.int64)
    mask = np.zeros(n_out, np.int64)
    np.bitwise_or.at(mask, rows // 16, 1 << (rows % 16))
    return ptr, (uniq % big).astype(np.int64), code, mask


@functools.lru_cache(maxsize=1)
def cluster_tables() -> tuple:
    """The RankTables of the kernel's 8 blocks."""
    CL, CA = bp_onehot.CLUSTER, bp_onehot.CHECKS_B
    var_idx, cmask = T.check_edges()
    vslots, vmask = T.var_edges()
    kth = np.full(cmask.size, -1, np.int64)          # k of each check edge
    for k in range(T.MAX_COL_W):
        kth[vslots[vmask[:, k], k]] = k
    kth = kth.reshape(cmask.shape)
    c_b = [r * T.N_PARITY // CL for r in range(CL + 1)]
    v_b = np.array([r * T.CODE_LEN // CL for r in range(CL + 1)])
    owner = np.searchsorted(v_b, np.arange(T.CODE_LEN), side="right") - 1
    ranks = []
    for r in range(CL):
        c0, nc = c_b[r], c_b[r + 1] - c_b[r]
        s, c = np.nonzero(cmask[c0:c0 + nc].T)     # slot-major
        e = s * CA + c
        v = var_idx[c0 + c, s]
        k = kth[c0 + c, s]
        uv, first = np.unique(v, return_index=True)
        loc_vars = uv[np.argsort(first)]
        jmap = np.full(T.CODE_LEN, -1, np.int64)
        jmap[loc_vars] = np.arange(len(loc_vars))
        j = jmap[v]
        bc_ptr, bc_k, bc_code, bc_mask = code_list(e, j, bp_onehot.EDGES_B)
        order = np.lexsort((k, j))
        ev_ptr, ev_k, ev_code, _ = code_list(np.arange(len(e)), e[order],
                                             len(e))
        o = owner[v[order]]
        ranks.append(dict(
            c0=c0, n_checks=nc, v0=int(v_b[r]), n_own=int(v_b[r + 1] - v_b[r]),
            loc_vars=loc_vars, bc_ptr=bc_ptr, bc_mask=bc_mask, bc_k=bc_k,
            bc_code=bc_code, ev_ptr=ev_ptr, ev_k=ev_k, ev_code=ev_code,
            ev_dest=o << 11 | k[order] << 9 | (v[order] - v_b[o])))
    for r in range(CL):
        hold = np.full((ranks[r]["n_own"], 3), 0xFFFF, np.int64)
        fill = np.zeros(ranks[r]["n_own"], np.int64)
        for h in range(CL):
            lv = ranks[h]["loc_vars"]
            i = lv[owner[lv] == r] - v_b[r]
            hold[i, fill[i]] = h << 12 | np.flatnonzero(owner[lv] == r)
            fill[i] += 1
        ranks[r]["own_hold"] = hold
    out = tuple(RankTables(**d) for d in ranks)
    for t in out:
        if (t.n_checks > CA or t.n_own > bp_onehot.OWN_VARS_B
                or len(t.loc_vars) > bp_onehot.LOCAL_VARS_B):
            raise ValueError("cluster_tables: a block outgrows its layout")
    return out


def _code_words(kt: np.ndarray, code: np.ndarray) -> np.ndarray:
    """(V,) k-tiles, (V, 16) codes -> (V, 8) uint32 as the kernel reads
    them: entry g = k-tile << 16 | row g + 8 << 8 | row g."""
    return (kt[:, None] << 16 | code[:, 8:].astype(np.int64) << 8
            | code[:, :8])


def pack_tables(ranks=None) -> np.ndarray:
    """(8, L) uint16: each block's region, a header (field offsets and
    counts, `H_*`) then its arrays; the codes are uint32 (`_code_words`,
    at even offsets, low half first).  L is a multiple of 8, the same for
    every block."""
    regions = []
    for t in ranks or cluster_tables():
        def u32(a):
            a = np.asarray(a, np.int64).reshape(-1)
            return np.stack([a & 0xFFFF, a >> 16], axis=1)
        parts = {H_BC_PTR: t.bc_ptr, H_BC_MASK: t.bc_mask,
                 H_BC_CODE: u32(_code_words(t.bc_k, t.bc_code)),
                 H_EV_PTR: t.ev_ptr,
                 H_EV_CODE: u32(_code_words(t.ev_k, t.ev_code)),
                 H_EV_DEST: t.ev_dest, H_OWN_HOLD: t.own_hold}
        head = np.zeros(bp_onehot.HEADER, np.int64)
        head[[H_C0, H_NC, H_V0, H_NV, H_NL, H_NBC, H_NER, H_NEV]] = (
            t.c0, t.n_checks, t.v0, t.n_own, len(t.loc_vars), len(t.bc_k),
            len(t.ev_dest), len(t.ev_k))
        body, off = [], bp_onehot.HEADER
        for field, a in parts.items():
            a = np.asarray(a, np.int64).reshape(-1)
            if off % 2:                       # uint32 words 4-byte aligned
                body.append(np.zeros(1, np.int64))
                off += 1
            head[field] = off
            body.append(a)
            off += a.size
        regions.append(np.concatenate([head] + body))
    n = -(-max(len(a) for a in regions) // 8) * 8
    out = np.zeros((len(regions), n), np.uint16)
    for r, a in enumerate(regions):
        if a.max() > 0xFFFF or a.min() < 0:
            raise ValueError("pack_tables: a field outgrows uint16")
        out[r, :len(a)] = a
    return out


@functools.lru_cache(maxsize=8)
def kernel_tables(device: torch.device) -> torch.Tensor:
    """`pack_tables()` on `device` (int16 holding the uint16 bits)."""
    return torch.from_numpy(pack_tables().view(np.int16)).to(device)


# ------------------------------------------------------------------ decode


def decode_onehot_reference(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """Plain-torch version of the one-hot decoder (any device): the Pallas
    kernel's padded slot-major layout and its tiled products in bf16
    pieces (the CUDA kernel does the same products on its own layout).
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
                  batch_tile: int = 32):
    """One-hot BP decode: the tensor-core kernel for a CUDA tensor, the
    plain emulation for a CPU tensor.  `batch_tile` is `decode_pallas`'s
    hint (any positive int); the outputs do not depend on it, and both
    paths choose their own tiles (the kernel: 8 codewords a cluster)."""
    if isinstance(batch_tile, bool) or not isinstance(batch_tile, int) \
            or batch_tile < 1:
        raise ValueError(f"decode_onehot: batch_tile must be a positive "
                         f"int, got {batch_tile!r}")
    if llr.device.type == "cuda":
        return bp_onehot.decode(llr, kernel_tables(llr.device), max_iter)
    if llr.device.type == "cpu":
        return decode_onehot_reference(llr, max_iter)
    raise ValueError(f"decode_onehot: unsupported device {llr.device}")
