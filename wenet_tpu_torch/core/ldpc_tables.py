"""H2064_516 rate-0.8 repeat-accumulate LDPC code tables (copy of
wenet_tpu/core/ldpc_tables.py; every public name of it is here).

n=2580, k=2064, m=516, up to 12 data taps per check, column weight <= 3.
Check i is also connected to parity vars (2064+i-1, 2064+i); check 0 only
to parity var 2064.  Edges are a dense (516, 14) index table plus a mask.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

N_PARITY = 516
N_DATA = 2064
CODE_LEN = 2580
MAX_COL_W = 3
MAX_ITER = 10
MAX_ROW_W = 12           # data taps per check
MAX_CHECK_DEG = MAX_ROW_W + 2   # + two RA parity-chain vars

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@lru_cache(maxsize=1)
def load_raw():
    d = np.load(os.path.join(_DATA_DIR, "h2064_516.npz"))
    return d["H_rows"], d["H_cols"], d["Enc_rows"]


@lru_cache(maxsize=1)
def encoder_taps() -> np.ndarray:
    """(516, 12) 0-based data-bit indices per parity row."""
    return (load_raw()[2] - 1).astype(np.int32)


@lru_cache(maxsize=1)
def check_edges():
    """(var_idx (516, 14) int32, mask (516, 14) bool): the data taps of each
    check, then its one or two RA parity-chain vars."""
    H_rows = load_raw()[0]
    var_idx = np.zeros((N_PARITY, MAX_CHECK_DEG), dtype=np.int32)
    mask = np.zeros((N_PARITY, MAX_CHECK_DEG), dtype=bool)
    for i in range(N_PARITY):
        taps = H_rows[i][H_rows[i] > 0] - 1
        deg = len(taps)
        var_idx[i, :deg] = taps
        mask[i, :deg] = True
        if i == 0:
            var_idx[i, deg] = N_DATA
            mask[i, deg] = True
        else:
            var_idx[i, deg] = N_DATA + i - 1
            var_idx[i, deg + 1] = N_DATA + i
            mask[i, deg:deg + 2] = True
    return var_idx, mask


def edges_flat():
    """(var_of_edge (E,) int32, edge_slot (516, 14) int32): the variable of
    each valid edge in flat order, and each dense slot's flat edge id
    (invalid slots map to E, a dump slot)."""
    var_idx, mask = check_edges()
    var_of_edge = var_idx[mask].astype(np.int32)
    edge_slot = np.full(var_idx.shape, var_of_edge.size, dtype=np.int32)
    edge_slot[mask] = np.arange(var_of_edge.size, dtype=np.int32)
    return var_of_edge, edge_slot


@lru_cache(maxsize=1)
def var_edges():
    """(slots (2580, 3) int32, mask (2580, 3) bool): for each variable, the
    flat (516*14) check-edge slots of its edges in check order; unused
    entries point at the dump slot 516*14."""
    var_idx, cmask = check_edges()
    slots = np.full((CODE_LEN, MAX_COL_W), var_idx.size, dtype=np.int32)
    mask = np.zeros((CODE_LEN, MAX_COL_W), dtype=bool)
    fill = np.zeros(CODE_LEN, dtype=np.int32)
    for flat in np.flatnonzero(cmask):
        v = var_idx.flat[flat]
        slots[v, fill[v]] = flat
        mask[v, fill[v]] = True
        fill[v] += 1
    return slots, mask


@lru_cache(maxsize=1)
def var_onehot_f32() -> np.ndarray:
    """(E, 2580) one-hot scatter matrix: vars = edges @ onehot."""
    var_of_edge, _ = edges_flat()
    m = np.zeros((var_of_edge.size, CODE_LEN), dtype=np.float32)
    m[np.arange(var_of_edge.size), var_of_edge] = 1.0
    return m


def sanity_check():
    """True where the tables describe the code: check degrees within
    bounds, every parity var on two checks but the last (one), and the
    data vars' degrees those of H_cols; raises ValueError otherwise."""
    var_idx, mask = check_edges()
    degs = mask.sum(axis=1)
    counts = np.bincount(var_idx[mask], minlength=CODE_LEN)
    col_deg = (load_raw()[1] > 0).sum(axis=1)
    if not (degs[0] >= 2 and degs.max() <= MAX_CHECK_DEG
            and counts[N_DATA:-1].max() == 2 and counts[-1] == 1
            and np.array_equal(counts[:N_DATA], col_deg)):
        raise ValueError("ldpc_tables: the edge tables do not match H2064_516")
    return True
