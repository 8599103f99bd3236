"""H2064_516 rate-0.8 repeat-accumulate LDPC code tables (copy of the parts
of wenet_tpu/core/ldpc_tables.py the port uses).

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
MAX_CHECK_DEG = 12 + 2   # data taps + two RA parity-chain vars

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
