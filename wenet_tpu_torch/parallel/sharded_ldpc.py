"""Tensor-parallel LDPC decode: check rows sharded over a mesh axis
(counterpart of wenet_tpu/parallel/sharded_ldpc.py).

The batch splits over `batch_axis` and the 516 check rows (padded to a
multiple of the model axis) over `model_axis`.  Each rank runs the check
update of its rows; the var side needs every row's messages, which one sum
over the model group a iteration completes, beside a second sum that
counts the satisfied checks.  Same semantics as `ops.ldpc.decode`: the
per-codeword freeze, the same `iters`, and bits equal to the plain decode.

Where JAX sums one partial var total per rank (scatter-adds of its edges),
each rank here contributes the (B, 2580, 3) messages of its own edges, by
var and slot, zero elsewhere: every (var, slot) is owned by one rank, so
the sum over the group adds only zeros to it and is exact, and the slots
are then added in the plain decode's order (`ops.ldpc.decode_reference`).
A scatter-add would sum in an order that depends on the split (and, on a
card, on atomics), and could break bit-equality near the decode cliff.
The body is tensor ops on the rank's device (gathers and `phi0`): the BP
kernel runs whole iterations and cannot stop at the collective inside one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import ldpc_tables as T
from ..ops.ldpc import phi0
from .mesh import Mesh, shard_rows


def _padded_tables(tp: int):
    """Check rows padded to a multiple of tp: var_idx, mask (rows_p, 14),
    rows_p."""
    var_idx, mask = T.check_edges()
    pad = (-var_idx.shape[0]) % tp
    var_idx = np.pad(var_idx, ((0, pad), (0, 0)))
    mask = np.pad(mask, ((0, pad), (0, 0)))
    return var_idx, mask, var_idx.shape[0]


def _local_tables(tp: int, m: int, device):
    """Rank m's share of the code: its check rows' var_idx and mask
    (R, 14), the number of them that are real, and per (var, slot) its
    edge's index in the rank's flat (R * 14 + 1) messages and whether the
    rank owns that edge (else the index is the zero slot)."""
    var_idx, mask, rows_p = _padded_tables(tp)
    R = rows_p // tp
    row0 = m * R
    deg = var_idx.shape[1]
    vslots, vmask = T.var_edges()              # into the flat (516 * 14)
    local = vslots.astype(np.int64) - row0 * deg
    own = vmask & (local >= 0) & (local < R * deg)
    local = np.where(own, local, R * deg)
    real_rows = int(np.clip(T.N_PARITY - row0, 0, R))
    return (torch.as_tensor(var_idx[row0:row0 + R], dtype=torch.int64,
                            device=device),
            torch.as_tensor(mask[row0:row0 + R], device=device), real_rows,
            torch.as_tensor(local, device=device),
            torch.as_tensor(own, device=device))


def decode_sharded(llr: torch.Tensor, mesh: Mesh, max_iter: int = T.MAX_ITER,
                   batch_axis: str = "batch", model_axis: str = "model"):
    """llr (B, 2580) float32, the same in every rank -> (bits (B, 2580)
    uint8, iters (B,) int32, parity_ok (B,) bool) on the rank's device, the
    same in every rank.  B splits over batch_axis (B must divide by its
    size), check rows over model_axis.

    Every rank of a model group runs the same iterations: the loop stops on
    values that are equal across the group by construction (the summed
    messages and check counts, the group's common batch rows)."""
    dev = mesh.device
    tp = mesh.shape[model_axis]
    rows = shard_rows(llr.shape[0], mesh, batch_axis)
    llr = llr[rows].to(dev, torch.float32)
    var_idx, mask, real_rows, vlocal, vown = _local_tables(
        tp, mesh.index(model_axis), dev)
    B, R = llr.shape[0], var_idx.shape[0]
    fmask = mask.to(llr.dtype)
    vfmask = vown.to(llr.dtype)
    row_valid = torch.arange(R, device=dev) < real_rows

    llr_e = llr[:, var_idx]                                   # (B, R, 14)
    vmsg = phi0(torch.abs(llr_e)) * fmask
    vsgn = ((llr_e < 0) & mask).int()
    bits = torch.zeros(B, T.CODE_LEN, dtype=torch.uint8, device=dev)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    pad = torch.zeros(B, 1, dtype=llr.dtype, device=dev)

    for it in range(max_iter):
        phi_sum = vmsg[..., 0]
        for s in range(1, vmsg.shape[-1]):
            phi_sum = phi_sum + vmsg[..., s]
        sgn_tot = vsgn.sum(dim=-1, keepdim=True) & 1          # (B, R, 1)
        r_mag = phi0(phi_sum[..., None] - vmsg)
        r_sgn = (sgn_tot ^ vsgn) & 1
        rmsg = torch.where(r_sgn == 1, -r_mag, r_mag) * fmask
        ssum = mesh.sum(((sgn_tot[..., 0] == 0) & row_valid).sum(dim=-1),
                        model_axis)

        flat = torch.cat([rmsg.reshape(B, -1), pad], dim=1)
        g = mesh.sum(flat[:, vlocal] * vfmask, model_axis)    # (B, 2580, 3)
        qi = llr + ((g[..., 0] + g[..., 1]) + g[..., 2])
        new_bits = (qi < 0).to(torch.uint8)
        q_e = qi[:, var_idx] - rmsg
        new_vmsg = phi0(torch.abs(q_e)) * fmask
        new_vsgn = ((q_e <= 0) & mask).int()

        data_zero = torch.all(new_bits[:, : T.N_DATA] == 0, dim=-1)
        trigger = data_zero | (ssum == T.N_PARITY)

        upd = ~converged
        vmsg = torch.where(upd[:, None, None], new_vmsg, vmsg)
        vsgn = torch.where(upd[:, None, None], new_vsgn, vsgn)
        bits = torch.where(upd[:, None], new_bits, bits)
        iters = torch.where(upd, torch.tensor(it + 1, dtype=torch.int32,
                                              device=dev), iters)
        converged = converged | trigger
        if bool(converged.all()):
            break

    be = bits[:, var_idx].int() * mask.int()
    bad = mesh.sum(((be.sum(dim=-1) % 2 != 0) & row_valid).sum(dim=-1),
                   model_axis)
    parity_ok = (bad == 0).to(torch.uint8)
    return (mesh.gather(bits, batch_axis), mesh.gather(iters, batch_axis),
            mesh.gather(parity_ok, batch_axis).bool())
