"""H2064_516 LDPC encode + batched sum-product and min-sum decode
(counterpart of wenet_tpu/ops/ldpc.py).

`decode` and `decode_minsum` dispatch on the tensor's device: a CPU tensor
goes through the plain PyTorch version (`decode_reference`,
`decode_minsum_reference`); a CUDA tensor goes through the hand-written BP
kernel (`wenet_tpu_torch.kernels.bp_decode`), never the reference.  Both
compute what `wenet_tpu.ops.ldpc.decode` / `decode_minsum` compute: the
per-codeword convergence freeze and the same `iters` semantics, with the
phi-domain check update (reference phi0 clamps) or the normalized two-min
check update.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import ldpc_tables as T
from ..device import resolve_device
from ..kernels import bp_decode

# ------------------------------------------------------------------ encode


def encode_bits_np(ibits: np.ndarray) -> np.ndarray:
    """ibits (..., 2064) uint8 -> parity (..., 516) uint8 (numpy, host)."""
    taps = T.encoder_taps()                       # (516, 12)
    par = ibits[..., taps].sum(axis=-1)           # (..., 516)
    return (np.cumsum(par, axis=-1) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _encoder_taps(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(T.encoder_taps(), dtype=torch.int64, device=device)


def encode_bits(ibits: torch.Tensor) -> torch.Tensor:
    """ibits (..., 2064) {0,1} tensor -> parity (..., 516) uint8, on the
    tensor's device (integer-exact)."""
    par = ibits.to(torch.int32)[..., _encoder_taps(ibits.device)].sum(
        dim=-1, dtype=torch.int32)
    return (torch.cumsum(par, dim=-1, dtype=torch.int32) & 1).to(torch.uint8)


def encode_bytes(payload258: bytes) -> bytes:
    """258-byte payload+CRC -> 65-byte parity block (MSB-first bits)."""
    if len(payload258) != 258:
        raise ValueError("payload must be 258 bytes (2064-bit codeword)")
    ibits = np.unpackbits(np.frombuffer(payload258, dtype=np.uint8))
    return np.packbits(encode_bits_np(ibits)).tobytes()


# ------------------------------------------------------------------ decode


def phi0(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -ln(tanh(x/2)) with the reference's clamps:
    x > 10 -> 0, x < 9.08e-5 -> 10."""
    xs = torch.clamp(x, 9.08e-5, 10.0)
    val = -torch.log(torch.tanh(xs * 0.5))
    val = torch.where(x > 10.0, 0.0, val)
    return torch.where(x < 9.08e-5, 10.0, val)


def sd_to_llr(sd: torch.Tensor) -> torch.Tensor:
    """Soft decisions -> LLRs with blind Es/N0 estimation.  sd: (..., n)."""
    n = sd.shape[-1]
    mean = torch.mean(torch.abs(sd), dim=-1, keepdim=True)
    x = sd / mean - torch.sign(sd)
    s = torch.sum(x, dim=-1, keepdim=True)
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    estvar = (n * sq - s * s) / (n * (n - 1))
    est_esn0 = 1.0 / (2.0 * estvar + 1e-3)
    return 4.0 * est_esn0 * sd


@functools.lru_cache(maxsize=8)
def decoder_tables(device: torch.device):
    """Edge tables on `device`: var_idx (516, 14) int64, edge mask (516, 14)
    bool, var slots (2580, 3) int64 into the flat edge array (invalid ->
    dump slot 7224) and var mask (2580, 3) bool."""
    var_idx, mask = T.check_edges()
    vslots, vmask = T.var_edges()
    return (torch.as_tensor(var_idx, dtype=torch.int64, device=device),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(vslots, dtype=torch.int64, device=device),
            torch.as_tensor(vmask, device=device))


def _parity_ok(bits: torch.Tensor, var_idx, mask) -> torch.Tensor:
    be = bits[:, var_idx].int() * mask.int()
    return torch.all(be.sum(dim=-1) % 2 == 0, dim=-1)


def decode_reference(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """Plain PyTorch sum-product decode (any device).

    llr: (B, 2580) float32 (positive = bit 0).
    Returns bits (B, 2580) uint8, iters (B,) int32, parity_ok (B,) bool.
    The check-side sum runs in slot order 0..13 and the var-side sum in
    slot order 0..2, the orders the CUDA kernel uses too.
    """
    var_idx, mask, vslots, vmask = decoder_tables(llr.device)
    B = llr.shape[0]
    fmask = mask.to(llr.dtype)
    vfmask = vmask.to(llr.dtype)

    llr_e = llr[:, var_idx]                                   # (B, 516, 14)
    vmsg = phi0(torch.abs(llr_e)) * fmask
    vsgn = ((llr_e < 0) & mask).int()
    bits = torch.zeros(B, T.CODE_LEN, dtype=torch.uint8, device=llr.device)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=llr.device)
    converged = torch.zeros(B, dtype=torch.bool, device=llr.device)
    pad = torch.zeros(B, 1, dtype=llr.dtype, device=llr.device)

    for it in range(max_iter):
        # check -> var
        phi_sum = vmsg[..., 0]
        for s in range(1, vmsg.shape[-1]):
            phi_sum = phi_sum + vmsg[..., s]
        sgn_tot = vsgn.sum(dim=-1, keepdim=True) & 1          # (B, 516, 1)
        r_mag = phi0(phi_sum[..., None] - vmsg)
        r_sgn = (sgn_tot ^ vsgn) & 1
        rmsg = torch.where(r_sgn == 1, -r_mag, r_mag) * fmask
        ssum = (sgn_tot[..., 0] == 0).sum(dim=-1)

        # var -> check: gather the (<= 3) incident edge messages per var
        flat = torch.cat([rmsg.reshape(B, -1), pad], dim=1)
        g = flat[:, vslots] * vfmask                          # (B, 2580, 3)
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
                                              device=llr.device), iters)
        converged = converged | trigger
        if bool(converged.all()):
            break

    return bits, iters, _parity_ok(bits, var_idx, mask)


def decode(llr: torch.Tensor, max_iter: int = T.MAX_ITER):
    """Batched sum-product decode: the BP kernel for a CUDA tensor, the
    plain reference for a CPU tensor.  Same returns as decode_reference."""
    if llr.device.type == "cuda":
        return bp_decode.decode(llr, max_iter)
    if llr.device.type == "cpu":
        return decode_reference(llr, max_iter)
    raise ValueError(f"decode: unsupported device {llr.device}")


def decode_np(llr: np.ndarray, max_iter: int = T.MAX_ITER, device="cuda"):
    """Host wrapper of `decode`: numpy LLRs (a batch dimension is added
    where missing; kept float32) -> numpy (bits, iters, parity_ok), decoded
    on `device` (CUDA unless the caller asks for another; raises without a
    card)."""
    llr = np.atleast_2d(np.asarray(llr, np.float32))
    out = decode(torch.from_numpy(llr).to(resolve_device(device)), max_iter)
    return tuple(t.cpu().numpy() for t in out)


MINSUM_BIG = 1e30        # magnitude of the invalid edge slots


def decode_minsum_reference(llr: torch.Tensor, max_iter: int = T.MAX_ITER,
                            scale: float = 0.8):
    """Plain PyTorch normalized min-sum decode (any device).

    Same graph, freeze and returns as `decode_reference`; the check update
    is r = scale * sign-product * (the smallest |q| of the other edges),
    from the two smallest magnitudes per check.  The first-min slot is the
    lowest slot holding the minimum, invalid slots carry MINSUM_BIG, and
    the var-side sign is `q < 0` (sum-product: `q <= 0`).
    """
    var_idx, mask, vslots, vmask = decoder_tables(llr.device)
    B = llr.shape[0]
    fmask = mask.to(llr.dtype)
    vfmask = vmask.to(llr.dtype)
    big = torch.tensor(MINSUM_BIG, dtype=llr.dtype, device=llr.device)
    slot = torch.arange(T.MAX_CHECK_DEG, device=llr.device)

    q_e = llr[:, var_idx]                                     # (B, 516, 14)
    qmag = torch.where(mask, torch.abs(q_e), big)
    qsgn = ((q_e < 0) & mask).int()
    bits = torch.zeros(B, T.CODE_LEN, dtype=torch.uint8, device=llr.device)
    iters = torch.full((B,), max_iter, dtype=torch.int32, device=llr.device)
    converged = torch.zeros(B, dtype=torch.bool, device=llr.device)
    pad = torch.zeros(B, 1, dtype=llr.dtype, device=llr.device)

    for it in range(max_iter):
        m1 = qmag.min(dim=-1, keepdim=True).values
        pos = torch.where(qmag <= m1, slot, T.MAX_CHECK_DEG).min(
            dim=-1, keepdim=True).values
        first = slot == pos
        m2 = torch.where(first, big, qmag).min(dim=-1, keepdim=True).values
        r_mag = torch.where(first, m2, m1) * scale
        sgn_tot = qsgn.sum(dim=-1, keepdim=True) & 1
        r_sgn = (sgn_tot ^ qsgn) & 1
        rmsg = torch.where(r_sgn == 1, -r_mag, r_mag) * fmask
        ssum = (sgn_tot[..., 0] == 0).sum(dim=-1)

        flat = torch.cat([rmsg.reshape(B, -1), pad], dim=1)
        g = flat[:, vslots] * vfmask
        qi = llr + ((g[..., 0] + g[..., 1]) + g[..., 2])
        new_bits = (qi < 0).to(torch.uint8)
        q_e = qi[:, var_idx] - rmsg
        new_qmag = torch.where(mask, torch.abs(q_e), big)
        new_qsgn = ((q_e < 0) & mask).int()

        data_zero = torch.all(new_bits[:, : T.N_DATA] == 0, dim=-1)
        trigger = data_zero | (ssum == T.N_PARITY)

        upd = ~converged
        qmag = torch.where(upd[:, None, None], new_qmag, qmag)
        qsgn = torch.where(upd[:, None, None], new_qsgn, qsgn)
        bits = torch.where(upd[:, None], new_bits, bits)
        iters = torch.where(upd, torch.tensor(it + 1, dtype=torch.int32,
                                              device=llr.device), iters)
        converged = converged | trigger
        if bool(converged.all()):
            break

    return bits, iters, _parity_ok(bits, var_idx, mask)


def decode_minsum(llr: torch.Tensor, max_iter: int = T.MAX_ITER,
                  scale: float = 0.8):
    """Batched normalized min-sum decode: the min-sum variant of the BP
    kernel for a CUDA tensor, the plain reference for a CPU tensor."""
    if llr.device.type == "cuda":
        return bp_decode.decode_minsum(llr, max_iter, scale)
    if llr.device.type == "cpu":
        return decode_minsum_reference(llr, max_iter, scale)
    raise ValueError(f"decode_minsum: unsupported device {llr.device}")
