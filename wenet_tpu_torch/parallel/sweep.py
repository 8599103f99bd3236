"""Monte-Carlo sweeps and the coarse acquisition search on the device
(counterpart of wenet_tpu/parallel/sweep.py).

Trials run as a batch axis: codeword trials are rows of one decode batch
(the BP kernel, or its min-sum variant, on a CUDA device), full-chain
trials and candidate offsets are lanes of one demod call
(`ops.fsk.demod_lanes`: the frame-loop kernel, one block a lane, on a CUDA
device) followed by one batched UW search and decode.
Random bits and noise come from an explicit `torch.Generator`, so a sweep
is reproducible from its seed (not bit-for-bit the JAX package's draws).

With a `mesh=` (`parallel.mesh`; call SPMD, in every rank) the trials,
codewords or offsets round up to a multiple of the mesh size, as JAX's
do.  Every rank draws the whole padded batch from the same seeded
generator and keeps its own rows, so an n-rank sweep equals the one-rank
sweep of the padded count; counters are summed over the mesh as int64 and
acquisition scores gathered in rank order.

Soft bits of demod frames that fall past the capture end (`valid` False)
are masked to zero before the UW correlation and the decode; the JAX
version feeds them in unmasked.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import framing
from ..core import ldpc_tables as T
from ..ops import channel, deframe, fsk, ldpc
from ..ops import crc as dcrc
from .mesh import Mesh, mesh_device, shard_rows

ALGOS = ("sum-product", "min-sum")


def _generator(generator, device, seed: int) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


# ------------------------------------------------------------- LDPC-only MC


def ldpc_trial_counts(ibits: torch.Tensor, noise: torch.Tensor, ebno_db,
                      algo: str = "sum-product", max_iter: int = T.MAX_ITER):
    """One batch of codeword trials at one Eb/N0 point.

    ibits (n, 2064) {0,1} and noise (n, 2580) float32 standard normal, on
    one device: encode, BPSK at Es/N0 = Eb/N0 * 2064/2580, blind LLRs,
    decode.  Returns 0-dim int64 tensors (bit errors, frame errors, sum of
    iterations) on that device.
    """
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    ibits = ibits.to(torch.uint8)
    cw = torch.cat([ibits, ldpc.encode_bits(ibits)], dim=1)
    sym = 1.0 - 2.0 * cw.to(torch.float32)
    ebno = torch.as_tensor(ebno_db, dtype=torch.float32, device=ibits.device)
    esn0 = 10.0 ** (ebno / 10.0) * (2064.0 / 2580.0)
    sigma = torch.sqrt(1.0 / (2.0 * esn0))
    llr = ldpc.sd_to_llr(sym + sigma * noise)
    dec = ldpc.decode_minsum if algo == "min-sum" else ldpc.decode
    bits, iters, _ = dec(llr, max_iter=max_iter)
    err = bits[:, : T.N_DATA] != ibits
    return (err.sum(), err.any(dim=1).sum(),
            iters.sum(dtype=torch.int64))


def _padded(n: int, mesh: Mesh | None) -> int:
    """n rounded up to a multiple of the mesh size (JAX's padding)."""
    return n if mesh is None else -(-n // mesh.size) * mesh.size


def _mesh_sum(counts: torch.Tensor, mesh: Mesh | None) -> np.ndarray:
    """int64 counters summed over the mesh, on the host."""
    return (counts if mesh is None else mesh.sum(counts)).cpu().numpy()


def ldpc_ber_sweep(ebno_grid, n_cw_per_point: int,
                   generator: torch.Generator | None = None,
                   mesh: Mesh | None = None, device=None,
                   max_iter: int = T.MAX_ITER, algo: str = "sum-product"):
    """BER/FER vs Eb/N0 for H2064_516, `n_cw_per_point` codewords per
    point in one decode batch (with a mesh, rounded up to a multiple of its
    size and split over its ranks).

    algo: "sum-product" (reference-exact) or "min-sum" (normalized, the
    fast Monte-Carlo engine).  generator: a torch.Generator on the device
    (default: seeded 0).  device: CUDA (the mesh rank's, with a mesh)
    unless the caller names another.  Returns a dict: ebno_db, ber, fer,
    mean_iters (numpy arrays) and n_codewords.
    """
    dev = mesh_device(device, mesh)
    gen = _generator(generator, dev, 0)
    grid = np.atleast_1d(np.asarray(ebno_grid, np.float32))
    n = _padded(n_cw_per_point, mesh)
    rows = shard_rows(n, mesh)
    counts = []
    for e in grid:
        ibits = torch.randint(0, 2, (n, T.N_DATA), generator=gen, device=dev,
                              dtype=torch.uint8)
        noise = torch.randn((n, T.CODE_LEN), generator=gen, device=dev)
        counts.append(torch.stack(ldpc_trial_counts(
            ibits[rows], noise[rows], e, algo, max_iter)))
    be, fe, it = _mesh_sum(torch.stack(counts), mesh).T
    return {"ebno_db": grid, "ber": be / (n * float(T.N_DATA)),
            "fer": fe / n, "mean_iters": it / n, "n_codewords": n}


# ---------------------------------------------------------- full-chain MC


def make_single_packet_stream(cfg: fsk.FSKConfig, payload: bytes,
                              mode: str = "v2", pad_frames: int = 4,
                              seed: int = 0):
    """Host-side: frame one payload and modulate a short capture around it.
    Returns (iq clean complex64, tx signal variance) for device trials."""
    rng = np.random.default_rng(seed)
    frame = framing.frame_packet(payload, ldpc.encode_bytes, mode=mode)
    bits = np.concatenate([
        rng.integers(0, 2, cfg.Nbits * pad_frames).astype(np.uint8),
        framing.frame_to_bits(frame, mode),
        rng.integers(0, 2, cfg.Nbits * pad_frames).astype(np.uint8)])
    bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    return sig.astype(np.complex64), float(np.mean(np.abs(sig) ** 2))


def _uw_params(mode: str):
    if mode == "v2":
        return framing.UW_BITS_V2, framing.V2_SYMBOLS_PER_PACKET
    if mode == "v1":
        return framing.UW_BITS_V1, framing.V1_SYMBOLS_PER_PACKET
    raise ValueError("mode must be 'v1' or 'v2'")


def _uw_correlation(hard_pm: torch.Tensor, uw: np.ndarray) -> torch.Tensor:
    """(L, n) +-1 (0 = masked) -> (L, n - nuw + 1) correlation of each
    window with the UW (`jnp.correlate(..., "valid")`: no flip)."""
    kern = torch.as_tensor(1.0 - 2.0 * uw.astype(np.float32),
                           device=hard_pm.device)
    return torch.nn.functional.conv1d(hard_pm[:, None, :],
                                      kern[None, None, :])[:, 0]


def _uw_window_decode(cfg: fsk.FSKConfig, soft: torch.Tensor, mode: str,
                      max_iter: int, valid: torch.Tensor | None = None):
    """UW locate + decode of one packet window per lane: soft (L, n)
    float32 (valid (L, n) bool masks soft bits to 0) -> crc ok (L,) bool,
    iters (L,) int32.  Greedy acquisition: the first strongest correlation
    peak whose packet window fits in the stream."""
    uw, syms = _uw_params(mode)
    n = soft.shape[1]
    nuw = len(uw)
    hard_pm = torch.where(soft < 0, -1.0, 1.0)
    if valid is not None:
        soft = torch.where(valid, soft, 0.0)
        hard_pm = torch.where(valid, hard_pm, 0.0)
    scores = _uw_correlation(hard_pm, uw)
    idx = torch.arange(scores.shape[1], device=soft.device)
    scores = torch.where(idx <= n - syms - nuw, scores, -1e9)
    t = torch.argmax(scores, dim=1) + nuw - 1        # first maximum
    win = torch.gather(soft, 1, t[:, None] + 1 + torch.arange(
        syms, device=soft.device))
    sd = deframe.descramble_or_strip(win, mode)
    bits, iters, _ = ldpc.decode(ldpc.sd_to_llr(sd), max_iter=max_iter)
    return dcrc.packet_crc_ok(bits), iters


def _frame_soft(cfg: fsk.FSKConfig, outs: fsk.FrameOut):
    """Lane-stacked FrameOut -> soft (L, nf * Nbits), valid per bit."""
    L = outs.soft.shape[0]
    valid = outs.valid.repeat_interleave(cfg.Nbits, dim=1)
    return outs.soft.reshape(L, -1), valid


def chain_per_sweep(cfg: fsk.FSKConfig, ebno_grid, trials_per_point: int,
                    payload: bytes | None = None, mode: str = "v2",
                    generator: torch.Generator | None = None,
                    mesh: Mesh | None = None, device=None,
                    max_iter: int = T.MAX_ITER):
    """Full-chain PER vs Eb/N0: mod -> AWGN -> demod -> UW -> BP -> CRC on
    the device, the trials of a point as lanes of one vmapped demod and
    rows of one decode batch (with a mesh, rounded up to a multiple of its
    size and split over its ranks).  generator: on the device (default:
    seeded 42).  device: CUDA (the mesh rank's, with a mesh) unless the
    caller names another.  Returns a dict: ebno_db, per, mean_iters,
    trials."""
    dev = mesh_device(device, mesh)
    gen = _generator(generator, dev, 42)
    payload = bytes(range(256)) if payload is None else payload
    sig, var = make_single_packet_stream(cfg, payload, mode)
    sig_t = torch.from_numpy(sig).to(dev)
    nf = cfg.num_frames(len(sig))
    trials = _padded(trials_per_point, mesh)
    rows = shard_rows(trials, mesh)
    grid = np.atleast_1d(np.asarray(ebno_grid, np.float32))
    counts = []
    for e in grid:
        iq = channel.add_awgn_torch(sig_t.expand(trials, -1), float(e),
                                    cfg.Fs, cfg.Rs, var, gen)
        _, outs = fsk.demod_lanes(cfg, iq[rows].contiguous(), nf)
        soft, valid = _frame_soft(cfg, outs)
        ok, iters = _uw_window_decode(cfg, soft, mode, max_iter, valid)
        counts.append(torch.stack([ok.sum(dtype=torch.int64),
                                   iters.sum(dtype=torch.int64)]))
    nok, it = _mesh_sum(torch.stack(counts), mesh).T
    return {"ebno_db": grid, "per": 1.0 - nok / trials,
            "mean_iters": it / trials, "trials": trials}


# -------------------------------------------------- coarse acquisition search


def acquisition_search(cfg: fsk.FSKConfig, iq, offsets_hz, mode: str = "v2",
                       probe_frames: int | None = None,
                       mesh: Mesh | None = None, device=None):
    """Coarse frequency-offset acquisition over a candidate grid.

    For a capture whose tones sit outside the demod estimator's band: mix
    the probe span down by each candidate offset, demodulate all candidates
    as lanes of one vmapped demod, and score each by the strongest UW
    correlation of its hard bits.  With a mesh the grid, padded to a
    multiple of its size by repeating it (`np.resize`, as JAX pads), splits
    over its ranks.  device: CUDA (the mesh rank's, with a mesh) unless the
    caller names another.  Returns (best offset in Hz, scores ndarray
    aligned with offsets_hz); ties go to the first candidate.
    """
    dev = mesh_device(device, mesh)
    offsets = np.atleast_1d(np.asarray(offsets_hz, np.float32))
    uw, syms_pp = _uw_params(mode)
    # default probe: two packet lengths + estimator warmup, so at least one
    # whole UW lies inside the span wherever packet boundaries fall
    default_nf = 2 * (syms_pp // cfg.Nsym + 2) + 16
    nf = probe_frames or min(cfg.num_frames(len(iq)), default_nf)
    npad = nf * cfg.N + cfg.Nmem + cfg.Ts
    probe = torch.as_tensor(np.asarray(iq, np.complex64)[:npad], device=dev)
    n = torch.arange(probe.shape[0], dtype=torch.float32, device=dev)
    grid = np.resize(offsets, _padded(len(offsets), mesh))
    rows = shard_rows(len(grid), mesh)
    off = torch.as_tensor(grid[rows], device=dev)
    # wrapped fractional phase in float32, as the JAX search computes it
    frac = fsk._fmod_floor(off / cfg.Fs, 1.0)
    ph = fsk._fmod_floor(n[None, :] * frac[:, None], 1.0) * np.float32(
        2 * np.pi)
    mixed = probe[None, :] * torch.complex(torch.cos(ph), -torch.sin(ph))
    _, outs = fsk.demod_lanes(cfg, mixed, nf)
    soft, valid = _frame_soft(cfg, outs)
    hard = torch.where(valid, torch.where(soft < 0, -1.0, 1.0), 0.0)
    scores = _uw_correlation(hard, uw).amax(dim=1)
    if mesh is not None:
        scores = mesh.gather(scores)
    scores = scores.cpu().numpy()[:len(offsets)]
    return float(offsets[int(np.argmax(scores))]), scores
