"""Full-chain demod throughput against batch width B on the card
(counterpart of tools/chain_scaling.py).

B lanes of one 12-packet v2 stream, each with its own AWGN at an Eb/N0 of
linspace(8, 15, B), go through the whole chain: the demod kernel on all
lanes at once (`ops.fsk.demod_lanes`), then `ops.deframe.deframe_topk`
(top-k UW acquisition, one BP batch, CRC).  Every timed region ends with
`torch.cuda.synchronize()` and a one-element copy to the host.

    python -m wenet_tpu_torch.tools.chain_scaling [B ...] [--device cpu]
        [--out PATH]

prints one JSON record a B (Msamples/s, x real time, the first call's
seconds, packets recovered).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import emitter, time_call

DEFAULT_B = (8, 16, 32, 64)
EBNO_RANGE = (8.0, 15.0)
PACKETS = 12
REPS = 3


def chain_signal(cfg, n_packets=PACKETS):
    """The tool's v2 stream: n_packets random payloads, each framed and
    followed by 512 random bits, padded to whole frames, FSK-modulated ->
    (complex64 samples, their mean power)."""
    from ..ops import fsk
    from .captures import make_packet_bits
    bits = make_packet_bits(cfg, n_packets, np.random.default_rng(0),
                            lead_bits=0)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    return sig, signal_power(sig)


def signal_power(sig: np.ndarray) -> float:
    """Mean |sig|^2 of complex64 samples, summed in float32 as numpy sums
    them."""
    return float(np.mean(np.abs(np.asarray(sig, np.complex64)) ** 2))


def noisy_lanes(cfg, sig: torch.Tensor, var: float, ebnos: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """Lane b = sig + sqrt(nvar_b / 2) * noise[b], nvar_b = var * Fs /
    (Rs * 10^(ebnos[b] / 10)), over the lane's largest magnitude; float32
    throughout, as the JAX tool forms it."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=ebnos.device)
    nvar = f32(var * cfg.Fs) / (f32(cfg.Rs) * 10.0 ** (ebnos / 10.0))
    iq = sig[None, :] + torch.sqrt(nvar / 2)[:, None] * noise
    return iq / torch.amax(torch.abs(iq), dim=1, keepdim=True)


def chain_lanes(cfg, sig, ebnos, k, mode="v2", noise=None, generator=None,
                device="cuda", var=None):
    """The whole chain on B noisy copies of one stream -> (ok, pos), each
    (B, k): the CRC flag and UW position of each of the k top-k picks of
    each lane (the vmapped chain of tools/chain_scaling.py and
    tools/loss_census.py).

    sig: (n,) complex64, numpy or a tensor; ebnos: (B,) Eb/N0 in dB.
    noise: (B, n) complex64 unit-variance noise (re and im each N(0, 1)),
    or None to draw it on the device from `generator` (default: seeded 1).
    var: the signal's mean power (default: computed from sig).  device:
    CUDA unless the caller names another; raises without a card.  Frames
    past a lane's end are blanked to +1.0 (hard bit 0, never a UW hit)
    before the acquisition, as in the port's fused step; no placeable
    pick's UW reaches them.
    """
    from ..ops import deframe, fsk
    dev = resolve_device(device)
    if var is None:
        var = signal_power(sig.cpu().numpy() if isinstance(sig, torch.Tensor)
                           else sig)
    sig = torch.as_tensor(np.asarray(sig, np.complex64) if not isinstance(
        sig, torch.Tensor) else sig, device=dev).to(torch.complex64)
    ebnos = torch.as_tensor(np.asarray(ebnos, np.float32), device=dev)
    B, n = ebnos.shape[0], sig.shape[0]
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(1)
        z = torch.randn((B, n, 2), generator=generator, device=dev)
        noise = torch.complex(z[..., 0], z[..., 1])
    else:
        noise = torch.as_tensor(noise, device=dev).to(torch.complex64)
    iq = noisy_lanes(cfg, sig, var, ebnos, noise)
    _, outs = fsk.demod_lanes(cfg, iq.contiguous(), cfg.num_frames(n))
    soft = torch.where(outs.valid[..., None], outs.soft, 1.0)
    _, ok, _, pos = deframe.deframe_topk(soft.reshape(B, -1), mode, k)
    return ok, pos


def measure(B: int, cfg=None, sig=None, var=None, reps: int = REPS,
            device="cuda") -> dict:
    """One B: the first call (timed alone), then `reps` calls on fresh
    noise, each region ended by a fetch -> the record."""
    from ..ops import fsk
    cfg = fsk.V2_CONFIG if cfg is None else cfg
    dev = resolve_device(device)
    if sig is None:
        sig, var = chain_signal(cfg)
    sig_t = torch.as_tensor(sig, device=dev)
    ebnos = np.linspace(*EBNO_RANGE, B).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    first, dt, (ok, _) = time_call(lambda: chain_lanes(
        cfg, sig_t, ebnos, PACKETS, generator=gen, device=dev, var=var),
        reps)
    msps = B * len(sig) / dt / 1e6
    return {"B": B, "msamp_per_s": round(msps, 3),
            "realtime_x": round(msps * 1e6 / cfg.Fs, 1),
            "first_call_s": round(first, 3), "exec_s": round(dt, 5),
            "packets_ok": int(ok.sum()), "packets_sent": B * PACKETS,
            "ebno_db": list(EBNO_RANGE)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int, default=list(DEFAULT_B))
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from ..ops import fsk
    cfg = fsk.V2_CONFIG
    dev = resolve_device(args.device)
    emit = emitter(dev, args.out, lambda s: print(s, flush=True))
    sig, var = chain_signal(cfg)
    for B in args.batches:
        emit(measure(B, cfg, sig, var, args.reps, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
