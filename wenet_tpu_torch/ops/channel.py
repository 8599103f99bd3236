"""Channel models for self-contained Monte-Carlo testing (counterpart of
wenet_tpu/ops/channel.py): calibrated AWGN at a target Eb/N0, a complex
frequency shift, a linear-interpolation resampler, and a synthetic
multi-channel wideband capture.

numpy host versions for making captures, and torch versions for sweeps on
the device, which draw their noise from an explicit `torch.Generator`.
"""
from __future__ import annotations

import numpy as np
import torch


def signal_variance(iq: np.ndarray, threshold_db: float = -100.0) -> float:
    """Variance of the samples above a power threshold."""
    iq = np.asarray(iq)
    p = 20 * np.log10(np.abs(iq) + 1e-30)
    return float(np.var(iq[p > threshold_db]))


def add_awgn(iq: np.ndarray, ebno_db: float, Fs: int, Rs: int,
             variance: float | None = None, bits_per_symbol: float = 1.0,
             normalise: bool = True, rng=None) -> np.ndarray:
    """Calibrated AWGN: noise variance = var * Fs / (Rs * Eb/N0 * bits)."""
    rng = np.random.default_rng() if rng is None else rng
    var = signal_variance(iq) if variance is None else variance
    ebno = 10.0 ** (ebno_db / 10.0)
    nvar = var * Fs / (Rs * ebno * bits_per_symbol)
    n = (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
    noisy = iq + np.sqrt(nvar / 2.0) * n
    if normalise:
        noisy = noisy / np.max(np.abs(noisy))
    return noisy.astype(np.complex64)


def freq_shift(iq: np.ndarray, shift_hz: float, Fs: int) -> np.ndarray:
    """Mix by exp(j 2 pi shift t)."""
    n = np.arange(len(iq), dtype=np.float64)
    return (np.asarray(iq) * np.exp(2j * np.pi * shift_hz * n / Fs)
            ).astype(np.complex64)


def resample_linear(iq: np.ndarray, ratio: float) -> np.ndarray:
    """Resample by `ratio` (output rate = input rate * ratio) with linear
    interpolation: the baud-rate-error fault injection."""
    iq = np.asarray(iq)
    n_out = int(len(iq) * ratio)
    t = np.arange(n_out, dtype=np.float64) / ratio
    i0 = np.minimum(t.astype(np.int64), len(iq) - 2)
    frac = t - i0
    return ((1 - frac) * iq[i0] + frac * iq[i0 + 1]).astype(np.complex64)


# ---------------------------------------------------------- torch versions


def add_awgn_torch(iq: torch.Tensor, ebno_db, Fs: int, Rs: int, variance,
                   generator: torch.Generator | None = None,
                   bits_per_symbol: float = 1.0) -> torch.Tensor:
    """Device AWGN for Monte-Carlo sweeps, peak-normalised per row.
    ebno_db may be a tensor of leading axes that broadcast against iq's;
    the noise comes from `generator` (on iq's device)."""
    dev = iq.device
    ebno = 10.0 ** (torch.as_tensor(ebno_db, dtype=torch.float32,
                                    device=dev) / 10.0)
    nvar = variance * Fs / (Rs * ebno * bits_per_symbol)
    shape = torch.broadcast_shapes(tuple(nvar.shape) + (1,), iq.shape)
    n = torch.randn(shape + (2,), generator=generator, dtype=torch.float32,
                    device=dev)
    noise = torch.complex(n[..., 0], n[..., 1])
    scaled = torch.sqrt(nvar / 2.0)
    if nvar.dim():
        scaled = scaled[..., None]
    noisy = iq + scaled * noise
    peak = torch.amax(torch.abs(noisy), dim=-1, keepdim=True)
    return (noisy / peak).to(torch.complex64)


def freq_shift_torch(iq: torch.Tensor, shift_hz, Fs: int) -> torch.Tensor:
    """Mix by exp(j 2 pi shift n / Fs) in float32; shift_hz may be a tensor
    of leading axes."""
    n = torch.arange(iq.shape[-1], dtype=torch.float32, device=iq.device)
    if isinstance(shift_hz, torch.Tensor) and shift_hz.dim():
        shift = shift_hz.to(torch.float32)[..., None]
        ang = 2 * np.pi * shift * n / Fs
    else:
        ang = 2 * np.pi * float(shift_hz) * n / Fs
    return iq * torch.complex(torch.cos(ang), torch.sin(ang))


def wideband_capture(cfg, n_channels: int, packets: int, ebno_db: float,
                     seed: int):
    """A synthetic wideband capture at n_channels * cfg.Fs, after
    tools/wideband_scaling.py: on channel k (its bits from
    `np.random.default_rng(seed + k)`) 8 frames of random bits, then
    `packets` random-payload v2 packets with 512 random bits after each,
    FSK-modulated at the wideband rate and mixed to the channel's centre
    (`channelizer.channel_centres`); then AWGN at ebno_db per channel (from
    `default_rng(seed + n_channels)`).  Returns (complex64 capture,
    {channel: [payloads]})."""
    import dataclasses

    from ..core import framing
    from . import channelizer, fsk, ldpc

    fs_total = cfg.Fs * n_channels
    wide_cfg = dataclasses.replace(cfg, Fs=fs_total)
    centres = channelizer.channel_centres(fs_total, n_channels)
    wide, sent = None, {}
    for k in range(n_channels):
        r = np.random.default_rng(seed + k)
        bits, sent[k] = [r.integers(0, 2, cfg.Nbits * 8).astype(np.uint8)], []
        for _ in range(packets):
            p = r.integers(0, 256, 256, dtype=np.uint8).tobytes()
            sent[k].append(p)
            bits += [framing.frame_to_bits(framing.frame_packet(
                p, ldpc.encode_bytes, "v2"), "v2"),
                r.integers(0, 2, 512).astype(np.uint8)]
        bits = np.concatenate(bits)
        bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits,
                                              np.uint8)])
        sig, _ = fsk.fsk_mod_np(wide_cfg, bits, 2 * cfg.Rs, cfg.Rs)
        if wide is None:             # all channels share one length
            wide = np.zeros(len(sig), np.complex64)
            t = np.arange(len(sig), dtype=np.float64) / fs_total
        wide += (sig * np.exp(2j * np.pi * centres[k] * t)).astype(
            np.complex64)
    wide = add_awgn(wide, ebno_db + 10 * np.log10(n_channels), fs_total,
                    cfg.Rs, rng=np.random.default_rng(seed + n_channels))
    return wide.astype(np.complex64), sent
