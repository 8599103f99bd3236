"""The wideband cell's traffic: one band of n channels of a deployment's
rate, each channel a Wenet stream of back-to-back frames, quantised to the
cu8 bytes of the front end.

After the port's `ops/channel.py` `wideband_capture`: each channel's bits
FSK-modulated at the band rate (`traffic.modulate` of a deployment at
n * Fs), mixed to the channel's centre k * Fs (negative ks wrapped, as
`channel_centres`; the mix is exp(2 pi i k t / n) at the band's sample t,
exact for integer t), summed, AWGN at the channels' Eb/N0 + 10 log10 n
over the band (`traffic.add_noise` at the band rate, so that each channel
sees ebno_db), peak-normalised and quantised (`traffic.to_cu8`).

Channel k carries its own seeded payloads (`traffic.packet_bits`, frames
back to back) and starts a seed-drawn number of symbols into its frame
sequence, so that packet ends differ by channel; every channel holds the
same whole number of frames, so the recording replays end to end in a
loop as an unbroken stream of frames on every channel.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import traffic


@dataclasses.dataclass
class Band:
    """One band recording: its cu8 bytes in host memory and, a channel,
    the payloads in air order and the band sample just past each one's
    last symbol."""
    raw: np.ndarray            # (2 n,) uint8
    payloads: list             # [[bytes] a channel]
    ends: list                 # [(n_packets,) int64 a channel]
    n_samples: int


def band_deployment(dep: traffic.Deployment, n_channels: int
                    ) -> traffic.Deployment:
    """The deployment's modem at the band rate n * Fs."""
    return dataclasses.replace(dep, name=f"{dep.name}.band",
                               Fs=dep.Fs * n_channels)


def make_band(dep: traffic.Deployment, n_channels: int, seconds: float,
              ebno_db: float, seed: int, device) -> Band:
    """The band recording of `seed`: as many whole frames a channel as fit
    in seconds * Rs symbols."""
    if dep.M != 2:
        raise ValueError("the band generator frames 2FSK channels")
    band = band_deployment(dep, n_channels)
    n_packets = int(round(seconds * dep.Rs)) // dep.frame_bits
    n_sym = n_packets * dep.frame_bits
    n = n_sym * band.Ts
    dev = torch.device(device)
    turn = torch.polar(torch.ones(n_channels, dtype=torch.float64, device=dev),
                       torch.arange(n_channels, dtype=torch.float64,
                                    device=dev) * (2.0 * np.pi / n_channels)
                       ).to(torch.complex64)
    t = torch.arange(n, dtype=torch.int64, device=dev)
    wide = torch.zeros(n, dtype=torch.complex64, device=dev)
    payloads, ends = [], []
    for k in range(n_channels):
        rng = np.random.default_rng([k, seed % 2 ** 63, 23])
        bits, pay = traffic.packet_bits(dep, n_packets, rng, 0, 0)
        r = int(rng.integers(0, n_sym))
        sig = traffic.modulate(band, torch.from_numpy(
            np.roll(bits, -r)).to(dev))
        wide += sig * turn[(t * k) % n_channels]
        del sig
        end = ((np.arange(1, n_packets + 1, dtype=np.int64) * dep.frame_bits
                - r - 1) % n_sym + 1)
        order = np.argsort(end, kind="stable")
        payloads.append([pay[i].tobytes() for i in order])
        ends.append(end[order] * band.Ts)
    del t
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 1_000_003 + 7) % 2 ** 63)
    noisy = traffic.add_noise(band, wide, ebno_db + 10 * np.log10(n_channels),
                              gen)
    del wide
    raw = traffic.to_cu8(noisy)
    return Band(raw=raw.cpu().numpy(), payloads=payloads, ends=ends,
                n_samples=n)
