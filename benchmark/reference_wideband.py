"""Plain reference of the wideband receiver's channelizer, in torch float64
on the CPU, from its definition (not from the polyphase and DFT structure
of the program):

    y_k[m] = sum_{j=0}^{N T - 1} h[j] x[mN - j] exp(2 pi i k j / N)

with x[n] = 0 before the stream and h the windowed-sinc prototype lowpass
of N T taps (cutoff at the channel half-width, a Hamming window, unit DC
gain).  Channel k is the band around k Fs / N, moved to baseband and
decimated by N.  `history` holds the samples before x, so that a stream
cut into pieces gives the same frames as the whole.

The demod half of the wideband cell's reference is `reference.demodulate`,
run lane by lane on the program's channel samples.

`precision="float16"` is the control: the samples and the taps rounded to
float16 first, the sums still in float64.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 1 << 16          # frames a matrix product


def prototype(N: int, T: int) -> torch.Tensor:
    """The N T prototype taps, float64: 2 fc sinc(2 fc t) at t = i - (N T
    - 1) / 2, fc = 0.5 / N, times the Hamming window 0.54 - 0.46 cos(2 pi
    i / (N T - 1)), over their sum."""
    n = N * T
    i = torch.arange(n, dtype=torch.float64)
    fc = 0.5 / N
    h = 2 * fc * torch.sinc(2 * fc * (i - (n - 1) / 2.0))
    h = h * (0.54 - 0.46 * torch.cos(2 * math.pi * i / (n - 1)))
    return h / h.sum()


def _rounded(z: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return z
    if precision != "float16":
        raise ValueError(f"unknown precision {precision!r}")
    if z.is_complex():
        return torch.complex(z.real.half().double(), z.imag.half().double())
    return z.half().double()


def channelize(x: torch.Tensor, N: int, T: int, channels,
               history: torch.Tensor | None = None,
               precision: str = "float64") -> torch.Tensor:
    """x: (n,) complex samples of the stream from a multiple of N on;
    history: the samples just before them (zeros where the stream has
    none; at least N T - 1 for exact frames, fewer count as zeros before
    them) -> (len(channels), n // N) complex128: frame m reads x[mN - j],
    j < N T, the history before x."""
    NT = N * T
    x = _rounded(x.to(torch.complex128), precision)
    prev = torch.zeros(NT, dtype=torch.complex128)
    if history is not None and len(history):
        h_tail = _rounded(history.to(torch.complex128)[-NT:], precision)
        prev[NT - len(h_tail):] = h_tail
    xx = torch.cat([prev, x])
    F = x.shape[0] // N
    j = torch.arange(NT, dtype=torch.float64)
    k = torch.as_tensor([int(c) for c in channels], dtype=torch.float64)
    h = _rounded(prototype(N, T), precision)
    # g[u, c] = h[j] exp(2 pi i k_c j / N) at j = NT - 1 - u: row u of a
    # frame's window below is x[mN - (NT - 1 - u)]
    g = (h[:, None] * torch.exp(2j * math.pi * torch.outer(j, k) / N)
         ).flip(0)
    out = torch.empty((len(k), F), dtype=torch.complex128)
    for m0 in range(0, F, BLOCK):
        m1 = min(m0 + BLOCK, F)
        win = xx[1 + m0 * N:].as_strided((m1 - m0, NT), (N, 1))
        out[:, m0:m1] = (win @ g).T
    return out
