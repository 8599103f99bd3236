"""Math helpers kept identical to wenet_tpu/utils/compat.py.

`dft` is the same one-matmul DFT against the same float64-built tables,
and `atan2` the same odd polynomial: keeping both formulas keeps the tone
estimate and `norm_rx_timing` (hence the elastic `nin` decision) aligned
with the reference.  The float32 matmul runs at full precision (see
`wenet_tpu_torch.device`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _dft_matrix(n: int, n_out: int | None, device: torch.device):
    """[[C, S], [-S, C]] (2n, 2 n_out) float32 on `device`; the cos/sin
    tables are built in float64 as the reference builds them."""
    k = np.arange(n, dtype=np.float64)
    ang = (-2.0 * np.pi / n) * np.outer(k, k % n)
    C, S = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    if n_out is not None:
        C, S = C[:, :n_out], S[:, :n_out]
    T = np.concatenate([np.concatenate([C, S], axis=1),
                        np.concatenate([-S, C], axis=1)], axis=0)
    return torch.as_tensor(np.ascontiguousarray(T), device=device)


def dft(x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
    """Complex DFT along the last axis as ONE real matmul
    [xr | xi] @ [[C, S], [-S, C]]; keeps only the first n_out bins."""
    N = x.shape[-1]
    T = _dft_matrix(N, n_out, x.device)
    n_o = T.shape[1] // 2
    y = torch.matmul(torch.cat([x.real, x.imag], dim=-1).float(), T)
    return torch.complex(y[..., :n_o], y[..., n_o:])


@lru_cache(maxsize=1)
def _atan_coeffs():
    """Odd-polynomial least-squares fit of atan on [0, 1] (the reference's
    deterministic host-side fit)."""
    t = np.linspace(0, 1, 4001)
    y = np.arctan(t)
    s = (t * t)[1:]
    A = np.vander(s, 9, increasing=True)
    coef, *_ = np.linalg.lstsq(A * t[1:, None], y[1:], rcond=None)
    return tuple(float(c) for c in coef)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent from the polynomial atan."""
    c = _atan_coeffs()
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.where(hi > 0, hi, 1.0)
    s = t * t
    p = torch.full_like(s, c[8])
    for k in range(7, -1, -1):
        p = p * s + c[k]
    r = t * p
    r = torch.where(ay > ax, np.float32(np.pi / 2) - r, r)
    r = torch.where(x < 0, np.float32(np.pi) - r, r)
    r = torch.where(y < 0, -r, r)
    return torch.where(hi > 0, r, 0.0)
