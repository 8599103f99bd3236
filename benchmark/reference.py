"""Plain reference of the receiver's demodulator, in numpy.

The non-coherent 2/4-FSK demod of codec2's `fsk.c` (`fsk2_demod` with
`fsk_demod_freq_est`), which the program runs as a CUDA kernel: a
Hann-windowed DFT of the fresh samples into a slow EMA of the spectrum,
M first-maximum peak picks, a phase-continuous downconversion of the
frame's samples at those tones, integrate-and-dump over a symbol at P
phases, the timing from the spectral line at Rs, an elastic number of
fresh samples (nin) for the next frame, interpolated symbol sampling and
soft decisions |tone 0| - |tone 1|.  Frames are serial; lanes (independent
streams) run side by side.

`precision="float64"` is the reference.  `precision="tf32"` is its
control: float32 arithmetic with the two matrix products of the plain
formulation (the DFT and the integrate-and-dump) taking TF32 inputs, as
PyTorch computes them on a Hopper card with TF32 allowed.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    """fsk_create_hbr's geometry of a deployment (fsk.c:128-180)."""
    Fs: int
    Rs: int
    M: int
    P: int
    Nsym: int

    @property
    def Ts(self):
        return self.Fs // self.Rs

    @property
    def N(self):
        return self.Ts * self.Nsym

    @property
    def Nmem(self):
        return self.N + 2 * self.Ts

    @property
    def Ndft(self):
        return 1 << (self.N.bit_length() - 1)

    @property
    def half(self):
        return self.Ndft // 2

    @property
    def Nbits(self):
        return self.Nsym if self.M == 2 else 2 * self.Nsym

    @property
    def blocks(self):
        return max(1, (self.N + self.Ts // 2) // self.Ndft)

    @property
    def bins(self):
        """(first, end) of the estimator band in DFT bins, and the
        half-width blanked around each peak."""
        est_min, est_max = self.Rs // 4, self.Fs // 2 - self.Rs // 4
        space = self.Rs - self.Rs // 5
        return ((est_min * self.Ndft) // self.Fs,
                (est_max * self.Ndft) // self.Fs - 1,
                (space * self.Ndft) // self.Fs)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + (np.uint32(0xFFF) + ((u >> 13) & 1))) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


class _Math:
    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.control = precision == "tf32"
        self.f = np.float32 if self.control else np.float64
        self.c = np.complex64 if self.control else np.complex128

    def mm_in(self, x):
        """A matrix product's input: TF32 in the control."""
        return tf32(x) if self.control else x


def initial_state(geo: Geometry, lanes: int) -> dict:
    """The demod's state before its first frame."""
    return {"nin": np.full(lanes, geo.N, np.int64),
            "fft_est": np.zeros((lanes, geo.half)),
            "f_est": np.zeros((lanes, geo.M)), "phi": np.zeros((lanes, geo.M)),
            "norm": np.zeros(lanes), "ppm": np.zeros(lanes)}


def demodulate(geo: Geometry, X: np.ndarray, pos: np.ndarray, state: dict,
               horizons: list, precision: str = "float64") -> list:
    """Run the frames of L lanes.

    X: (L, W) complex samples, zero where the stream has none; pos: (L,)
    index in X of each lane's next fresh sample; state: as
    `initial_state`; horizons: per lane, the end (in X) of the samples
    handed over by each successive push or call.  A frame is made while
    pos + nin fits under the current horizon; then the lane moves on to
    its next horizon with its state kept.

    Returns per lane, per horizon, a dict of the frames made: soft (F,
    Nbits), nin (F,) and f_est (F, M).
    """
    m = _Math(precision)
    F, C = m.f, m.c
    L, W = X.shape
    Ts, P, M, Nsym, Nmem, N = geo.Ts, geo.P, geo.M, geo.Nsym, geo.Nmem, geo.N
    S, Ndft, half = Ts // P, geo.Ndft, geo.half
    f_lo, f_hi, f_zero = geo.bins
    NP = (Nsym + 1) * P
    X = X.astype(C)
    pos = np.asarray(pos, np.int64).copy()
    nin = state["nin"].astype(np.int64).copy()
    fft_est = state["fft_est"].astype(F)
    f_est = state["f_est"].astype(F)
    phi = state["phi"].astype(F)
    norm_prev = state["norm"].astype(F)
    ppm = state["ppm"].astype(F)

    i = np.arange(Ndft)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * i / (Ndft - 1))).astype(F)
    band = (np.arange(half) >= f_lo) & (np.arange(half) < f_hi)
    ang_dft = -2 * np.pi * np.outer(i, np.arange(half)) / Ndft
    dft_c = np.cos(ang_dft).astype(np.float32)
    dft_s = np.sin(ang_dft).astype(np.float32)
    tc = F(0.95 * Ndft / geo.Fs)
    bin_hz = F(geo.Fs / Ndft)
    two_pi = F(2 * np.pi)
    inv_fs = F(1.0 / geo.Fs)
    t = np.arange(Nmem, dtype=F)
    win_idx = (np.arange(NP) * S)[:, None] + np.arange(Ts)[None, :]
    k = np.arange(NP)
    spin = np.exp(2j * np.pi * k / P).astype(C)
    centres = (np.arange(Nsym) + 1) * P
    ar_mem = np.arange(Nmem)
    ar_blk = np.arange(geo.blocks * Ndft)
    lanes = np.arange(L)[:, None]

    cur = np.zeros(L, np.int64)
    out = [[{"soft": [], "nin": [], "f_est": []} for _ in h] for h in horizons]
    n_h = np.array([len(h) for h in horizons])
    while True:
        for l in range(L):
            while cur[l] < n_h[l] and pos[l] + nin[l] > horizons[l][cur[l]]:
                cur[l] += 1
        active = cur < n_h
        if not active.any():
            break
        end = pos + nin
        stream = X[lanes, np.clip(end[:, None] - Nmem + ar_mem, 0, W - 1)]
        fresh = X[lanes, np.clip(pos[:, None] + ar_blk, 0, W - 1)].reshape(
            L, geo.blocks, Ndft)

        # frequency estimate: windowed DFT of each fresh block into the EMA
        # (fsk.c:583-584: a block is windowed only over the samples past
        # the next block boundary)
        est = fft_est
        for j in range(geo.blocks):
            fs = np.clip(nin - (j + 1) * Ndft, 0, Ndft)
            x = fresh[:, j] * np.where(i[None] < fs[:, None], hann, F(0))
            if m.control:
                xr, xi = m.mm_in(x.real), m.mm_in(x.imag)
                cr, ci = m.mm_in(dft_c), m.mm_in(dft_s)
                spec = (xr @ cr - xi @ ci) + 1j * (xr @ ci + xi @ cr)
            else:
                spec = np.fft.fft(x, axis=-1)[:, :half]
            mag = np.sqrt(np.where(band, spec.real ** 2 + spec.imag ** 2,
                                   F(0))).astype(F)
            upd = est * (F(1) - tc) + mag * tc
            est = np.where((j < nin // Ndft)[:, None], upd, est)
        work = est.copy()
        peaks = []
        for _ in range(M):
            imax = np.argmax(work, axis=1)
            peaks.append(imax)
            off = np.arange(half)[None]
            work[(off >= imax[:, None] - f_zero)
                 & (off < imax[:, None] + f_zero)] = 0
        f_new = np.sort(np.stack(peaks, 1), axis=1).astype(F) * bin_hz
        latched = np.where((f_est[:, :1] < 1), f_new, f_est)

        # phase-continuous downconversion: the history at the last
        # estimate, the fresh samples at this frame's
        nold = (Nmem - nin).astype(F)
        theta0 = phi - two_pi * (nold[:, None] - S) * latched * inv_fs
        ang = theta0[..., None] + two_pi * inv_fs * (
            f_new[..., None] * np.maximum(t - nold[:, None, None], 0)
            + latched[..., None] * np.minimum(t, nold[:, None, None]))
        d = stream[:, None, :] * np.exp(-1j * ang).astype(C)   # (L, M, Nmem)
        phi_next = np.mod(theta0 + two_pi * inv_fs * (
            latched * nold[:, None] + f_new * (nin[:, None] - S)), two_pi)

        # integrate-and-dump over Ts samples at P phases a symbol
        if m.control:
            d = (m.mm_in(d.real) + 1j * m.mm_in(d.imag)).astype(C)
        fi = d[..., win_idx].sum(-1)                             # (L, M, NP)

        # timing from the spectral line at Rs
        line = (np.abs(fi) ** 2).sum(1)                          # (L, NP)
        tcx = (line * spin).sum(-1)
        norm = (np.arctan2(tcx.imag, tcx.real) / two_pi).astype(F)
        d_norm = norm - norm_prev
        ppm_next = np.where(np.abs(d_norm) < 0.2,
                            F(0.9) * ppm + F(0.1) * F(1e6) * d_norm / Nsym,
                            ppm)
        nin_next = np.where(norm > 0.25, N + Ts // 2,
                            np.where(norm < -0.25, N - Ts // 2, N))

        # symbol sampling between the two phases around each centre
        rx = norm * P
        low = np.floor(rx)
        frac = (rx - low)[:, None, None]
        high = low + (rx - low > 0)
        i_lo = (centres[None] + low[:, None].astype(np.int64))[:, None, :]
        i_hi = (centres[None] + high[:, None].astype(np.int64))[:, None, :]
        tv = (np.take_along_axis(fi, np.broadcast_to(i_lo, (L, M, Nsym)), 2)
              * (1 - frac)
              + np.take_along_axis(fi, np.broadcast_to(i_hi, (L, M, Nsym)), 2)
              * frac)
        mags = np.abs(tv)
        if M == 2:
            soft = mags[:, 0] - mags[:, 1]
        else:
            s1 = -mags[:, 0] + mags[:, 1] - mags[:, 2] + mags[:, 3]
            s0 = -mags[:, 0] - mags[:, 1] + mags[:, 2] + mags[:, 3]
            soft = np.stack([s0, s1], -1).reshape(L, -1)

        for l in np.flatnonzero(active):
            o = out[l][cur[l]]
            o["soft"].append(soft[l])
            o["nin"].append(nin[l])
            o["f_est"].append(f_new[l])
        a = active
        a2 = a[:, None]
        fft_est = np.where(a2, est, fft_est)
        f_est = np.where(a2, f_new, f_est)
        phi = np.where(a2, phi_next, phi)
        norm_prev = np.where(a, norm, norm_prev)
        ppm = np.where(a, ppm_next, ppm)
        pos = np.where(a, pos + nin, pos)
        nin = np.where(a, nin_next, nin)

    empty = {"soft": np.zeros((0, geo.Nbits)), "nin": np.zeros(0, np.int64),
             "f_est": np.zeros((0, M))}
    return [[{k: np.stack(v) for k, v in o.items()} if o["nin"] else empty
             for o in lane] for lane in out]
