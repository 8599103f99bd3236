"""2/4-FSK modem on tensors (counterpart of wenet_tpu/ops/fsk.py).

The host-side pieces (config, modulator, sample conversion) are numpy
copies of the reference; `fsk_mod` is the modulator on the tensor's
device, and `demod_iq_np` the demod of a whole host capture.  The demodulator runs the same per-frame algebra
as the reference's scan body — Hann-windowed DFT tone estimate with a slow
EMA and first-max peak picks, phase-continuous downconvert, integrate-and-
dump at P phases as a banded matmul, timing from the spectral line at Rs,
elastic nin, interpolated symbol decisions, soft bits and Eb/N0.

Two versions compute it.  The plain one, `demod_stream_reference` (and
`demod_lanes_reference`, its `torch.func.vmap` over lanes), is a Python
loop over frames whose read pointer stays a tensor, with no data-dependent
control flow.  On a CUDA tensor every entry point (`demod_raw`,
`demod_stream`, `demod_lanes`) launches the persistent frame-loop kernel
instead (`kernels.fsk_demod`, one block per lane walking its frames with
the state on chip); the plain loop runs for CPU tensors and in the
comparisons with the kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import compat

TWO_PI = 2.0 * np.pi


# ------------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class FSKConfig:
    """Static modem geometry (mirror of fsk_create_hbr, fsk.c:128-180)."""

    Fs: int
    Rs: int
    M: int = 2
    P: int | None = None          # defaults to Ts
    Nsym: int = 48
    est_min: int | None = None    # estimator band, Hz
    est_max: int | None = None

    def __post_init__(self):
        if self.Fs % self.Rs:
            raise ValueError("Fs must be an integer multiple of Rs")
        P = self.Ts if self.P is None else self.P
        object.__setattr__(self, "P", P)
        if self.Ts % P:
            raise ValueError("Ts must be an integer multiple of P")
        if self.M not in (2, 4):
            raise ValueError("M must be 2 or 4")
        object.__setattr__(
            self, "est_min", self.Rs // 4 if self.est_min is None else self.est_min)
        object.__setattr__(
            self, "est_max",
            self.Fs // 2 - self.Rs // 4 if self.est_max is None else self.est_max)

    @property
    def Ts(self) -> int:
        return self.Fs // self.Rs

    @property
    def N(self) -> int:
        return self.Ts * self.Nsym

    @property
    def Nmem(self) -> int:
        return self.N + 2 * self.Ts

    @property
    def nstash(self) -> int:
        return 4 * self.Ts

    @property
    def Ndft(self) -> int:
        return 1 << (self.N.bit_length() - 1)   # highest power of 2 <= N

    @property
    def est_space(self) -> int:
        return self.Rs - self.Rs // 5

    @property
    def Nbits(self) -> int:
        return self.Nsym if self.M == 2 else 2 * self.Nsym

    @property
    def f_min_bin(self) -> int:
        return (self.est_min * self.Ndft) // self.Fs

    @property
    def f_max_bin(self) -> int:
        return (self.est_max * self.Ndft) // self.Fs

    @property
    def f_zero_bins(self) -> int:
        return (self.est_space * self.Ndft) // self.Fs

    @property
    def ema_tc(self) -> float:
        return 0.95 * self.Ndft / self.Fs

    @property
    def max_fft_blocks(self) -> int:
        return max(1, (self.N + self.Ts // 2) // self.Ndft)

    @property
    def nin_choices(self):
        return (self.N - self.Ts // 2, self.N, self.N + self.Ts // 2)

    def num_frames(self, n_samples: int) -> int:
        """Upper bound on demod frames for a capture."""
        return n_samples // (self.N - self.Ts // 2) + 1


V1_CONFIG = FSKConfig(Fs=921416, Rs=115177)    # Ts=P=8
V2_CONFIG = FSKConfig(Fs=960000, Rs=96000)     # Ts=P=10


def hann_window(Ndft: int) -> np.ndarray:
    """0.5 - 0.5*cos(2 pi i/(Ndft-1)) — the table of fsk.c:94-111."""
    i = np.arange(Ndft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(TWO_PI * i / (Ndft - 1))).astype(np.float32)


# ---------------------------------------------------------------- modulator


def _sym_freqs(cfg: FSKConfig, f1: int, shift: int) -> np.ndarray:
    return np.array([f1 + shift * m for m in range(cfg.M)], dtype=np.int64)


def bits_to_symbols(bits: np.ndarray, M: int) -> np.ndarray:
    """MSB-first bit packing into M-ary symbols."""
    bits = np.asarray(bits)
    if M == 2:
        return bits.astype(np.int64)
    return (bits.reshape(*bits.shape[:-1], -1, 2) * np.array([2, 1])).sum(-1)


def fsk_mod_np(cfg: FSKConfig, bits: np.ndarray, f1: int, shift: int,
               complex_out: bool = True, phase_acc: int = 0):
    """Continuous-phase FSK with an exact integer phase accumulator (numpy).
    Returns (samples, final_phase_acc) so long streams can be chunked."""
    syms = bits_to_symbols(bits, cfg.M)
    freqs = _sym_freqs(cfg, f1, shift)[syms]
    sym_adv = (freqs * cfg.Ts) % cfg.Fs
    start = (phase_acc + np.concatenate([[0], np.cumsum(sym_adv)[:-1]])) % cfg.Fs
    j = np.arange(1, cfg.Ts + 1, dtype=np.int64)
    acc = (start[:, None] + freqs[:, None] * j[None, :]) % cfg.Fs
    theta = (TWO_PI / cfg.Fs) * acc.astype(np.float64)
    out = 2.0 * np.exp(1j * theta) if complex_out else 2.0 * np.cos(theta)
    final = int((phase_acc + int(np.sum(sym_adv))) % cfg.Fs)
    return out.reshape(-1).astype(np.complex64 if complex_out else np.float32), final


def fsk_mod_ext_vco(cfg: FSKConfig, bits: np.ndarray, f1: int,
                    shift: int) -> np.ndarray:
    """Per-sample VCO drive voltage (= instantaneous tone frequency in Hz),
    for an external-VCO transmitter (fsk.c:1207-1243)."""
    syms = bits_to_symbols(np.asarray(bits), cfg.M)
    freqs = _sym_freqs(cfg, f1, shift)[syms].astype(np.float32)
    return np.repeat(freqs, cfg.Ts)


def _phase_acc(cfg: FSKConfig, bits: torch.Tensor, f1: int,
               shift: int) -> torch.Tensor:
    """The modulator's integer phase accumulator, (..., nsym, Ts) int64:
    an int64 exclusive cumsum of the symbols' phase advances taken modulo
    Fs (the JAX package's two-level int32 wrap gives the same integers)."""
    dev = bits.device
    freqs_tab = torch.as_tensor(_sym_freqs(cfg, f1, shift), device=dev)
    if cfg.M == 2:
        syms = bits.long()
    else:
        syms = (bits.reshape(*bits.shape[:-1], -1, 2).long()
                * torch.tensor([2, 1], device=dev)).sum(-1)
    freqs = freqs_tab[syms]                                   # (..., nsym)
    sym_adv = (freqs * cfg.Ts) % cfg.Fs
    start = (torch.cumsum(sym_adv, dim=-1) - sym_adv) % cfg.Fs
    j = torch.arange(1, cfg.Ts + 1, dtype=torch.int64, device=dev)
    return (start[..., None] + freqs[..., None] * j) % cfg.Fs


def fsk_mod(cfg: FSKConfig, bits: torch.Tensor, f1: int,
            shift: int) -> torch.Tensor:
    """Modulator on the tensor's device: bits (..., nbits) -> complex64
    (..., nsym*Ts), from the exact integer phase accumulator of
    `fsk_mod_np` (`_phase_acc`); the angle and its cos/sin in float32, as
    the JAX package's fsk_mod forms them."""
    acc = _phase_acc(cfg, bits, f1, shift)
    theta = acc.float() * np.float32(TWO_PI / cfg.Fs)
    out = 2.0 * torch.complex(torch.cos(theta), torch.sin(theta))
    return out.reshape(*bits.shape[:-1], -1)


# ------------------------------------------------------- sample conversion


FDMDV_SCALE = 825.0   # src/codec2_fdmdv.h:113


def iq_from_cu8(raw: np.ndarray) -> np.ndarray:
    """Complex u8 -> complex64, (x-127)/128."""
    raw = np.asarray(raw, np.uint8).astype(np.float32)
    return ((raw[0::2] - 127.0) + 1j * (raw[1::2] - 127.0)).astype(np.complex64) / 128.0


def iq_from_cs16(raw: np.ndarray) -> np.ndarray:
    """Complex s16 -> complex64, /FDMDV_SCALE."""
    raw = np.asarray(raw, np.int16).astype(np.float32)
    return ((raw[0::2] + 1j * raw[1::2]) / FDMDV_SCALE).astype(np.complex64)


def iq_from_s16_real(raw: np.ndarray) -> np.ndarray:
    """Real s16 -> complex64 (imag 0), /FDMDV_SCALE."""
    raw = np.asarray(raw, np.int16).astype(np.float32)
    return (raw / FDMDV_SCALE).astype(np.complex64)


def iq_to_cu8(iq: np.ndarray) -> np.ndarray:
    """complex64 -> interleaved u8 (inverse of iq_from_cu8, clipped)."""
    x = np.empty(2 * len(iq), np.float32)
    x[0::2] = np.real(iq)
    x[1::2] = np.imag(iq)
    return np.clip(np.round(x * 128.0 + 127.0), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- demod state


class DemodState(NamedTuple):
    """Frame-loop carry == the reference FSK struct's mutable fields.  All
    fields are tensors on the demod's device."""
    pos: torch.Tensor             # int32 next-new-sample index
    nin: torch.Tensor             # int32 samples consumed this frame
    fft_est: torch.Tensor         # (Ndft/2,) f32 EMA of tone spectrum
    f_est: torch.Tensor           # (M,) f32 latched tone estimates
    phi: torch.Tensor             # (M,) f32 carrier phases (rad, wrapped)
    norm_rx_timing: torch.Tensor  # f32
    ppm: torch.Tensor             # f32
    ebno_db: torch.Tensor         # f32
    snr_est: torch.Tensor         # f32


class FrameOut(NamedTuple):
    """Per-frame outputs, stacked over frames by demod_stream."""
    soft: torch.Tensor            # (Nbits,) f32 soft decisions
    bits: torch.Tensor            # (Nbits,) uint8 hard decisions
    valid: torch.Tensor           # bool — frame fully inside the capture
    f_est: torch.Tensor           # (M,) f32
    ebno_db: torch.Tensor         # f32
    norm_rx_timing: torch.Tensor  # f32
    ppm: torch.Tensor             # f32
    nin: torch.Tensor             # int32 (nin used for this frame)


class EyeProbe(NamedTuple):
    """The last valid frame's integrator outputs, which the eye diagram is
    traced from (zeros, and ok False, when no frame was valid)."""
    f_int: torch.Tensor           # (M, (Nsym+1)*P) complex64
    high_sample: torch.Tensor     # int32
    ok: torch.Tensor              # bool — some frame was valid


class ProbeTrace(NamedTuple):
    """Per-frame internals of the demod, stacked over frames: what the JAX
    package's `_demod_frame(with_probe=True)` returns, and the estimator's
    EMA after the frame's update.  Frames past the capture's end keep the
    final EMA; their other fields are garbage (the kernel zeroes them)."""
    f_int: torch.Tensor           # (frames, M, (Nsym+1)*P) complex64
    fft_est: torch.Tensor         # (frames, Ndft/2) f32
    rx_timing: torch.Tensor       # (frames,) f32, norm_rx_timing * P
    high_sample: torch.Tensor     # (frames,) int32


_STATE_DTYPES = {"pos": torch.int32, "nin": torch.int32}


def demod_init(cfg: FSKConfig, device="cuda") -> DemodState:
    """The reference's initial demod state on `device` (CUDA unless the
    caller asks for another; raises without a card)."""
    device = resolve_device(device)

    def f(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return DemodState(
        pos=torch.tensor(0, dtype=torch.int32, device=device),
        nin=torch.tensor(cfg.N, dtype=torch.int32, device=device),
        fft_est=f(cfg.Ndft // 2), f_est=f(cfg.M), phi=f(cfg.M),
        norm_rx_timing=f(), ppm=f(), ebno_db=f(), snr_est=f())


def state_from_numpy(d: dict, device="cuda") -> DemodState:
    """DemodState from {field: numpy array} — e.g. a JAX DemodState's
    `{k: np.asarray(v) for k, v in state._asdict().items()}`."""
    device = resolve_device(device)
    return DemodState(**{
        k: torch.as_tensor(np.array(d[k]), device=device).to(
            _STATE_DTYPES.get(k, torch.float32))
        for k in DemodState._fields})


def state_to_numpy(state: DemodState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


# ------------------------------------------------------------ per-frame core


@functools.lru_cache(maxsize=16)
def _constants(cfg: FSKConfig, device: torch.device) -> dict:
    """Static per-geometry tensors: Hann window, estimator band mask, the
    banded integrate-and-dump matrix, timing spin, sampling offsets."""
    Ts, P, Nsym, Nmem = cfg.Ts, cfg.P, cfg.Nsym, cfg.Nmem
    half = cfg.Ndft // 2
    bins = np.arange(half)
    band = (bins >= cfg.f_min_bin) & (bins < cfg.f_max_bin - 1)
    starts = np.arange((Nsym + 1) * P) * (Ts // P)
    t_i = np.arange(Nmem)[:, None]
    wsum = ((t_i >= starts[None, :]) & (t_i < starts[None, :] + Ts))
    spin_ang = np.float32(TWO_PI / P) * np.arange((Nsym + 1) * P,
                                                   dtype=np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)
    return {
        "hann": t(hann_window(cfg.Ndft)),
        "idx": t(np.arange(cfg.Ndft)),
        "band": t(band),
        "off": t(np.arange(half)),
        "wsum": t(wsum.astype(np.float32)),
        "spin_re": torch.cos(t(spin_ang)),
        "spin_im": torch.sin(t(spin_ang)),
        "t": t(np.arange(Nmem, dtype=np.float32))[None, :],
        "st": t((np.arange(Nsym) + 1) * P, torch.int64),
        "ar_nmem": t(np.arange(Nmem), torch.int64),
        "ar_nb": t(np.arange(cfg.Ndft * cfg.max_fft_blocks), torch.int64),
    }


def _est_mags(cfg: FSKConfig, new_samps, nin, consts):
    """The estimator blocks of one frame: per Ndft block, the Hann-windowed
    DFT's band-masked magnitude (a list of max_fft_blocks rows)."""
    Ndft, half = cfg.Ndft, cfg.Ndft // 2
    blocks = new_samps.reshape(cfg.max_fft_blocks, Ndft)
    mags = []
    for j in range(cfg.max_fft_blocks):
        # quirk kept from fsk.c:583-584: the last block is windowed only over
        # the samples beyond the next block boundary
        fft_samps = torch.clamp(nin - (j + 1) * Ndft, 0, Ndft)
        win = torch.where(consts["idx"] < fft_samps, consts["hann"], 0.0)
        spec = compat.dft(blocks[j] * win, n_out=half)
        mag2 = torch.square(spec.real) + torch.square(spec.imag)
        mags.append(torch.sqrt(torch.where(consts["band"], mag2, 0.0)))
    return mags


def _est_ema(cfg: FSKConfig, fft_est, mags, nin):
    """The EMA after one frame's estimator blocks (those below nin)."""
    tc = np.float32(cfg.ema_tc)
    one_m_tc = np.float32(1) - tc
    n_blocks = nin // cfg.Ndft
    for j, mag in enumerate(mags):
        upd = fft_est * one_m_tc + mag * tc
        fft_est = torch.where(j < n_blocks, upd, fft_est)
    return fft_est


def _est_peaks(cfg: FSKConfig, fft_est, consts):
    """M first-max peak picks with +/-f_zero blanking on a copy of the EMA;
    ascending sort; bin -> Hz."""
    work = fft_est
    off = consts["off"]
    peaks = []
    for _ in range(cfg.M):
        imax = torch.argmax(work)                      # first maximal index
        peaks.append(imax)
        blank = (off >= imax - cfg.f_zero_bins) & (off < imax + cfg.f_zero_bins)
        work = torch.where(blank, 0.0, work)
    bin_hz = np.float32(cfg.Fs / cfg.Ndft)
    if cfg.M == 2:
        lo = torch.minimum(peaks[0], peaks[1])
        hi = torch.maximum(peaks[0], peaks[1])
        return torch.stack([lo, hi]).float() * bin_hz
    return torch.sort(torch.stack(peaks)).values.float() * bin_hz


def _freq_est_step(cfg: FSKConfig, fft_est, new_samps, nin, consts):
    """One frame of fsk_demod_freq_est: per-Ndft-block Hann window -> DFT ->
    band-masked |.| -> EMA; then M first-max peak picks with +/-f_zero
    blanking on a copy of the EMA; ascending sort; bin -> Hz."""
    fft_est = _est_ema(cfg, fft_est, _est_mags(cfg, new_samps, nin, consts),
                       nin)
    return fft_est, _est_peaks(cfg, fft_est, consts)


def _fma(a, b, c) -> torch.Tensor:
    """a*b + c rounded once to float32 (the float64 product is exact).

    The carrier-phase angles reach ~1500 rad, where one float32 ULP is
    1.2e-4 rad, so whether a multiply-add rounds once or twice shows in the
    soft bits.  The reference, compiled by XLA, contracts these
    multiply-adds into FMAs; the port rounds them once at the same places.
    """
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) if not
               isinstance(x, torch.Tensor) else x.double() for x in (a, b, c))
    return (a * b + c).float()


def _fmod_floor(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floor-mod as jnp.mod computes it: exact fmod, then +y where the
    signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _tone_phases(cfg: FSKConfig, f_prev, phi, f_new, nin):
    """The latched tones, the downconvert's start phase theta0 (M, 1) and
    the next frame's carrier phases, from the frame before's tones f_prev
    and phases phi."""
    S = cfg.Ts // cfg.P
    latched = torch.where(f_prev[0] < 1.0, f_new, f_prev)
    inv_fs = np.float32(1.0 / cfg.Fs)
    two_pi = np.float32(TWO_PI)
    two_pi_fs = two_pi * inv_fs
    noldf = (cfg.Nmem - nin).float()
    theta0 = _fma(-(two_pi * (noldf - S) * latched[:, None]), inv_fs,
                  phi[:, None])
    phi_next = _fmod_floor(
        _fma(two_pi_fs, _fma(latched, noldf, f_new * (nin.float() - S)),
             theta0[:, 0]),
        float(two_pi))
    return latched, theta0, phi_next


def _demod_body(cfg: FSKConfig, stream, latched, f_new, theta0, nin, consts):
    """Downconvert, integrate-and-dump, timing and decisions of one frame
    -> (fi_re, fi_im, norm_rx_timing, nin_next, soft, bits, ebno_db, high,
    rx_timing)."""
    Ts, P, M, Nsym = cfg.Ts, cfg.P, cfg.M, cfg.Nsym
    noldf = (cfg.Nmem - nin).float()

    # downconvert: old samples at the latched estimate, new samples at this
    # frame's estimate, phase-continuous
    inv_fs = np.float32(1.0 / cfg.Fs)
    two_pi = np.float32(TWO_PI)
    two_pi_fs = two_pi * inv_fs
    f_old = latched[:, None]
    f_cur = f_new[:, None]
    t = consts["t"]
    ang = _fma(two_pi_fs, _fma(f_cur, torch.clamp(t - noldf, min=0.0),
                               f_old * torch.minimum(t, noldf)),
               theta0)
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    sr, si = stream.real[None, :], stream.imag[None, :]
    # stream * e^{-j ang}
    d_re = sr * cos_a + si * sin_a
    d_im = si * cos_a - sr * sin_a

    # integrate-and-dump at P phases: window sums of length Ts at stride
    # Ts/P as one banded matmul, real and imaginary rows stacked
    prod = torch.matmul(torch.cat([d_re, d_im], dim=0), consts["wsum"])
    fi_re, fi_im = prod[:M], prod[M:]

    # fine timing: spectral line at Rs
    # (the timing line sums in float64: its cancellation amplifies
    # reduction-order differences into norm_rx_timing)
    ft1 = torch.sum(_fma(fi_re, fi_re, torch.square(fi_im)), dim=0)
    tc_re = torch.sum(ft1.double() * consts["spin_re"].double()).float()
    tc_im = torch.sum(ft1.double() * consts["spin_im"].double()).float()
    norm_rx_timing = compat.atan2(tc_im, tc_re) / two_pi
    rx_timing = norm_rx_timing * P

    # elastic nin for the next frame
    nin_next = torch.where(
        norm_rx_timing > 0.25, cfg.N + Ts // 2,
        torch.where(norm_rx_timing < -0.25, cfg.N - Ts // 2, cfg.N)
    ).to(torch.int32)

    # symbol sampling with linear interpolation between the floor and
    # ceil integrator phases around each symbol centre
    low = torch.floor(rx_timing)
    fract = rx_timing - low
    high = low + (fract > 0).float()
    i_lo = consts["st"] + low.long()
    i_hi = consts["st"] + high.long()
    w_lo = 1 - fract
    tv_re = fi_re[:, i_lo] * w_lo + fi_re[:, i_hi] * fract
    tv_im = fi_im[:, i_lo] * w_lo + fi_im[:, i_hi] * fract
    tmax = torch.square(tv_re) + torch.square(tv_im)           # (M, Nsym)

    mags = torch.sqrt(tmax)
    if M == 2:
        bits = (tmax[1] > tmax[0]).to(torch.uint8)             # ties -> 0
        soft = mags[0] - mags[1]
    else:
        sym = torch.argmax(tmax, dim=0)                        # first max
        bits = torch.stack([(sym >> 1) & 1, sym & 1], dim=-1).reshape(-1).to(
            torch.uint8)
        s1 = -mags[0] + mags[1] - mags[2] + mags[3]
        s0 = -mags[0] - mags[1] + mags[2] + mags[3]
        soft = torch.stack([s0, s1], dim=-1).reshape(-1)

    # Eb/N0 from the winning magnitudes
    win = torch.max(tmax, dim=0).values
    meane = torch.mean(torch.sqrt(win))
    stde = torch.mean(win) - meane * meane
    stde = torch.sqrt(torch.clamp(stde, min=0.0))
    ebno_db = -6 + 20 * torch.log10((1e-6 + meane) / (1e-6 + stde))
    return (fi_re, fi_im, norm_rx_timing, nin_next, soft, bits, ebno_db,
            high, rx_timing)


def _ppm_step(cfg: FSKConfig, norm_prev, ppm, norm_rx_timing):
    """The clock-offset ppm IIR, gated on jumps of the timing."""
    d_norm = norm_rx_timing - norm_prev
    appm = 1e6 * d_norm / cfg.Nsym
    return torch.where(torch.abs(d_norm) < 0.2, 0.9 * ppm + 0.1 * appm, ppm)


def _demod_frame(cfg: FSKConfig, state: DemodState, stream, new_blocks,
                 consts):
    """Demodulate one frame (fsk2_demod, fsk.c:679-1108).

    stream: (Nmem,) complex64 = [history | the nin fresh samples].
    new_blocks: (max_fft_blocks*Ndft,) complex64 fresh samples for the
            frequency estimator.

    The frame's pieces: the estimator blocks' magnitudes (`_est_mags`),
    the EMA (`_est_ema`) and its peaks (`_est_peaks`), the tones' phases
    (`_tone_phases`), the demod proper (`_demod_body`), the ppm IIR
    (`_ppm_step`) and the SNR average; the frame-parallel kernel's design
    test composes them in the kernel's schedule.
    """
    nin = state.nin
    fft_est, f_new = _freq_est_step(cfg, state.fft_est, new_blocks, nin,
                                    consts)
    latched, theta0, phi_next = _tone_phases(cfg, state.f_est, state.phi,
                                             f_new, nin)
    (fi_re, fi_im, norm_rx_timing, nin_next, soft, bits, ebno_db, high,
     rx_timing) = _demod_body(cfg, stream, latched, f_new, theta0, nin,
                              consts)
    ppm = _ppm_step(cfg, state.norm_rx_timing, state.ppm, norm_rx_timing)
    snr_est = 0.5 * state.snr_est + 0.5 * ebno_db

    new_state = DemodState(
        pos=state.pos + nin, nin=nin_next, fft_est=fft_est, f_est=f_new,
        phi=phi_next, norm_rx_timing=norm_rx_timing, ppm=ppm,
        ebno_db=ebno_db, snr_est=snr_est)
    out = FrameOut(soft=soft, bits=bits, valid=None, f_est=f_new,
                   ebno_db=ebno_db, norm_rx_timing=norm_rx_timing, ppm=ppm,
                   nin=nin)
    probe = (torch.complex(fi_re, fi_im), high.to(torch.int32), rx_timing)
    return new_state, out, probe


def eye_diagram(f_int: np.ndarray, P: int, high_sample: int, M: int,
                max_ind: int = 160, et_max: int = 8,
                normalise: bool = True) -> np.ndarray:
    """Eye-diagram traces from the integrator outputs (fsk.c:1031-1079):
    per tone, `et_max/M` two-symbol windows of |f_int| centred on the
    timing estimate, decimated to fit max_ind samples, normalised to 1
    (host numpy, as the reference)."""
    neyesamp_dec = int(np.ceil(2 * P / max_ind))
    neyesamp = (2 * P) // neyesamp_dec
    offset = int(high_sample) + 1
    traces = et_max // M
    eye = np.zeros((traces * M, neyesamp), np.float32)
    for i in range(traces):
        for m in range(M):
            idx = 2 * P * i + offset + np.arange(neyesamp) * neyesamp_dec
            eye[i * M + m] = np.abs(f_int[m, idx])
    if normalise and eye.max() > 0:
        eye = eye / eye.max()
    return eye


# ------------------------------------------------------------ stream demod


def demod_stream_reference(cfg: FSKConfig, iq: torch.Tensor, num_frames: int,
                           state: DemodState | None = None, n_valid=None,
                           with_eye: bool = False, with_probe: bool = False):
    """The plain frame loop: iq (n,) complex64 -> (final state, FrameOut
    with every field stacked over `num_frames` frames[, EyeProbe][,
    ProbeTrace]).

    Frame k reads the Nmem samples ending at pos + nin (history plus its
    nin fresh samples) and the estimator block starting at pos, both as
    device-side gathers from the zero-padded capture.  Frames that would
    read past `n_valid` (default: all of iq) are marked invalid and freeze
    the state; their other outputs are garbage and must be masked.
    with_eye: also return the last valid frame's integrator outputs and
    high sample (`EyeProbe`), as the JAX `demod_stream(with_eye=True)`.
    with_probe: also return each frame's internals (`ProbeTrace`), as the
    JAX `utils/probe.probe_demod` traces them.
    """
    device = iq.device
    n = iq.shape[0] if n_valid is None else n_valid
    if state is None:
        state = demod_init(cfg, device)
    consts = _constants(cfg, device)
    NB = cfg.Ndft * cfg.max_fft_blocks
    pad = cfg.Nmem
    zeros = torch.zeros
    buf = torch.cat([zeros(pad, dtype=torch.complex64, device=device),
                     iq.to(torch.complex64),
                     zeros(cfg.Nmem + NB, dtype=torch.complex64,
                           device=device)])

    st = state
    outs, trace = [], []
    eye = EyeProbe(
        torch.zeros((cfg.M, (cfg.Nsym + 1) * cfg.P), dtype=torch.complex64,
                    device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.bool, device=device))
    for _ in range(num_frames):
        valid = st.pos + st.nin <= n
        end = pad + st.pos.long() + st.nin.long()
        stream = buf[end - cfg.Nmem + consts["ar_nmem"]]
        new_blocks = buf[pad + st.pos.long() + consts["ar_nb"]]
        nst, out, probe = _demod_frame(cfg, st, stream, new_blocks, consts)
        st = DemodState(*(torch.where(valid, a, b) for a, b in zip(nst, st)))
        outs.append(out._replace(valid=valid))
        if with_eye:
            eye = EyeProbe(torch.where(valid, probe[0], eye.f_int),
                           torch.where(valid, probe[1], eye.high_sample),
                           eye.ok | valid)
        if with_probe:
            trace.append((probe[0], st.fft_est, probe[2], probe[1]))
    outs = FrameOut(*(torch.stack(f) for f in zip(*outs)))
    res = (st, outs) + ((eye,) if with_eye else ())
    if with_probe:
        res += (ProbeTrace(*(torch.stack(f) for f in zip(*trace))),)
    return res


def lane_state(state: DemodState, lanes: int) -> DemodState:
    """An unbatched state repeated over a leading lane axis."""
    return DemodState(*(t.expand(lanes, *t.shape).contiguous()
                        for t in state))


def demod_lanes_reference(cfg: FSKConfig, iq: torch.Tensor, num_frames: int,
                          state: DemodState | None = None, n_valid=None,
                          with_eye: bool = False, with_probe: bool = False):
    """The plain frame loop over L lanes: iq (L, n) complex64, state and
    n_valid (L,) with a leading lane axis (default: the initial state and
    n) -> (final state, FrameOut[, EyeProbe][, ProbeTrace]), every field
    with a leading lane axis.

    `torch.func.vmap` of `demod_stream_reference` (the JAX sweeps vmap the
    demod over trials and offsets the same way): each lane computes what
    an unbatched call computes.
    """
    L, n = iq.shape
    if state is None:
        state = lane_state(demod_init(cfg, iq.device), L)
    if n_valid is None:
        n_valid = torch.full((L,), n, dtype=torch.int64, device=iq.device)
    res = torch.func.vmap(
        lambda x, s, nv: demod_stream_reference(
            cfg, x, num_frames, s, nv, with_eye, with_probe))(
                iq, state, n_valid)
    kinds = (DemodState, FrameOut) + ((EyeProbe,) if with_eye else ()) + (
        (ProbeTrace,) if with_probe else ())
    return tuple(kind(*part) for kind, part in zip(kinds, res))


def to_iq(data: torch.Tensor, fmt: str) -> torch.Tensor:
    """(n, 2) raw pairs -> (n,) complex64: cu8 (x - 127) / 128, cs16
    x / FDMDV_SCALE, c64 float32 (re, im) as they are."""
    if fmt == "cu8":
        x = (data.float() - 127.0) * (1.0 / 128.0)
    elif fmt == "cs16":
        x = data.float() * np.float32(1.0 / FDMDV_SCALE)
    elif fmt == "c64":
        x = data
    else:
        raise ValueError(f"unknown sample format {fmt!r}")
    return torch.complex(x[:, 0].contiguous(), x[:, 1].contiguous())


def demod_raw(cfg: FSKConfig, data: torch.Tensor, fmt: str, num_frames: int,
              starts: torch.Tensor, n_valid: torch.Tensor,
              state: DemodState | None = None, with_eye: bool = False,
              with_probe: bool = False):
    """Demodulate L lanes of one raw buffer: the entry point of every demod.

    data: (n, 2) raw pairs (uint8 cu8, int16 cs16 or float32 c64);
    lane l's sample i is data[starts[l] + i], converted as `to_iq` does,
    and frames are valid while pos + nin <= n_valid[l]; samples before the
    lane's start or past the buffer read as 0.0.  state: lane-stacked, or
    None for the initial state.  Returns (final state, FrameOut) with a
    leading lane axis, with_eye an `EyeProbe` per lane as well, and
    with_probe a `ProbeTrace` per lane after it.

    On a CUDA tensor this launches the persistent frame-loop kernel
    (`kernels.fsk_demod`; with_probe its variant that writes the traces);
    on a CPU tensor it runs the plain loop.
    """
    if data.device.type == "cuda":
        from ..kernels import fsk_demod
        return fsk_demod.demod(cfg, data, fmt, num_frames, starts, n_valid,
                               state, with_eye, with_probe)
    return demod_raw_reference(cfg, data, fmt, num_frames, starts, n_valid,
                               state, with_eye, with_probe)


def demod_raw_reference(cfg: FSKConfig, data: torch.Tensor, fmt: str,
                        num_frames: int, starts: torch.Tensor,
                        n_valid: torch.Tensor,
                        state: DemodState | None = None,
                        with_eye: bool = False, with_probe: bool = False):
    """The plain version of `demod_raw`, on any device: the lanes gathered
    into (L, max n_valid) complex64 and run through the plain loop (the
    unbatched loop for one lane)."""
    iq = to_iq(data, fmt)
    n, dev = iq.shape[0], iq.device
    width = int(n_valid.max()) if n_valid.numel() else 0
    col = torch.arange(width, dtype=torch.int64, device=dev)
    idx = starts[:, None] + col
    inside = (idx >= 0) & (idx < n) & (col < n_valid[:, None])
    padded = torch.cat([iq, torch.zeros(1, dtype=torch.complex64,
                                        device=dev)])
    lanes = padded[torch.where(inside, idx, n)]       # index n reads 0.0
    if starts.shape[0] != 1:
        return demod_lanes_reference(cfg, lanes, num_frames, state, n_valid,
                                     with_eye, with_probe)
    res = demod_stream_reference(     # one lane: the unbatched loop
        cfg, lanes[0], num_frames,
        None if state is None else DemodState(*(t[0] for t in state)),
        n_valid[0], with_eye, with_probe)
    return _lift(res)


def _lift(res):
    """An unbatched (state, FrameOut[, EyeProbe][, ProbeTrace]) with a lane
    axis of 1."""
    return tuple(type(part)(*(t[None] for t in part)) for part in res)


def _drop(res):
    """(state, FrameOut[, EyeProbe][, ProbeTrace]) of one lane without its
    lane axis."""
    return tuple(type(part)(*(t[0] for t in part)) for part in res)


def _as_pairs(iq: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(iq.to(torch.complex64).contiguous()).reshape(
        -1, 2)


def demod_stream(cfg: FSKConfig, iq: torch.Tensor, num_frames: int,
                 state: DemodState | None = None, n_valid=None,
                 with_eye: bool = False, with_probe: bool = False):
    """Demodulate a capture: iq (n,) complex64 -> (final state, FrameOut
    stacked over frames[, EyeProbe][, ProbeTrace]), as
    `demod_stream_reference` computes it.  On a CUDA tensor the frame-loop
    kernel runs it as one lane."""
    if iq.device.type != "cuda":
        return demod_stream_reference(cfg, iq, num_frames, state, n_valid,
                                      with_eye, with_probe)
    n = iq.shape[0] if n_valid is None else int(n_valid)
    dev = iq.device
    return _drop(demod_raw(
        cfg, _as_pairs(iq), "c64", num_frames,
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.full((1,), n, dtype=torch.int64, device=dev),
        None if state is None else lane_state(state, 1), with_eye,
        with_probe))


def demod_lanes(cfg: FSKConfig, iq: torch.Tensor, num_frames: int):
    """Demodulate L captures of one length at once: iq (L, n) complex64 ->
    (final state, FrameOut), every field with a leading lane axis, as
    `demod_lanes_reference` computes it.  On a CUDA tensor the frame-loop
    kernel runs the lanes, one block each, straight out of one buffer."""
    if iq.device.type != "cuda":
        return demod_lanes_reference(cfg, iq, num_frames)
    L, n = iq.shape
    dev = iq.device
    return demod_raw(cfg, _as_pairs(iq), "c64", num_frames,
                     torch.arange(L, dtype=torch.int64, device=dev) * n,
                     torch.full((L,), n, dtype=torch.int64, device=dev))


def demod_iq_np(cfg: FSKConfig, iq: np.ndarray,
                state: DemodState | None = None, device="cuda"):
    """Host convenience: demodulate a whole capture on `device` (CUDA
    unless the caller asks for another; raises without a card) -> (the
    valid frames' soft bits concatenated, as `fsk_demod -s` writes them,
    FrameOut of numpy arrays, final DemodState)."""
    iq = np.asarray(iq, np.complex64)
    dev = resolve_device(device)
    final, outs = demod_stream(cfg, torch.from_numpy(iq).to(dev),
                               cfg.num_frames(len(iq)), state)
    outs = FrameOut(*(t.cpu().numpy() for t in outs))
    return outs.soft[outs.valid].reshape(-1), outs, final
