"""Polyphase DFT filterbank channelizer and the wideband receive path
(counterpart of wenet_tpu/ops/channelizer.py): one wideband IQ stream ->
N critically-sampled channels, each demodulated and deframed.

Channel k is centred at k*Fs/N (negative ks wrap).  An N-phase
decomposition of a windowed-sinc prototype lowpass filters each phase's
decimated sub-stream (12 taps a phase), and an N-point DFT across the
phases gives the channels.  On a CUDA tensor `channelize_pairs` launches
the channelizer kernel (`kernels.channelize`), which reads float32 pairs
or the capture's raw cu8 bytes and writes the selected channels straight
into the buffer that the demod kernel reads as lanes; on a CPU tensor
`channelize_reference` computes it as the JAX package does (shifted
slices, an einsum, `utils.compat.dft`).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..utils import compat
from . import fsk


def prototype_lowpass(n_channels: int, taps_per_phase: int = 12,
                      cutoff_scale: float = 1.0) -> np.ndarray:
    """Windowed-sinc prototype for the filterbank: length N*taps_per_phase,
    cutoff at the channel half-width."""
    ntaps = n_channels * taps_per_phase
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    fc = cutoff_scale * 0.5 / n_channels          # normalized (fs=1)
    h = 2 * fc * np.sinc(2 * fc * t)
    h *= np.hamming(ntaps)
    return (h / np.sum(h)).astype(np.float32)


def channel_centres(Fs: int, n_channels: int) -> np.ndarray:
    """Centre frequency of each channel (Hz), wrapping negatives."""
    k = np.arange(n_channels)
    f = k * Fs / n_channels
    return np.where(f >= Fs / 2, f - Fs, f)


def channelize_reference(iq: torch.Tensor, n_channels: int,
                         taps_per_phase: int = 12,
                         channels=None) -> torch.Tensor:
    """The plain version, on any device: iq (n,) complex64 ->
    (Nsel, n//N) complex64, the selected channels (default: all) in the
    order given.

    Phase p of frame m reads x[mN - p] (the column-reversed commutator
    with a one-frame delay for p >= 1; the other order leaks a tone into
    every channel at -12 dB), filters it along frames with hp[s, p] =
    h[s*N + p], and channel k is the DFT of the phases at bin (-k) mod N.
    """
    N, T = n_channels, taps_per_phase
    dev = iq.device
    hp = torch.as_tensor(prototype_lowpass(N, T), device=dev).reshape(T, N)
    n = (iq.shape[0] // N) * N
    x = iq[:n].to(torch.complex64).reshape(-1, N)  # x[m, p] = iq[m*N + p]
    frames = x.shape[0]
    xdel = torch.cat([torch.zeros((1, N - 1), dtype=x.dtype, device=dev),
                      x[:, 1:].flip(1)[:-1]])       # one-frame delay
    xf = torch.cat([x[:, :1], xdel], dim=1)        # xf[m, p] = x[mN - p]
    xp = torch.cat([torch.zeros((T - 1, N), dtype=x.dtype, device=dev), xf])
    windows = torch.stack([xp[s: s + frames] for s in range(T)])
    hr = hp.flip(0)
    # y[m, p] = sum_s hp[s, p] xf[m - s, p], as the reference's einsum
    y = torch.complex(torch.einsum("tmp,tp->mp", windows.real, hr),
                      torch.einsum("tmp,tp->mp", windows.imag, hr))
    chans = compat.dft(y)                          # (frames, N) bins
    chans = torch.cat([chans[:, :1], chans[:, 1:].flip(1)], dim=1)
    chans = chans.T                                # channel k = bin (-k)
    if channels is not None:
        chans = chans[torch.as_tensor(list(channels), dtype=torch.int64,
                                      device=dev)]
    return chans.contiguous()


def _selection(channels, N: int) -> tuple:
    """The channel indices to compute, in the order given (default: all),
    each in [-N, N) and mapped into [0, N) as the JAX package's indexing
    does; anything else raises IndexError, as there."""
    if channels is None:
        return tuple(range(N))
    sel = tuple(int(k) for k in channels)
    bad = [k for k in sel if not -N <= k < N]
    if bad:
        raise IndexError(f"channels {bad} out of range for {N} channels")
    return tuple(k % N for k in sel)


def channelize_pairs(x: torch.Tensor, n_channels: int,
                     taps_per_phase: int = 12, channels=None,
                     input_format: str = "c64") -> torch.Tensor:
    """x: (n, 2) float32 (re, im) pairs ("c64") or the raw interleaved cu8
    bytes of n samples as a uint8 tensor ("cu8") -> (Nsel F, 2) float32:
    the selected channels (default: all; indices in [-N, N), negative ones
    counted from the end) one after the other, F = n // N frames each —
    the layout the demod reads as c64 lanes (lane i starts at i*F).  A
    CUDA tensor launches the channelizer kernel (cu8 bytes converted in
    it); a CPU tensor runs the plain version (cu8 converted first)."""
    if input_format not in ("c64", "cu8"):
        raise ValueError(f"input_format must be 'c64' or 'cu8', got "
                         f"{input_format!r}")
    sel = _selection(channels, n_channels)
    if x.device.type == "cuda":
        from ..kernels import channelize as kernel
        return kernel.channelize(x.contiguous(), n_channels, taps_per_phase,
                                 sel, input_format)
    if input_format == "cu8":
        iq = torch.from_numpy(fsk.iq_from_cu8(x.numpy()))
    else:
        iq = torch.complex(x[:, 0].contiguous(), x[:, 1].contiguous())
    ch = channelize_reference(iq, n_channels, taps_per_phase, sel)
    return torch.view_as_real(ch).reshape(-1, 2)


def _device_input(iq, device, input_format: str = "c64") -> torch.Tensor:
    """A capture on `device` as channelize_pairs takes it: complex64
    (numpy or tensor) as (n, 2) float32 pairs, or cu8 bytes (numpy or
    tensor) as they are, one copy of 2 bytes a sample; a tensor stays on
    its own device."""
    if input_format == "cu8":
        if isinstance(iq, torch.Tensor):
            return iq.reshape(-1)
        raw = np.ascontiguousarray(np.asarray(iq, np.uint8).reshape(-1))
        with warnings.catch_warnings():   # read-only file bytes: never
            warnings.simplefilter("ignore", UserWarning)  # written here
            return torch.from_numpy(raw).to(resolve_device(device))
    if isinstance(iq, torch.Tensor):
        return torch.view_as_real(iq.to(torch.complex64).contiguous())
    iq = np.require(np.asarray(iq, np.complex64), requirements=["C", "W"])
    return torch.from_numpy(iq.view(np.float32).reshape(-1, 2)).to(
        resolve_device(device))


def channelize(iq, n_channels: int, taps_per_phase: int = 12,
               channels=None, device="cuda") -> torch.Tensor:
    """iq (n,) complex64 (a tensor, or numpy moved to `device`, CUDA unless
    the caller asks for another; raises without a card) ->
    (Nsel, n//N) complex64: channel k is the signal around centre frequency
    k*Fs/N, downconverted to baseband and decimated by N (critically
    sampled).  channels: the channel indices to compute (default all)."""
    N = n_channels
    pairs = _device_input(iq, device)
    out = channelize_pairs(pairs, N, taps_per_phase, channels)
    nsel = len(_selection(channels, N))
    return torch.view_as_complex(out.reshape(nsel, pairs.shape[0] // N, 2))


def demod_multichannel(iq, Fs_total: int, n_channels: int, cfg,
                       mode: str = "v2", channels=None,
                       vectorized: bool = True, max_iter: int = 10,
                       fused: bool = False, device="cuda",
                       input_format: str = "c64"):
    """Wideband capture -> per-channel packet decode; returns
    {channel_index: list_of_payloads}, as
    `wenet_tpu/ops/channelizer.py::demod_multichannel`.

    iq at Fs_total (complex64 numpy or tensor, or with input_format="cu8"
    the capture's raw interleaved uint8 bytes, which go to the device as
    they are and are converted in the channelizer kernel; on the CPU they
    are converted first, as `ops.fsk.iq_from_cu8`); each channel lands at
    Fs_total/n_channels, which must equal cfg.Fs.  channels: indices in
    [-N, N) (negative ones counted from the end); the result is keyed by
    the indices as given.  device: CUDA unless the caller asks for
    another; raises without a card.

    vectorized=True (the default): the channelizer, then the selected
    channels demodulated as lanes of one demod call straight out of its
    output buffer, then the soft bits copied to the host and each
    channel's valid frames deframed there (`deframe.deframe_soft`: the UW
    FSM, then one decode batch on `device`).  fused=True keeps the deframe
    on the device too: the channelizer, the demod, `deframe_topk` over all
    lanes (invalid frames blanked to +1.0), and one copy of the packed
    results.
    vectorized=False and fused=False: one streaming `Receiver` per
    selected channel on the channelizer's output.
    """
    from ..core import framing
    from ..rx.pipeline import Receiver
    from . import deframe

    if Fs_total // n_channels != cfg.Fs:
        raise ValueError("channel rate != demod config rate")
    sel = list(range(n_channels)) if channels is None else [
        int(k) for k in channels]
    x = _device_input(iq, device, input_format)
    dev = x.device
    F = x.numel() // 2 // n_channels   # pairs or cu8: 2 values a sample
    L = len(sel)
    chans = channelize_pairs(x, n_channels, channels=sel,
                             input_format=input_format)
    if not vectorized and not fused:
        ch = torch.view_as_complex(chans.reshape(L, F, 2)).cpu().numpy()
        return {k: Receiver(mode=mode, cfg=cfg, device=dev).decode_iq(ch[i])
                for i, k in enumerate(sel)}

    nf = cfg.num_frames(F)
    _, outs = fsk.demod_raw(
        cfg, chans, "c64", nf,
        torch.arange(L, dtype=torch.int64, device=dev) * F,
        torch.full((L,), F, dtype=torch.int64, device=dev))
    if fused:
        syms_pp = (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
                   else framing.V1_SYMBOLS_PER_PACKET)
        kk = int(np.ceil(nf * cfg.Nbits / syms_pp)) + 2
        soft = torch.where(outs.valid[..., None], outs.soft, 1.0)
        packed = deframe.deframe_topk(soft.reshape(L, -1), mode, kk,
                                      max_iter, packed=True)
        pb, ok, pos = deframe.unpack_decode_results(packed.cpu().numpy())
        out = {}
        for i, k in enumerate(sel):
            hits = sorted((int(pos[i, j]), pb[i, j, :256].tobytes())
                          for j in range(kk) if ok[i, j] and pos[i, j] >= 0)
            out[k] = [payload for _, payload in hits]
        return out

    soft = outs.soft.reshape(L, nf, -1).cpu().numpy()
    valid = outs.valid.cpu().numpy()
    out = {}
    for i, k in enumerate(sel):
        res = deframe.deframe_soft(soft[i][valid[i]].reshape(-1), mode,
                                   max_iter, device=dev)
        out[k] = [res.packets_raw[j, :256].tobytes()
                  for j, ok in enumerate(res.crc_ok) if ok]
    return out
