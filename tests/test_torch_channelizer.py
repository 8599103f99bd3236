"""PyTorch port of the wideband receive path (wenet_tpu_torch.ops.channelizer)
on the CPU against the JAX package on the same inputs, at the scaled
geometry of tests/test_channelizer.py (FSKConfig(Fs=96000, Rs=9600), 8
channels, packets on channels 2 and 5).

Tolerances: `channelize` within 1e-5 of the output's rms of JAX's (the
FIR and DFT sum in another order; measured ~7e-7 at N = 16); the demod fed
JAX's channels as tests/test_torch_fsk.py holds it (valid, nin, f_est and
hard bits exact on valid frames, soft within 1e-4 of the frame's mean
|soft|); `demod_multichannel`'s per-channel payload lists equal in all
three modes, and in the fused and vectorized modes on a channel of the
full-rate capture where the two modes differ (a false UW lock).  A numpy emulation of the channelizer kernel's tiling and
sum orders holds it to the plain version without a card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_tpu.core import framing
from wenet_tpu.ops import channel
from wenet_tpu.ops import channelizer as jch
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc
from wenet_tpu.utils import compat as jcompat
from wenet_tpu_torch.kernels import channelize as kch
from wenet_tpu_torch.ops import channel as channel_t
from wenet_tpu_torch.ops import channelizer as tch
from wenet_tpu_torch.ops import fsk as tfsk

torch.set_num_threads(1)

GEOM = dict(Fs=96000, Rs=9600)
NCH = 8
FS_TOTAL = GEOM["Fs"] * NCH
CHANNELS = [2, 5]
REL_TOL = 1e-5          # channelize: max |d| / rms of the output


def _rel_err(got, want):
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    return float(np.abs(got - want).max() / rms)


@pytest.mark.parametrize("N", [4, 8, 16])
def test_prototype_and_centres_match_jax(N):
    for taps in (4, 12):
        np.testing.assert_array_equal(tch.prototype_lowpass(N, taps),
                                      jch.prototype_lowpass(N, taps))
    np.testing.assert_array_equal(tch.prototype_lowpass(N, 12, 0.8),
                                  jch.prototype_lowpass(N, 12, 0.8))
    for fs in (FS_TOTAL, 7_680_000):
        np.testing.assert_array_equal(tch.channel_centres(fs, N),
                                      jch.channel_centres(fs, N))


@pytest.mark.parametrize("channels", [None, (-1,), (3, 0)],
                         ids=["all", "last", "sel"])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_channelize_matches_jax(N, channels):
    """Random samples of a length that is not a multiple of N: every
    channel, or a selection in the order given, within REL_TOL."""
    rng = np.random.default_rng(N)
    n = N * 700 + 5
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    want = np.asarray(jch.channelize(jnp.asarray(x), N))
    sel = None if channels is None else [k % N for k in channels]
    got = tch.channelize(x, N, channels=sel, device="cpu").numpy()
    if sel is not None:
        want = want[sel]
    assert got.shape == want.shape == (len(sel or range(N)), n // N)
    assert _rel_err(got, want) <= REL_TOL


def test_tone_lands_in_its_channel():
    """A tone 5 kHz into channel 3 keeps > 95 % of its power there, at
    5 kHz baseband (tests/test_channelizer.py on the port)."""
    n = FS_TOTAL // 4
    t = np.arange(n) / FS_TOTAL
    x = np.exp(2j * np.pi * (3 * FS_TOTAL / NCH + 5000.0) * t).astype(
        np.complex64)
    ch = tch.channelize(x, NCH, device="cpu").numpy()
    power = (np.abs(ch) ** 2).mean(axis=1)
    assert power.argmax() == 3 and power[3] / power.sum() > 0.95
    spec = np.abs(np.fft.fft(ch[3]))
    f_axis = np.fft.fftfreq(ch.shape[1], 1.0 / GEOM["Fs"])
    assert abs(f_axis[spec.argmax()] - 5000.0) < GEOM["Fs"] / ch.shape[1] * 2


def test_adjacent_channel_rejection():
    """A tone inside channel 2 leaks at least 45 dB below itself into every
    other channel (the commutator order; tests/test_channelizer.py)."""
    n = NCH * 4096
    t = np.arange(n) / FS_TOTAL
    centres = tch.channel_centres(FS_TOTAL, NCH)
    tone = np.exp(2j * np.pi * (centres[2] + 10000) * t).astype(np.complex64)
    chans = tch.channelize(tone, NCH, device="cpu").numpy()
    p = 10 * np.log10(np.mean(np.abs(chans) ** 2, axis=1) + 1e-15)
    assert p[2] > -1.5
    assert np.delete(p, 2).max() < p[2] - 45


def test_channelize_kernel_tiling_emulated():
    """A numpy emulation of csrc/channelize.cu (tiles of frames staged from
    x[(m0 - T) N ...], the FIR for s = T-1 .. 0 at x[(ml + T - s) N - p],
    then the real parts' and the imaginary parts' DFT terms in phase
    order) against the plain version, with a tile that does not divide
    the frames."""
    N, T, tile = 8, 12, 16
    rng = np.random.default_rng(3)
    n = N * 203 + 3
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    sel = (5, 0, 2)
    hp, tw = (t.numpy() for t in kch._tables(N, T, sel, torch.device("cpu")))
    F = n // N
    out = np.zeros((len(sel), F), np.complex64)
    for m0 in range(0, F, tile):
        base = (m0 - T) * N
        j = base + np.arange((tile + T) * N)
        xs = np.where((j >= 0) & (j < F * N), x[np.clip(j, 0, n - 1)], 0)
        xs = xs.astype(np.complex64)
        ml = np.arange(tile)[:, None]
        p = np.arange(N)[None, :]
        y = np.zeros((tile, N), np.complex64)
        for s in range(T - 1, -1, -1):
            y += (hp[s][None, :] * xs[(ml + T - s) * N - p]).astype(
                np.complex64)
        frames = min(tile, F - m0)
        for ci in range(len(sel)):
            c, sn = tw[ci, :, 0], tw[ci, :, 1]
            re = (y.real * c).sum(1, dtype=np.float32) \
                - (y.imag * sn).sum(1, dtype=np.float32)
            im = (y.real * sn).sum(1, dtype=np.float32) \
                + (y.imag * c).sum(1, dtype=np.float32)
            out[ci, m0:m0 + frames] = (re + 1j * im)[:frames]
    want = tch.channelize(x, N, channels=sel, device="cpu").numpy()
    assert _rel_err(out, want) <= REL_TOL
    assert kch.tile_frames(N, T) == kch.MAX_TILE
    assert kch.smem_bytes(256, T, kch.tile_frames(256, T)) <= kch.SMEM_LIMIT


# ---------------------------------------------------------- receive path


def _packet_capture(seed):
    rng = np.random.default_rng(seed)
    cfg = jfsk.FSKConfig(**GEOM)
    payload = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    frame = framing.frame_packet(payload, ldpc.encode_bytes, mode="v2")
    bits = np.concatenate([
        rng.integers(0, 2, cfg.Nbits * 3).astype(np.uint8),
        framing.frame_to_bits(frame, "v2"),
        rng.integers(0, 2, cfg.Nbits * 3).astype(np.uint8)])
    bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits,
                                          np.uint8)])
    sig, _ = jfsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    return payload, sig.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _wideband():
    """(capture, {channel: [payload]}): one packet on each of channels 2
    and 5 at 33 dB (tests/test_channelizer.py's two-channel capture)."""
    (p1, s1), (p2, s2) = _packet_capture(50), _packet_capture(51)
    n = max(len(s1), len(s2))
    s1, s2 = np.pad(s1, (0, n - len(s1))), np.pad(s2, (0, n - len(s2)))
    t = np.arange(n * NCH) / FS_TOTAL
    wide = np.zeros(n * NCH, np.complex64)
    for sig, k in ((s1, 2), (s2, 5)):
        dst_t = np.arange(n * NCH) / NCH
        i0 = np.minimum(dst_t.astype(np.int64), len(sig) - 2)
        fr = dst_t - i0
        nb = (1 - fr) * sig[i0] + fr * sig[i0 + 1]
        wide += (nb * np.exp(2j * np.pi * (k * FS_TOTAL / NCH) * t)).astype(
            np.complex64)
    wide = channel.add_awgn(wide, 33.0, FS_TOTAL, GEOM["Rs"],
                            rng=np.random.default_rng(7))
    return wide, {2: [p1], 5: [p2]}


def test_demod_of_jax_channels_is_exact():
    """The port's demod (lanes of demod_raw on the CPU) fed JAX's channels
    against JAX's demod_stream of each channel."""
    wide, _ = _wideband()
    cfg, tcfg = jfsk.FSKConfig(**GEOM), tfsk.FSKConfig(**GEOM)
    chans = np.asarray(jch.channelize(jnp.asarray(wide), NCH))[CHANNELS]
    L, F = chans.shape
    nf = cfg.num_frames(F)
    pairs = torch.from_numpy(np.ascontiguousarray(
        chans.reshape(-1)).view(np.float32).reshape(-1, 2))
    _, ot = tfsk.demod_raw(tcfg, pairs, "c64", nf,
                           torch.arange(L, dtype=torch.int64) * F,
                           torch.full((L,), F, dtype=torch.int64))
    for i in range(L):
        _, oj = jfsk.demod_stream(cfg, jcompat.put_complex(chans[i]), nf)
        oj = jax.tree.map(np.asarray, oj)
        v = oj.valid
        np.testing.assert_array_equal(ot.valid[i].numpy(), v)
        assert v.sum() > 40
        for f in ("nin", "bits", "f_est"):
            np.testing.assert_array_equal(getattr(ot, f)[i].numpy()[v],
                                          getattr(oj, f)[v], err_msg=f)
        scale = np.abs(oj.soft[v]).mean(axis=1, keepdims=True)
        assert np.all(np.abs(ot.soft[i].numpy()[v] - oj.soft[v])
                      <= 1e-4 * scale)


MODES = {"vectorized": {}, "fused": {"fused": True},
         "receiver": {"vectorized": False}}


@functools.lru_cache(maxsize=None)
def _jax_multichannel(mode):
    wide, _ = _wideband()
    return jch.demod_multichannel(wide, FS_TOTAL, NCH,
                                  jfsk.FSKConfig(**GEOM), channels=CHANNELS,
                                  **MODES[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_demod_multichannel_matches_jax(mode):
    """Each mode's per-channel payload lists equal JAX's, and the sent
    packets."""
    wide, sent = _wideband()
    got = tch.demod_multichannel(wide, FS_TOTAL, NCH, tfsk.FSKConfig(**GEOM),
                                 channels=CHANNELS, device="cpu",
                                 **MODES[mode])
    assert got == _jax_multichannel(mode) == sent


def test_demod_multichannel_every_channel_and_checks():
    """Without a selection every channel is decoded (the empty ones give
    empty lists), a complex tensor is taken as it is, and a channel rate
    that is not the config's raises."""
    wide, sent = _wideband()
    cfg = tfsk.FSKConfig(**GEOM)
    got = tch.demod_multichannel(torch.from_numpy(wide), FS_TOTAL, NCH, cfg,
                                 fused=True, device="cpu")
    assert got == {k: sent.get(k, []) for k in range(NCH)}
    with pytest.raises(ValueError):
        tch.demod_multichannel(wide, FS_TOTAL, 4, cfg, device="cpu")


# chip_smoke.py's wideband capture: V2_CONFIG, 8 channels of 12 packets at
# 30 dB per channel, seed 1234 + 800; channel 6 alone is demodulated
FALSE_LOCK = dict(n_channels=8, packets=12, ebno_db=30.0, seed=2034)
FALSE_LOCK_CHANNEL = 6


@functools.lru_cache(maxsize=None)
def _false_lock_capture():
    return channel_t.wideband_capture(tfsk.V2_CONFIG, **FALSE_LOCK)


@pytest.mark.parametrize("mode", ["fused", "vectorized"])
def test_false_uw_lock_matches_jax(mode):
    """On channel 6 of the smoke's 7.68 MHz capture the reference's UW FSM
    locks on a false UW hit in the idle bits after packet 8 (320 symbols
    before packet 9's UW, within the 4 allowed bit errors); its window
    swallows packet 9's UW, which fails its CRC, so the vectorized mode
    gives 11 packets, where the fused mode's top-k acquisition gives all
    12.  Each of the port's modes equals the JAX package's same mode."""
    wide, sent = _false_lock_capture()
    fs = FALSE_LOCK["n_channels"] * tfsk.V2_CONFIG.Fs
    kw = MODES[mode]
    got = tch.demod_multichannel(wide, fs, FALSE_LOCK["n_channels"],
                                 tfsk.V2_CONFIG, channels=[FALSE_LOCK_CHANNEL],
                                 device="cpu", **kw)
    want = jch.demod_multichannel(wide, fs, FALSE_LOCK["n_channels"],
                                  jfsk.V2_CONFIG,
                                  channels=[FALSE_LOCK_CHANNEL], **kw)
    assert got == want
    order = [sent[FALSE_LOCK_CHANNEL].index(p)
             for p in got[FALSE_LOCK_CHANNEL]]
    assert order == [i for i in range(12) if mode == "fused" or i != 9]
