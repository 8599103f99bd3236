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


def _fma(a, b, c):
    """float32 a*b + c rounded once (the kernel's fmaf; the float64 sum
    of the exact product rounds twice only in ties too rare to matter at
    REL_TOL)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _emulate_kernel(buf, o, fmt, N, T, F, sel, sms):
    """csrc/channelize.cu in numpy, block after block: buf is a 16-byte
    aligned buffer whose bytes from offset o on are the capture (float32
    pairs or cu8 bytes), with garbage around it as the card's memory has.
    Each block walks its run of tiles of kch.plan and kch.geometry: the
    first tile's T frames of history and the plan's tiles in flight
    (IN_FLIGHT, or fewer at large N) copied ahead as
    whole 16-byte chunks into a ring of kch.ring_samples that maps global
    byte b to b mod R (each copy lands at once, the worst case for a copy
    that overwrites live data), the zeros before the stream written after
    the block's first tile arrives, the FIR of each output with taps s =
    T-1 .. 0 (cu8: b - 127 times the taps / 128; the register window and
    the single-output loop round alike), and the DFT of each channel over
    the phases in order (re += yr c - yi s, im += yr s + yi c); at run
    time, where a tile has few DFT items, in kch.dft_split(items) strided
    partial sums joined by a butterfly, as the kernel's lanes do.  Frames
    past F are never written (NaN left)."""
    SB = kch.FORMATS[fmt][1]
    tile, tw_smem, D = kch.plan(N, T, len(sel), fmt)
    items = (tile + 1) // 2 * -(-len(sel) // kch.SG)
    S = (1 if kch.templated(N, T, tile, tw_smem, D)
         else kch.dft_split(items))
    hp, tw = (t.numpy() for t in kch._tables(N, T, tuple(sel),
                                             torch.device("cpu")))
    if fmt == "cu8":
        hp = hp * np.float32(0.0078125)
    blocks, per = kch.geometry(F, tile, sms)
    TN, RS = tile * N, kch.ring_samples(N, T, tile, fmt, D)
    R = RS * SB
    total, ntiles, os_ = F * N, -(-F // tile), o // SB
    nsel = len(sel)
    out = np.full((nsel, F, 2), np.nan, np.float32)
    k = np.arange(tile)[:, None]
    p = np.arange(N)[None, :]
    for blk in range(blocks):
        ring = np.full(R, 0xA5, np.uint8)
        q0, q1 = blk * per, min((blk + 1) * per, ntiles)

        def fetch(js, je):
            je = min(je, total)
            if js >= je:
                return
            rc0, c0 = (((os_ + js) % RS) * SB) >> 4, (o + js * SB) >> 4
            for c in range(c0, (o + je * SB + 15) >> 4):
                rc = (rc0 + c - c0) % (R // 16)
                ring[16 * rc: 16 * rc + 16] = buf[16 * c: 16 * c + 16]

        h0 = q0 * TN - T * N
        if q0 > 0:
            fetch(max(h0, 0), q0 * TN)
        for d in range(D):
            if q0 + d < q1:
                fetch((q0 + d) * TN, (q0 + d + 1) * TN)
        for q in range(q0, q1):
            if q + D < q1:
                fetch((q + D) * TN, (q + D + 1) * TN)
            if q == q0 and h0 < 0:
                b = (os_ + h0) * SB + np.arange(-h0 * SB)
                ring[b % R] = 127 if fmt == "cu8" else 0
            rq = (os_ + q * TN) % RS
            y = np.zeros((tile, N, 2), np.float32)
            for s in range(T - 1, -1, -1):
                r = (rq + (k - s) * N - p) % RS
                if fmt == "cu8":        # b - 127, the 1/128 in the taps
                    x = np.stack([ring[2 * r], ring[2 * r + 1]], -1).astype(
                        np.float32) - np.float32(127)
                else:
                    x = ring.view(np.float32).reshape(-1, 2)[r]
                y = _fma(hp[s][None, :, None], x, y)
            m0 = q * tile
            frames = min(tile, F - m0)
            acc = np.zeros((S, nsel, tile, 2), np.float32)
            for pp in range(N):
                c, sn = tw[:nsel, pp, 0][:, None], tw[:nsel, pp, 1][:, None]
                yr, yi = y[None, :, pp, 0], y[None, :, pp, 1]
                a = acc[pp % S]
                a[..., 0] = _fma(-yi, sn, _fma(yr, c, a[..., 0]))
                a[..., 1] = _fma(yi, c, _fma(yr, sn, a[..., 1]))
            off = S // 2
            while off:
                acc = acc + acc[np.arange(S) ^ off]
                off //= 2
            out[:, m0:m0 + frames] = acc[0, :, :frames]
    return out[..., 0] + 1j * out[..., 1]


def _aligned_buffer(data: bytes, o: int) -> np.ndarray:
    """data at byte offset o of a 16-byte-aligned buffer of garbage bytes
    (0x5A), with at least 16 more after it."""
    n = -(-(o + len(data) + 16) // 16) * 16
    buf = np.full(n, 0x5A, np.uint8)
    buf[o:o + len(data)] = np.frombuffer(data, np.uint8)
    return buf


def _direct_channels(x, N, T, sel):
    """The selected channels of the polyphase filterbank computed directly
    in float64 (the FIR of each phase, then each selected bin's DFT term
    alone): a reference for N too large for the plain version's N x N
    DFT matrix."""
    h = tch.prototype_lowpass(N, T).astype(np.float64).reshape(T, N)
    F = len(x) // N
    xm = x[:F * N].astype(np.complex128).reshape(F, N)
    xf = np.zeros((F, N), np.complex128)       # xf[m, p] = x[m N - p]
    xf[:, 0] = xm[:, 0]
    xf[1:, 1:] = xm[:-1, :0:-1]
    y = np.zeros((F, N), np.complex128)
    for s in range(T):
        y[s:] += h[s] * xf[:F - s]
    p = np.arange(N)
    return np.stack([y @ np.exp(2j * np.pi * k * p / N) for k in sel])


@pytest.mark.parametrize("N,T,in_flight", [
    (8, 12, 2), (6, 12, 2), (256, 12, 2), (8, 16, 2), (1300, 12, 2),
    (2600, 4, 1), (3228, 4, 0), (6456, 1, 0)])
def test_channelize_kernel_tiling_emulated(N, T, in_flight):
    """The numpy emulation of csrc/channelize.cu against the plain version
    within REL_TOL, on float pairs 8 bytes past an aligned address: a
    templated N (8), N read at run time (6; 256, more phases than FIR
    threads), taps read at run time (16) and an N whose tile shrinks to 2
    frames (1300); at 4 taps a phase, N whose block fits only with one
    tile in flight (2600) or none (3228: the first version's largest N at
    T = 4), and at 1 tap N = 6456 (its largest at T = 1), which takes
    1-frame tiles (these three against a direct float64 filterbank: the
    plain version's N x N DFT matrix is too large); two persistent blocks
    of several tiles (the second starts mid-stream and reads its own
    history, which for short tiles reaches before the stream; the ring
    wraps), zeros before the stream, a ragged last tile, a length that is
    not a multiple of N, and a selection with a repeated channel and an
    odd count."""
    tile, _, fl = kch.plan(N, T, 6, "c64")
    assert fl == in_flight
    assert (tile % 2 == 0) != (tile == 1) and (tile == 1) == (T == 1)
    assert kch.templated(N, T, tile) == (N == 8 and T == 12)
    F = 5 * tile + max(tile // 2 - 1, 1)     # six tiles, the last ragged
    rng = np.random.default_rng(N + T)
    n = N * F + 3
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    sel = (5, 0, 2, 5, 4, 1)
    blocks, per = kch.geometry(F, tile, 1)
    assert blocks == 2 and per == 3
    got = _emulate_kernel(_aligned_buffer(x.tobytes(), 8), 8, "c64", N, T,
                          F, sel, 1)
    if N > 2000:
        want = _direct_channels(x, N, T, sel)
    else:
        want = tch.channelize(x, N, T, channels=sel, device="cpu").numpy()
    assert not np.isnan(got).any()
    assert _rel_err(got, want) <= REL_TOL


def test_channelize_kernel_plan():
    """The launch plan: N = 4, 8, 16 with T = 12 take the templated
    kernel; 256 keeps a tile of whole FIR groups (the register window);
    larger N shrink the tile; every N up to 1024 fits a block on either
    format, with the twiddles of all its channels in shared memory up to
    N = 64, and every N up to 1383 (the first version's largest at T =
    12) on float pairs; a block that fits no 2-frame tile raises; the
    persistent grid takes as many blocks a SM as fit its shared
    memory."""
    for N in (4, 8, 16):
        assert kch.templated(N, 12, kch.plan(N, 12, N)[0])
        assert not kch.templated(N, 16, kch.plan(N, 16, N)[0])
    assert kch.plan(8, 12, 8) == (252, True, 2)
    assert kch.plan(6, 12, 6) == (324, True, 2)
    assert kch.plan(256, 12, 256, "c64") == (18, False, 2)
    assert kch.plan(1300, 12, 3, "c64")[0::2] == (2, 2)
    assert kch.plan(1383, 12, 1, "c64")[0] == 2
    for N in range(1, 1025):
        for fmt in ("c64", "cu8"):
            tile, tw_smem, fl = kch.plan(N, 12, N, fmt)
            assert fl == kch.IN_FLIGHT
            assert kch.smem_bytes(N, 12, tile, N, fmt, tw_smem) \
                <= kch.SMEM_LIMIT
            assert kch.ring_samples(N, 12, tile, fmt) \
                * kch.FORMATS[fmt][1] % 16 == 0
            assert tw_smem or N > 64
    with pytest.raises(ValueError):
        kch.plan(4096, 12, 1, "c64")
    # two blocks a SM where two fit its shared memory, else one
    assert kch.geometry(18 * 300, 18, 132, 60_000) == (150, 2)
    assert kch.geometry(18 * 300, 18, 132, 150_000) == (100, 3)


def _first_version_limit(T: int) -> int:
    """The largest N the first version of the channelizer kernel took at T
    taps a phase: its block (a tile of frames with its T frames of
    history as float pairs, the FIR outputs of one frame more, the taps)
    had to fit at a 1-frame tile."""
    def smem(N):
        def a16(b):
            return (b + 15) // 16 * 16
        return a16((1 + T) * N * 8) + a16(N * 2 * 8) + a16(T * N * 4)
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem(mid) <= kch.SMEM_LIMIT else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("fmt", ["c64", "cu8"])
def test_channelize_kernel_plan_reaches_the_first_version(fmt):
    """At every T in 1..16 the plan takes every N up to the first
    version's largest (3228 at T = 4), within the block's shared memory
    and the launch's rules: as few tiles in flight as the block needs
    (IN_FLIGHT wherever it fits), tiles even or of 1 frame, a ring of at
    least one 16-byte chunk a thread; the templated geometries keep
    IN_FLIGHT."""
    assert _first_version_limit(4) == 3228
    for T in range(1, 17):
        limit = _first_version_limit(T)
        for N in sorted({1, 2, 3, 7, 64, 255, 1000, limit // 2, limit - 1,
                         limit}):
            tile, tw_smem, fl = kch.plan(N, T, 3, fmt)
            assert kch.smem_bytes(N, T, tile, 3, fmt, tw_smem, fl) \
                <= kch.SMEM_LIMIT
            assert 0 <= fl <= kch.IN_FLIGHT and (tile == 1 or tile % 2 == 0)
            assert kch.ring_samples(N, T, tile, fmt, fl) \
                * kch.FORMATS[fmt][1] >= 16 * 256
            if fl < kch.IN_FLIGHT:       # only where the block needs it
                assert kch.smem_bytes(N, T, 2, 3, fmt, False, fl + 1) \
                    > kch.SMEM_LIMIT
    for N in kch.TEMPLATED_N:
        assert kch.plan(N, kch.TAPS, N, fmt)[2] == kch.IN_FLIGHT


def test_channelize_kernel_ring_emulated_cu8():
    """The emulation on raw cu8 bytes 6 bytes past an aligned address
    (chunks that straddle tiles and the stream's edges; the ring wrapped
    by each block) equals the float-pair route on
    iq_from_cu8 of the same bytes bit for bit, and the plain version
    within REL_TOL."""
    N = 8
    F = 10 * kch.plan(N, 12, 5, "cu8")[0] + 37
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 2 * (N * F + 3), dtype=np.uint8)
    sel = (1, 7, 4, 0, 3)
    got = _emulate_kernel(_aligned_buffer(raw.tobytes(), 6), 6, "cu8", N,
                          12, F, sel, 1)
    iq = tfsk.iq_from_cu8(raw)
    pairs = _emulate_kernel(_aligned_buffer(iq.tobytes(), 8), 8, "c64", N,
                            12, F, sel, 1)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, pairs)
    want = tch.channelize(iq, N, channels=sel, device="cpu").numpy()
    assert _rel_err(got, want) <= REL_TOL


def test_channelize_cu8_route_on_the_cpu():
    """channelize_pairs on raw cu8 bytes equals the c64 route on
    iq_from_cu8 of the same bytes bit for bit (a length in samples that is
    not a multiple of N, all channels and a selection with a negative
    index); other formats raise."""
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, 2 * (NCH * 300 + 5), dtype=np.uint8)
    pairs = torch.from_numpy(tfsk.iq_from_cu8(raw).view(np.float32)
                             .reshape(-1, 2))
    for sel in (None, (3, -1)):
        got = tch.channelize_pairs(torch.from_numpy(raw), NCH, channels=sel,
                                   input_format="cu8")
        assert torch.equal(got, tch.channelize_pairs(pairs, NCH,
                                                     channels=sel))
    with pytest.raises(ValueError):
        tch.channelize_pairs(pairs, NCH, input_format="cs16")


def test_negative_channels_and_range():
    """Indices in [-N, 0) count from the end (channelize_pairs with
    (-1, 3) equals the plain version on (N-1, 3)); N and -N-1 raise
    IndexError, as the JAX package's indexing does."""
    rng = np.random.default_rng(22)
    n = NCH * 200 + 1
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    pairs = torch.from_numpy(x.view(np.float32).reshape(-1, 2))
    want = torch.view_as_real(tch.channelize_reference(
        torch.from_numpy(x), NCH, channels=(NCH - 1, 3))).reshape(-1, 2)
    assert torch.equal(tch.channelize_pairs(pairs, NCH, channels=(-1, 3)),
                       want)
    for bad in (NCH, -NCH - 1):
        with pytest.raises(IndexError):
            tch.channelize_pairs(pairs, NCH, channels=(0, bad))
        with pytest.raises(IndexError):
            tch.demod_multichannel(x, FS_TOTAL, NCH, tfsk.FSKConfig(**GEOM),
                                   channels=[bad], device="cpu")


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


@functools.lru_cache(maxsize=None)
def _wideband_cu8():
    """_wideband()'s capture as cu8 bytes, scaled by 1/4 (the two channels'
    sum peaks near 2)."""
    wide, sent = _wideband()
    return tfsk.iq_to_cu8(wide / 4), sent


@pytest.mark.parametrize("mode", list(MODES))
def test_demod_multichannel_cu8_matches_jax(mode):
    """Raw cu8 bytes (input_format="cu8") give JAX's lists on
    iq_from_cu8 of the same bytes in each mode, and the sent packets."""
    raw, sent = _wideband_cu8()
    got = tch.demod_multichannel(raw, FS_TOTAL, NCH, tfsk.FSKConfig(**GEOM),
                                 channels=CHANNELS, device="cpu",
                                 input_format="cu8", **MODES[mode])
    want = jch.demod_multichannel(jfsk.iq_from_cu8(raw), FS_TOTAL, NCH,
                                  jfsk.FSKConfig(**GEOM), channels=CHANNELS,
                                  **MODES[mode])
    assert got == want == sent


@pytest.mark.parametrize("mode", list(MODES))
def test_demod_multichannel_negative_channels_match_jax(mode):
    """channels=[-1, 2]: channel N-1 under the key -1, then channel 2, in
    each mode as the JAX package gives them, keys included."""
    wide, sent = _wideband()
    got = tch.demod_multichannel(wide, FS_TOTAL, NCH, tfsk.FSKConfig(**GEOM),
                                 channels=[-1, 2], device="cpu",
                                 **MODES[mode])
    want = jch.demod_multichannel(wide, FS_TOTAL, NCH, jfsk.FSKConfig(**GEOM),
                                  channels=[-1, 2], **MODES[mode])
    assert got == want == {-1: [], 2: sent[2]}
    assert list(got) == [-1, 2]


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
