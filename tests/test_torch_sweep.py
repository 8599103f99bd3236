"""The port's Monte-Carlo sweeps, acquisition search, channel models, lane
demod and CLI --acquire (wenet_tpu_torch.parallel.sweep and friends)
against the JAX package on the same inputs, at the scaled geometry
FSKConfig(Fs=96000, Rs=9600).

Random draws differ between the frameworks, so the comparisons feed both
the same numpy bits, noise and soft streams; the sweeps themselves are
checked for their cliffs.  Counts, UW correlation scores and CRC decisions
are compared exactly.  The JAX sweeps feed unmasked soft bits of frames
past the capture end into the UW correlation, the port masks them: the
equality checks use probes in which every frame is valid.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wenet_tpu.ops import channel as jchannel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.parallel import sweep as jsweep
from wenet_tpu_torch.ops import channel, fsk
from wenet_tpu_torch.parallel import sweep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}
JCFG = jfsk.FSKConfig(**GEOM["v2"])
TCFG = fsk.FSKConfig(**GEOM["v2"])


@functools.lru_cache(maxsize=None)
def _shifted_capture():
    """One v2 packet tuned +30 kHz off (tones at 49.2/58.8 kHz, outside the
    estimator band [2.4k, 45.6k]), light noise: the capture of
    tests/test_sweep.py's acquisition test."""
    sig, _ = jsweep.make_single_packet_stream(JCFG, bytes(range(256)), "v2")
    n = np.arange(len(sig))
    iq = (sig * np.exp(2j * np.pi * 30000.0 * n / JCFG.Fs)).astype(
        np.complex64)
    rng = np.random.default_rng(0)
    return iq + (rng.normal(0, 0.05, (len(iq), 2)) @ [1, 1j]).astype(
        np.complex64)


def _valid_frames(cfg, iq):
    _, outs = fsk.demod_stream(cfg, torch.from_numpy(iq),
                               cfg.num_frames(len(iq)))
    return int(outs.valid.sum())


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_make_single_packet_stream_matches_jax(mode):
    kw = GEOM[mode]
    sj, vj = jsweep.make_single_packet_stream(jfsk.FSKConfig(**kw),
                                              bytes(range(7, 256)) + bytes(7), mode)
    st, vt = sweep.make_single_packet_stream(fsk.FSKConfig(**kw),
                                             bytes(range(7, 256)) + bytes(7), mode)
    np.testing.assert_array_equal(st, sj)
    assert vt == vj


def _jax_trial_counts(ibits, noise, ebno_db, algo):
    """The JAX sweep's per-batch pieces on the given bits and noise."""
    cw = jnp.concatenate([jnp.asarray(ibits),
                          jldpc.encode_bits(jnp.asarray(ibits))], axis=1)
    sym = 1.0 - 2.0 * cw.astype(jnp.float32)
    esn0 = 10.0 ** (jnp.float32(ebno_db) / 10.0) * (2064.0 / 2580.0)
    sd = sym + jnp.sqrt(1.0 / (2.0 * esn0)) * jnp.asarray(noise)
    dec = jldpc.decode_minsum if algo == "min-sum" else jldpc.decode
    bits, iters, _ = dec(jldpc.sd_to_llr(sd), max_iter=10)
    err = np.asarray(bits)[:, :2064] != ibits
    return [int(err.sum()), int(err.any(axis=1).sum()),
            int(np.asarray(iters).sum())]


@pytest.mark.parametrize("algo", sweep.ALGOS)
def test_ldpc_trial_counts_match_jax_pieces(algo):
    rng = np.random.default_rng(17)
    ibits = rng.integers(0, 2, (12, 2064)).astype(np.uint8)
    noise = rng.standard_normal((12, 2580)).astype(np.float32)
    for ebno in (2.5, 3.5, 6.0):
        got = sweep.ldpc_trial_counts(torch.from_numpy(ibits),
                                      torch.from_numpy(noise), ebno, algo)
        assert [int(x) for x in got] == _jax_trial_counts(ibits, noise,
                                                          ebno, algo)


@pytest.mark.parametrize("algo", sweep.ALGOS)
def test_ldpc_ber_sweep_cliff(algo):
    r = sweep.ldpc_ber_sweep([3.0, 8.0], n_cw_per_point=16, device="cpu",
                             algo=algo)
    assert r["n_codewords"] == 16
    assert r["fer"][0] > r["fer"][1]
    assert r["fer"][1] == 0.0          # 8 dB is well past the cliff
    assert r["ber"][1] == 0.0
    assert 1.0 <= r["mean_iters"][1] < r["mean_iters"][0] <= 10.0
    again = sweep.ldpc_ber_sweep(
        [3.0, 8.0], 16, torch.Generator().manual_seed(0), device="cpu",
        algo=algo)
    for k in ("ber", "fer", "mean_iters"):
        np.testing.assert_array_equal(again[k], r[k])
    with pytest.raises(ValueError):
        sweep.ldpc_ber_sweep([3.0], 4, device="cpu", algo="bp")


@functools.lru_cache(maxsize=None)
def _soft_streams(mode):
    """JAX demod soft streams of one packet at three noise levels plus a
    pure-noise stream; valid frames only."""
    cfg = jfsk.FSKConfig(**GEOM[mode])
    sig, var = jsweep.make_single_packet_stream(cfg, bytes(range(256)), mode)
    rng = np.random.default_rng(4)
    streams = []
    for ebno in (4.0, 7.0, 14.0):
        iq = jchannel.add_awgn(sig, ebno, cfg.Fs, cfg.Rs, variance=var,
                               rng=rng)
        _, outs = jfsk.demod_stream(cfg, jnp.asarray(iq),
                                    cfg.num_frames(len(iq)))
        valid = np.asarray(outs.valid)
        streams.append(np.asarray(outs.soft)[valid].reshape(-1))
    streams.append(rng.normal(0, 1, len(streams[-1])).astype(np.float32))
    return streams


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_uw_window_decode_matches_jax(mode):
    cfg = fsk.FSKConfig(**GEOM[mode])
    oks = []
    for soft in _soft_streams(mode):
        okj, itj = jsweep._uw_window_decode(jfsk.FSKConfig(**GEOM[mode]),
                                            jnp.asarray(soft), mode, 10)
        okt, itt = sweep._uw_window_decode(cfg, torch.from_numpy(soft)[None],
                                           mode, 10)
        assert bool(okt[0]) == bool(okj) and int(itt[0]) == int(itj)
        oks.append(bool(okj))
    assert oks[2] and not oks[3]        # 14 dB decodes, pure noise does not


def test_uw_window_decode_masks_invalid_bits():
    """Masked soft bits neither correlate nor reach the decoder."""
    soft = torch.from_numpy(_soft_streams("v2")[2])[None]
    valid = torch.ones_like(soft, dtype=torch.bool)
    ok, it = sweep._uw_window_decode(TCFG, soft, "v2", 10, valid)
    assert bool(ok[0])
    ok, it = sweep._uw_window_decode(TCFG, soft, "v2", 10, ~valid)
    assert not bool(ok[0])


def test_chain_per_sweep_cliff():
    """Full chain on the device path: PER 1 at 4 dB, 0 at 20 dB."""
    r = sweep.chain_per_sweep(TCFG, [4.0, 20.0], trials_per_point=4,
                              device="cpu")
    assert r["trials"] == 4
    assert r["per"].tolist() == [1.0, 0.0]
    assert r["mean_iters"][1] < r["mean_iters"][0] == 10.0


def test_acquisition_search_matches_jax():
    """Same best offset and the same scores as JAX (exact: the scores are
    integer correlations of hard bits, and no hard bit differs) on a probe
    whose frames are all valid; the default probe, whose last frame runs
    past the capture, finds the same lock."""
    iq = _shifted_capture()
    grid = np.arange(-40000, 40001, 5000, np.float32)
    nf = _valid_frames(TCFG, iq) - 1
    bj, sj = jsweep.acquisition_search(JCFG, iq, grid, probe_frames=nf)
    bt, st = sweep.acquisition_search(TCFG, iq, grid, probe_frames=nf,
                                      device="cpu")
    assert bt == bj and 15000 <= bt <= 40000
    np.testing.assert_array_equal(st, sj)
    out_of_band = st[(grid < 13200) | (grid > 46800)]
    assert st.max() == 32 and out_of_band.max() <= st.max() - 8

    best, scores = sweep.acquisition_search(TCFG, iq, grid, device="cpu")
    assert best == bj and scores.max() == 32

    # the acquired offset is good enough for an actual decode
    n = np.arange(len(iq))
    ph = np.mod(n * np.float64(best) / TCFG.Fs, 1.0) * 2 * np.pi
    mixed = torch.from_numpy((iq * np.exp(-1j * ph)).astype(np.complex64))
    _, outs = fsk.demod_stream(TCFG, mixed, TCFG.num_frames(len(iq)))
    ok, _ = sweep._uw_window_decode(
        TCFG, outs.soft.reshape(1, -1), "v2", 10,
        outs.valid.repeat_interleave(TCFG.Nbits)[None])
    assert bool(ok[0])


@pytest.mark.parametrize("kw", [GEOM["v2"], dict(Fs=96000, Rs=9600, M=4)],
                         ids=["m2", "m4"])
def test_demod_lanes_equal_unbatched(kw):
    """vmapped lanes against one demod_stream call per lane: integer
    outputs exact, floats within the demod parity tolerance of
    test_torch_fsk.py (1e-4 of the frame's mean |soft|; rtol = atol = 1e-4
    for the rest)."""
    cfg = fsk.FSKConfig(**kw)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, cfg.Nbits * 30).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    lanes = np.stack([channel.add_awgn(sig, e, cfg.Fs, cfg.Rs, rng=rng)
                      for e in (5.0, 9.0, 30.0)])
    nf = cfg.num_frames(len(sig))
    final, outs = fsk.demod_lanes(cfg, torch.from_numpy(lanes), nf)
    assert outs.soft.shape == (3, nf, cfg.Nbits)
    for lane in range(3):
        fin1, one = fsk.demod_stream(cfg, torch.from_numpy(lanes[lane]), nf)
        for f in ("valid", "nin", "bits", "f_est"):
            assert torch.equal(getattr(outs, f)[lane], getattr(one, f)), f
        v = one.valid
        scale = one.soft[v].abs().mean(dim=1, keepdim=True)
        assert torch.all((outs.soft[lane][v] - one.soft[v]).abs()
                         <= 1e-4 * scale)
        for f in ("norm_rx_timing", "ppm", "ebno_db"):
            np.testing.assert_allclose(getattr(outs, f)[lane][v].numpy(),
                                       getattr(one, f)[v].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        assert int(final.pos[lane]) == int(fin1.pos)


def _run_cli(path, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx", str(path),
         "--format", "c64", "--fs", "96000", "--rs", "9600", "--device",
         "cpu", "--no-udp", "--chunk-seconds", "0.5", *extra],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stderr.strip().splitlines()


def test_cli_acquire_decodes_shifted_capture(tmp_path):
    """Three v2 packets tuned +30 kHz off: the plain CLI decodes none;
    with --acquire it locks (offsets 14.4k..33.6k of its grid can) and
    decodes all three, mixing chunk by chunk with phase continuity."""
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import ldpc

    rng = np.random.default_rng(5)
    bits = [rng.integers(0, 2, 1500).astype(np.uint8)]
    for _ in range(3):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode="v2"), "v2"))
        bits.append(rng.integers(0, 2, 400).astype(np.uint8))
    s = np.concatenate(bits)
    s = np.concatenate([s, np.zeros((-len(s)) % TCFG.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(TCFG, s, 2 * TCFG.Rs, TCFG.Rs)
    iq = channel.add_awgn(channel.freq_shift(sig, 30000.0, TCFG.Fs), 12.0,
                          TCFG.Fs, TCFG.Rs, rng=rng)
    path = tmp_path / "shifted.c64"
    iq.tofile(path)
    assert "crc_ok=0 " in _run_cli(path, "--image-dir",
                                   str(tmp_path / "a"))[-1]
    lines = _run_cli(path, "--acquire", "1.0", "--image-dir",
                     str(tmp_path / "b"))
    assert any(ln.startswith("acquired coarse offset +") for ln in lines)
    assert "crc_ok=3 " in lines[-1]


def test_channel_host_helpers_match_jax():
    rng = np.random.default_rng(9)
    iq = (rng.normal(0, 1, (500, 2)) @ [1, 1j]).astype(np.complex64)
    assert channel.signal_variance(iq) == jchannel.signal_variance(iq)
    np.testing.assert_array_equal(
        channel.add_awgn(iq, 6.0, 96000, 9600, rng=np.random.default_rng(1)),
        jchannel.add_awgn(iq, 6.0, 96000, 9600, rng=np.random.default_rng(1)))
    np.testing.assert_array_equal(channel.freq_shift(iq, 1234.5, 96000),
                                  jchannel.freq_shift(iq, 1234.5, 96000))
    for ratio in (0.996, 1.004):
        np.testing.assert_array_equal(channel.resample_linear(iq, ratio),
                                      jchannel.resample_linear(iq, ratio))


def test_channel_torch_versions():
    """freq_shift_torch equals freq_shift_jax within float32 cos/sin
    rounding (2e-6 on unit-magnitude samples at angles up to ~800 rad);
    add_awgn_torch is calibrated, peak-normalised and reproducible from
    its generator."""
    rng = np.random.default_rng(6)
    iq = np.exp(1j * rng.uniform(0, 6.28, 4000)).astype(np.complex64)
    want = np.asarray(jchannel.freq_shift_jax(jnp.asarray(iq), 3000.0,
                                              96000))
    got = channel.freq_shift_torch(torch.from_numpy(iq), 3000.0, 96000)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    shifts = np.array([3000.0, -700.0], np.float32)
    wantb = np.asarray(jchannel.freq_shift_jax(jnp.asarray(iq),
                                               jnp.asarray(shifts), 96000))
    gotb = channel.freq_shift_torch(torch.from_numpy(iq),
                                    torch.from_numpy(shifts), 96000)
    np.testing.assert_allclose(gotb.numpy(), wantb, atol=2e-6)

    x = torch.ones(2, 200000, dtype=torch.complex64)
    ebno = torch.tensor([0.0, 10.0])
    a = channel.add_awgn_torch(x, ebno, 96000, 9600, 1.0,
                               torch.Generator().manual_seed(3))
    b = channel.add_awgn_torch(x, ebno, 96000, 9600, 1.0,
                               torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.dtype == torch.complex64
    assert torch.allclose(a.abs().amax(dim=1), torch.ones(2))
    # out = (1 + noise) / peak, so var(out) / |mean(out)|^2 is the noise
    # variance var * Fs / (Rs * Eb/N0): 10 at 0 dB, 1 at 10 dB
    nvar = a.var(dim=1) / a.mean(dim=1).abs() ** 2
    np.testing.assert_allclose(nvar.numpy(), [10.0, 1.0], rtol=0.05)
    c = channel.add_awgn_torch(x, 10.0, 96000, 9600, 1.0,
                               torch.Generator().manual_seed(4))
    assert c.shape == x.shape
