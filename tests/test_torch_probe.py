"""The port's demod probe and its host helpers against the JAX package on
the same captures (CPU; the card's PROBE variant of the frame-loop kernel
is held to the plain loop in tests/test_torch_kernels.py and chip_smoke.py).

- `utils/probe.probe_demod`, on valid frames (the JAX package's invalid
  frames carry garbage, ROADMAP watch list): t_nin, t_high_sample, valid
  and t_f_est exact; rx_bits exact where the soft bit is clear of zero
  (|soft| > 1e-3 of the mean |soft|, as the card tests compare them: where
  both tones' magnitudes agree to an ulp the decision is a tie that the
  last-ulp rounding of either framework breaks either way, e.g. the first
  v1 frame's first bit below, soft 0.0 on both sides); rx_sd within the
  demod test's 1e-4 of the frame's mean |soft|; t_norm_rx_timing,
  t_rx_timing, t_ppm and t_EbNodB within rtol = atol = 1e-4; t_f_int and
  t_fft_est within 1e-5 of their rms (measured 6e-7 and 1.5e-6); and
  rx_sd bit-equal to the port's own demod_iq_np on the same capture.
- `ops/fsk.demod_iq_np` as tests/test_torch_fsk.py holds the demod.
- `ops/fsk.fsk_mod`: the integer phase accumulator exact against the JAX
  package's two-level int32 wrap, the waveform within JAX's own atol 2e-4
  (tests/test_fsk.py) of JAX's fsk_mod and of fsk_mod_np; fsk_mod_ext_vco
  exact.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_tpu.ops import channel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.utils import probe as jprobe
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.utils import probe as tprobe

torch.set_num_threads(1)

GEOMS = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}
SOFT_TOL = 1e-4       # of the frame's mean |soft| (tests/test_torch_fsk.py)
BIT_TOL = 1e-3        # hard bits compared where |soft| > this share
TRACE_TOL = 1e-5      # t_f_int, t_fft_est: max |d| / rms


def _capture(cfg, seed, nframes=40, ebno_db=8.0):
    """Random bits, FSK, the halves resampled 0.4 % fast and slow (so the
    elastic nin takes its three values), AWGN."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.Nbits * nframes).astype(np.uint8)
    sig, _ = jfsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    half = len(sig) // 2
    sig = np.concatenate([channel.resample_linear(sig[:half], 1.004),
                          channel.resample_linear(sig[half:], 0.996)])
    return channel.add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs, rng=rng)


def _rms_err(got, want):
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want) ** 2)))


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_probe_demod_matches_jax(mode):
    jcfg, tcfg = (m.FSKConfig(**GEOMS[mode]) for m in (jfsk, tfsk))
    iq = _capture(jcfg, seed=3)
    want = jprobe.probe_demod(jcfg, iq)
    got = tprobe.probe_demod(tcfg, iq, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.sum() >= 35
    for k in ("t_nin", "t_high_sample", "t_f_est"):
        np.testing.assert_array_equal(got[k][v], want[k][v], err_msg=k)
    assert len(set(want["t_nin"][v].tolist())) >= 2
    soft_w, soft_g = want["rx_sd"][v], got["rx_sd"][v]
    scale = np.abs(soft_w).mean(axis=1, keepdims=True)
    assert np.all(np.abs(soft_g - soft_w) <= SOFT_TOL * scale)
    clear = np.abs(soft_w) > BIT_TOL * scale
    np.testing.assert_array_equal(got["rx_bits"][v][clear],
                                  want["rx_bits"][v][clear])
    assert (got["rx_bits"][v] != want["rx_bits"][v]).sum() <= 1
    for k in ("t_norm_rx_timing", "t_rx_timing", "t_ppm", "t_EbNodB"):
        np.testing.assert_allclose(got[k][v], want[k][v], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k in ("t_f_int", "t_fft_est"):
        assert _rms_err(got[k][v], want[k][v]) <= TRACE_TOL, k
    # the probe does not change the demod
    soft, outs, _ = tfsk.demod_iq_np(tcfg, iq, device="cpu")
    np.testing.assert_array_equal(got["rx_sd"][got["valid"]].reshape(-1),
                                  soft)
    np.testing.assert_array_equal(got["t_nin"], outs.nin)
    # the eye of the last valid frame
    np.testing.assert_allclose(tprobe.eye_traces(tcfg, got),
                               jprobe.eye_traces(jcfg, want), rtol=0,
                               atol=1e-5)


def test_probe_traces_on_lanes_and_with_the_eye():
    """demod_raw_reference(with_eye, with_probe) on three lanes (the vmap
    path) gives each lane what the one-lane loop gives it, the eye probe
    before the trace; frames past a lane's end keep the final EMA; the
    last valid frame's trace equals the eye probe."""
    cfg = tfsk.FSKConfig(**GEOMS["v2"])
    iq = _capture(jfsk.FSKConfig(**GEOMS["v2"]), seed=8, nframes=30)
    data = torch.from_numpy(iq.view(np.float32).reshape(-1, 2).copy())
    span = 12 * cfg.N
    starts = torch.tensor([0, 5 * cfg.N, 9 * cfg.N], dtype=torch.int64)
    n_valid = torch.tensor([span, span - 3 * cfg.N, span], dtype=torch.int64)
    nf = cfg.num_frames(span)
    st, outs, eye, tr = tfsk.demod_raw_reference(
        cfg, data, "c64", nf, starts, n_valid, with_eye=True,
        with_probe=True)
    assert isinstance(eye, tfsk.EyeProbe) and isinstance(tr, tfsk.ProbeTrace)
    assert tr.f_int.shape == (3, nf, cfg.M, (cfg.Nsym + 1) * cfg.P)
    assert tr.fft_est.shape == (3, nf, cfg.Ndft // 2)
    assert tr.rx_timing.shape == tr.high_sample.shape == (3, nf)
    for lane in range(3):
        one = tfsk.demod_raw_reference(
            cfg, data, "c64", nf, starts[lane:lane + 1],
            n_valid[lane:lane + 1], with_probe=True)
        v = one[1].valid[0]
        assert torch.equal(outs.valid[lane], v)
        for a, b in zip(tr, one[2]):
            assert torch.allclose(a[lane][v], b[0][v], rtol=0, atol=1e-5)
        last = int(torch.nonzero(v)[-1])
        assert torch.equal(tr.f_int[lane, last], eye.f_int[lane])
        assert int(tr.high_sample[lane, last]) == int(eye.high_sample[lane])
        assert torch.equal(tr.fft_est[lane, ~v],
                           st.fft_est[lane].expand(int((~v).sum()), -1))
    assert not bool(outs.valid[1, -3:].any())


def test_demod_stream_probe_keeps_the_outputs():
    """with_probe adds the trace and changes nothing else: the state and
    every frame output equal a call without it."""
    cfg = tfsk.FSKConfig(**GEOMS["v1"])
    iq = torch.from_numpy(_capture(jfsk.FSKConfig(**GEOMS["v1"]), seed=9,
                                   nframes=12))
    nf = cfg.num_frames(len(iq))
    plain = tfsk.demod_stream(cfg, iq, nf)
    probed = tfsk.demod_stream(cfg, iq, nf, with_probe=True)
    assert len(plain) == 2 and len(probed) == 3
    for a, b in zip(plain[:2], probed[:2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_demod_iq_np_matches_jax(mode):
    jcfg, tcfg = (m.FSKConfig(**GEOMS[mode]) for m in (jfsk, tfsk))
    iq = _capture(jcfg, seed=11, nframes=30)
    sj, oj, fj = jfsk.demod_iq_np(jcfg, iq)
    st, ot, ft = tfsk.demod_iq_np(tcfg, iq, device="cpu")
    v = np.asarray(oj.valid)
    np.testing.assert_array_equal(ot.valid, v)
    np.testing.assert_array_equal(ot.nin[v], np.asarray(oj.nin)[v])
    np.testing.assert_array_equal(ot.bits[v], np.asarray(oj.bits)[v])
    assert st.shape == sj.shape == (v.sum() * tcfg.Nbits,)
    scale = np.abs(sj.reshape(-1, tcfg.Nbits)).mean(axis=1, keepdims=True)
    assert np.all(np.abs(st.reshape(-1, tcfg.Nbits)
                         - sj.reshape(-1, tcfg.Nbits)) <= SOFT_TOL * scale)
    assert int(ft.pos) == int(fj.pos) and int(ft.nin) == int(fj.nin)


@pytest.mark.parametrize("M", [2, 4])
def test_fsk_mod_matches_jax(M):
    kw = dict(Fs=96000, Rs=9600, M=M)
    jcfg, tcfg = jfsk.FSKConfig(**kw), tfsk.FSKConfig(**kw)
    rng = np.random.default_rng(M)
    bits = rng.integers(0, 2, (3, 2 * 1200)).astype(np.uint8)
    f1, shift = 19200, 9600
    # the phase accumulator: JAX's body of fsk_mod on its int32 path
    syms = (bits if M == 2 else bits.reshape(3, -1, 2) @ np.array([2, 1]))
    freqs = jnp.asarray(jfsk._sym_freqs(jcfg, f1, shift).astype(np.int32))[
        jnp.asarray(syms.astype(np.int32))]
    start = jfsk._wrapped_cumsum((freqs * jcfg.Ts) % jcfg.Fs, jcfg.Fs)
    acc_j = (start[..., None] + freqs[..., None]
             * jnp.arange(1, jcfg.Ts + 1, dtype=jnp.int32)) % jcfg.Fs
    acc_t = tfsk._phase_acc(tcfg, torch.from_numpy(bits), f1, shift)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    got = tfsk.fsk_mod(tcfg, torch.from_numpy(bits), f1, shift).numpy()
    want = np.asarray(jfsk.fsk_mod(jcfg, jnp.asarray(bits), f1, shift))
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    for row in range(3):
        ref, _ = jfsk.fsk_mod_np(jcfg, bits[row], f1, shift)
        np.testing.assert_allclose(got[row], ref, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(
        tfsk.fsk_mod_ext_vco(tcfg, bits[0], f1, shift),
        jfsk.fsk_mod_ext_vco(jcfg, bits[0], f1, shift))


def test_fsk_mod_past_int32():
    """The int64 accumulator stays exact where the summed phase advances
    pass 2^31: a long stream at the v2 flight geometry with tones that are
    not whole cycles a symbol equals fsk_mod_np's numpy int64
    accumulator."""
    cfg = tfsk.V2_CONFIG
    f1, shift = 12345, 9601
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 20000).astype(np.uint8)
    acc = tfsk._phase_acc(cfg, torch.from_numpy(bits), f1, shift).numpy()
    freqs = f1 + shift * bits.astype(np.int64)
    adv = (freqs * cfg.Ts) % cfg.Fs
    start = np.concatenate([[0], np.cumsum(adv)[:-1]]) % cfg.Fs
    want = (start[:, None] + freqs[:, None]
            * np.arange(1, cfg.Ts + 1)) % cfg.Fs
    assert np.cumsum(adv)[-1] > 2 ** 31
    np.testing.assert_array_equal(acc, want)
    sig, _ = tfsk.fsk_mod_np(cfg, bits, f1, shift)
    np.testing.assert_allclose(
        tfsk.fsk_mod(cfg, torch.from_numpy(bits), f1, shift).numpy(), sig,
        rtol=0, atol=2e-4)


def test_probe_workspace_and_device_trace(tmp_path):
    """save_npz writes every trace; device_trace writes a trace file that
    TensorBoard's profiler plugin reads."""
    cfg = tfsk.FSKConfig(**GEOMS["v2"])
    iq = _capture(jfsk.FSKConfig(**GEOMS["v2"]), seed=2, nframes=6)
    logdir = tmp_path / "trace"
    with tprobe.device_trace(str(logdir)):
        traces = tprobe.probe_demod(cfg, iq, device="cpu")
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    tprobe.save_npz(str(tmp_path / "ws.npz"), traces)
    ws = np.load(tmp_path / "ws.npz")
    assert set(ws.files) == set(traces)
    for k in traces:
        np.testing.assert_array_equal(ws[k], traces[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tprobe.probe_demod(cfg, iq)          # device defaults to cuda
