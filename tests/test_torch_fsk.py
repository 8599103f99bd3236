"""PyTorch port of the FSK demod (wenet_tpu_torch.ops.fsk) against the JAX
demod_stream (frames_per_step=1) on the same noisy captures.

Integer outputs on valid frames (valid, nin, hard bits, f_est, which is a
bin index times Fs/Ndft) are exact.  Floats differ in the last ULPs: the
matmul and reduction orders differ between the two frameworks, and XLA's
CPU backend contracts multiply-adds into FMAs where torch rounds twice (the
port evaluates the large carrier-phase angles as single-rounded FMAs, see
ops/fsk._fma).  Measured maxima over these captures: soft bits 1.4e-5 of
the frame's mean |soft| (M=4; 8e-6 for M=2), norm_rx_timing 1.0e-6
absolute, ppm 1e-6 relative, Eb/N0 8e-5 dB.  Tolerances: soft 1e-4 of the
frame's mean |soft|, the others rtol = atol = 1e-4.
"""
import numpy as np
import pytest
import torch

import jax

from wenet_tpu.ops import channel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.utils import compat as jcompat
from wenet_tpu_torch.ops import fsk as tfsk

torch.set_num_threads(1)

CONFIGS = {
    "v2_scaled": dict(Fs=96000, Rs=9600),       # Ts=P=10
    "v1_scaled": dict(Fs=92000, Rs=11500),      # Ts=P=8
    "odd_ts5": dict(Fs=48000, Rs=9600),         # Ts=P=5
    "m4": dict(Fs=96000, Rs=9600, M=4),
}


def _capture(cfg, seed, nframes=50, ebno_db=8.0):
    """Random bits, FSK, AWGN; the second half resampled ~0.4% fast and
    the rest ~0.4% slow so the elastic nin takes all three values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.Nbits * nframes).astype(np.uint8)
    sig, _ = jfsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    half = len(sig) // 2
    sig = np.concatenate([channel.resample_linear(sig[:half], 1.004),
                          channel.resample_linear(sig[half:], 0.996)])
    return channel.add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs, rng=rng)


def _jax_demod(cfg, iq, nf, state=None):
    final, outs = jfsk.demod_stream(cfg, jcompat.put_complex(iq), nf, state)
    return final, jax.tree.map(np.asarray, outs)


def _torch_demod(tcfg, iq, nf, state=None):
    final, outs = tfsk.demod_stream(tcfg, torch.from_numpy(iq), nf, state)
    return final, jfsk.FrameOut(**{k: v.numpy()
                                   for k, v in outs._asdict().items()})


def _assert_frames_match(oj, ot):
    np.testing.assert_array_equal(ot.valid, oj.valid)
    v = oj.valid
    assert v.sum() > 10
    np.testing.assert_array_equal(ot.nin[v], oj.nin[v])
    np.testing.assert_array_equal(ot.bits[v], oj.bits[v])
    np.testing.assert_array_equal(ot.f_est[v], oj.f_est[v])
    scale = np.abs(oj.soft[v]).mean(axis=1, keepdims=True)
    assert np.all(np.abs(ot.soft[v] - oj.soft[v]) <= 1e-4 * scale)
    for f in ("norm_rx_timing", "ppm", "ebno_db"):
        np.testing.assert_allclose(getattr(ot, f)[v], getattr(oj, f)[v],
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def _configs(name):
    kw = CONFIGS[name]
    return jfsk.FSKConfig(**kw), tfsk.FSKConfig(**kw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_demod_stream_matches_jax(name):
    jcfg, tcfg = _configs(name)
    iq = _capture(jcfg, seed=len(name))
    nf = jcfg.num_frames(len(iq))
    _, oj = _jax_demod(jcfg, iq, nf)
    _, ot = _torch_demod(tcfg, iq, nf)
    _assert_frames_match(oj, ot)
    assert len(set(oj.nin[oj.valid].tolist())) >= 2


def test_resume_from_jax_state():
    """JAX demodulates k frames; its carry continues in the port and must
    match JAX continuing from the same carry."""
    jcfg, tcfg = _configs("v2_scaled")
    iq = _capture(jcfg, seed=41)
    k = 17
    final_j, _ = _jax_demod(jcfg, iq, k)
    nf2 = jcfg.num_frames(len(iq)) - k
    _, oj = _jax_demod(jcfg, iq, nf2, final_j)
    carry = tfsk.state_from_numpy(
        {f: np.asarray(v) for f, v in final_j._asdict().items()})
    _, ot = _torch_demod(tcfg, iq, nf2, carry)
    _assert_frames_match(oj, ot)


@pytest.mark.parametrize("name", ["v2_scaled", "m4"])
def test_chunked_equals_oneshot(name):
    """In the port, demodulating k frames and continuing from the carried
    state (through a numpy round trip) is bit-identical to one pass."""
    jcfg, tcfg = _configs(name)
    iq = _capture(jcfg, seed=7)
    nf = tcfg.num_frames(len(iq))
    _, one = tfsk.demod_stream(tcfg, torch.from_numpy(iq), nf)
    k = 13
    st1, a = tfsk.demod_stream(tcfg, torch.from_numpy(iq), k)
    st1 = tfsk.state_from_numpy(tfsk.state_to_numpy(st1))
    _, b = tfsk.demod_stream(tcfg, torch.from_numpy(iq), nf - k, st1)
    for field in tfsk.FrameOut._fields:
        joined = torch.cat([getattr(a, field), getattr(b, field)])
        assert torch.equal(joined, getattr(one, field)), field
