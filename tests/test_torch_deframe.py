"""PyTorch port of the CRC and deframer (wenet_tpu_torch.ops.crc, .deframe)
against the JAX package on the same soft streams: CRCs, decoded packets,
CRC flags, iteration counts and UW positions are exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wenet_tpu.core import framing
from wenet_tpu.ops import crc as jcrc
from wenet_tpu.ops import deframe as jdeframe
from wenet_tpu_torch.ops import crc, deframe, ldpc

torch.set_num_threads(1)


def _codeword_bits(rng, n, n_bad):
    """(n, 2580) codeword bits: valid packets, the last n_bad corrupted."""
    out = []
    for i in range(n):
        body = framing.pad_payload(rng.integers(0, 256, 256, np.uint8).tobytes())
        body += int(framing.crc16_ccitt(body)).to_bytes(2, "little")
        bits = np.unpackbits(np.frombuffer(body + ldpc.encode_bytes(body),
                                           np.uint8))[:2580]
        if i >= n - n_bad:
            bits[rng.integers(0, 2064)] ^= 1
        out.append(bits)
    return np.stack(out)


def test_crc_matches_jax():
    rng = np.random.default_rng(1)
    bits = _codeword_bits(rng, 6, 2)
    by_t = crc.bits_to_bytes(torch.from_numpy(bits[:, :2064]))
    by_j = np.asarray(jcrc.bits_to_bytes(jnp.asarray(bits[:, :2064])))
    np.testing.assert_array_equal(by_t.numpy(), by_j)
    np.testing.assert_array_equal(
        crc.crc16(by_t[:, :256]).numpy(),
        np.asarray(jcrc.crc16(jnp.asarray(by_j[:, :256]))))
    ok = crc.packet_crc_ok(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(
        ok, np.asarray(jcrc.packet_crc_ok(jnp.asarray(bits))))
    assert ok.tolist() == [True] * 4 + [False] * 2


def _soft_stream(mode, n_packets, sigma, seed):
    """Framed packets between random idle bits, as +/-1 soft symbols with
    Gaussian noise; returns (soft, payloads)."""
    rng = np.random.default_rng(seed)
    parts, payloads = [rng.integers(0, 2, 700).astype(np.uint8)], []
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, np.uint8).tobytes()
        payloads.append(p)
        parts.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        parts.append(rng.integers(0, 2, int(rng.integers(50, 400))
                                  ).astype(np.uint8))
    bits = np.concatenate(parts)
    soft = (1.0 - 2.0 * bits) + rng.normal(0, sigma, bits.shape)
    return soft.astype(np.float32), payloads


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_decode_windows_matches_jax(mode):
    """Candidate windows at the true UW positions, two noise levels, plus
    windows of pure noise: packets, CRC flags and iterations exact."""
    _, _, syms = jdeframe._mode_params(mode)
    wins = []
    for sigma, seed in ((0.4, 1), (0.62, 2)):
        soft, _ = _soft_stream(mode, 3, sigma, seed)
        pos, _ = jdeframe.uw_detect_positions((soft < 0).astype(np.uint8),
                                              mode)
        wins += [soft[t + 1:t + 1 + syms] for t in pos]
    rng = np.random.default_rng(3)
    wins += list(rng.normal(0, 1, (2, syms)).astype(np.float32))
    wins = np.stack(wins).astype(np.float64)
    pj, okj, itj = jdeframe.decode_windows(wins, mode)
    pt, okt, itt = deframe.decode_windows(wins, mode, device="cpu")
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(itt, itj)
    assert okt[:3].all() and not okt[-2:].any()


@pytest.mark.parametrize("force_numpy", [False, True],
                         ids=["jax_c_fsm", "jax_numpy_fsm"])
@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_uw_fsm_matches_jax(mode, force_numpy):
    """The port's numpy UW FSM against the JAX package's C FSM and its numpy
    FSM: positions and final bit buffer exact, on clean and noisy streams
    (the noisy ones trigger near-UW hits right after a packet) and from a
    non-zero initial buffer."""
    rng = np.random.default_rng(7)
    nuw = len(jdeframe._mode_params(mode)[0])
    for sigma, seed in ((0.3, 21), (0.75, 22), (1.1, 23)):
        soft, _ = _soft_stream(mode, 4, sigma, seed)
        hard = (soft < 0).astype(np.uint8)
        for init in (None, rng.integers(0, 2, nuw).astype(np.int8)):
            pj, fj = jdeframe.uw_detect_positions(hard, mode, init,
                                                  force_numpy=force_numpy)
            pt, ft = deframe.uw_detect_positions(hard, mode, init)
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_deframe_soft_matches_jax(mode):
    soft, payloads = _soft_stream(mode, 4, 0.5, 10 + len(mode))
    for acq in ("fsm", "all"):
        rj = jdeframe.deframe_soft(soft, mode, acquisition=acq)
        rt = deframe.deframe_soft(soft, mode, acquisition=acq,
                                   device="cpu")
        assert rt.payloads == rj.payloads
        np.testing.assert_array_equal(rt.positions, rj.positions)
        np.testing.assert_array_equal(rt.crc_ok, rj.crc_ok)
        np.testing.assert_array_equal(rt.iters, rj.iters)
    assert rt.payloads == payloads


def test_stream_deframer_unaligned_chunks():
    """StreamDeframer.push over unaligned chunks equals the JAX one."""
    soft, payloads = _soft_stream("v2", 5, 0.45, 31)
    dj = jdeframe.StreamDeframer("v2")
    dt = deframe.StreamDeframer("v2", device="cpu")
    got_j, got_t = [], []
    step = 1777
    for i in range(0, len(soft), step):
        got_j += dj.push(soft[i:i + step])
        got_t += dt.push(soft[i:i + step])
    assert got_t == got_j == payloads
    assert (dt.n_detections, dt.n_crc_ok) == (dj.n_detections, dj.n_crc_ok)
