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


@pytest.mark.parametrize("tail", ["none", "iters", "pos"])
def test_crc_pack_layouts(tail):
    """crc_pack's rows against the layouts its callers used: decode_windows'
    (B, 260) rows (bytes, ok, iters clamped to a byte) and JAX's
    pack_decode_results' (B, 263) rows (bytes, ok, little-endian position),
    on valid and corrupted codewords and on bits that are not 0/1; "none":
    the flags alone (packet_crc_ok) equal JAX's, and rows need a tail."""
    rng = np.random.default_rng(5)
    good = _codeword_bits(rng, 7, 3)
    odd = rng.integers(0, 4, good.shape).astype(np.uint8)
    extra = torch.as_tensor([-5, 0, 3, 10, 255, 256, 70000], dtype=torch.int32)
    for arr in (good, odd):
        bits = torch.from_numpy(arr)
        ok = crc.packet_crc_ok(bits)
        by = crc.bits_to_bytes(bits[:, :2064]).to(torch.uint8)
        if tail == "iters":
            rows = crc.crc_pack(bits, iters=extra)
            want = torch.cat([by, ok[:, None].to(torch.uint8),
                              torch.clamp(extra, 0, 255)[:, None].to(
                                  torch.uint8)], dim=1)
        elif tail == "pos":
            rows = crc.crc_pack(bits, positions=extra)
            want = torch.from_numpy(np.array(jdeframe.pack_decode_results(
                jnp.asarray(by.numpy()), jnp.asarray(ok.numpy()),
                jnp.asarray(extra.numpy()))))
        else:
            np.testing.assert_array_equal(
                ok.numpy(), np.asarray(jcrc.packet_crc_ok(jnp.asarray(arr))))
            with pytest.raises(ValueError):
                crc.crc_pack(bits)
            continue
        assert torch.equal(rows, want)
        assert torch.equal(crc.crc_pack_reference(
            bits, **({"iters": extra} if tail == "iters"
                     else {"positions": extra})), rows)
    assert crc.packet_crc_ok(torch.from_numpy(good)).tolist() == \
        [True] * 4 + [False] * 3
    with pytest.raises(ValueError):
        crc.crc_pack(torch.from_numpy(good), iters=extra, positions=extra)


def _emulate_topk_scores(soft, mode):
    """The acquisition kernel's scores (csrc/deframe_topk.cu), in numpy: the
    hard bits packed 32 to a word as one ballot packs them, 64 bits from
    each start t funnel-shifted out of words t/32 .. t/32 + 2, and
    nuw - 2 popcount((bits ^ UW) & mask)."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    uw, nuw, _ = ktopk.mode_params(mode)
    n = len(soft)
    nlive, nwords, _ = ktopk.geometry(n, mode)
    hard = np.zeros(nwords * 32, np.uint64)
    hard[:n] = soft < 0
    words = (hard.reshape(nwords, 32)
             << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint64)
    t = np.arange(nlive)
    w0, sh = t >> 5, (t & 31).astype(np.uint64)
    a = words[w0] | (words[w0 + 1] << np.uint64(32))
    hi = words[w0 + 2] << (np.uint64(64) - sh)
    win = np.where(sh > 0, (a >> sh) | np.where(sh > 0, hi, 0), a)
    diff = (win ^ np.uint64(uw)) & np.uint64((1 << nuw) - 1)
    pop = np.array([bin(int(d)).count("1") for d in diff], np.int64)
    return nuw - 2 * pop


def _emulate_block_argmax(scores, threads=512):
    """The kernel's pick: each thread keeps the first maximum of its
    strided slice (strictly greater replaces), then a tree of (value,
    index) pairs where the larger value wins and a tie goes to the smaller
    index; -32768 (blank) everywhere gives (blank, INT_MAX)."""
    best = []
    for tid in range(threads):
        v, i = -32768, 2**31 - 1
        for t in range(tid, len(scores), threads):
            if scores[t] > v:
                v, i = int(scores[t]), t
        best.append((v, i))
    while len(best) > 1:
        best = [max(best[j], best[j + 1], key=lambda p: (p[0], -p[1]))
                for j in range(0, len(best), 2)]
    return best[0]


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_topk_kernel_scores_and_picks_emulated(mode):
    """Without a card: the emulated kernel's scores equal the plain
    correlation's on the placeable starts, and its argmax equals
    torch.argmax's first maximum on score arrays full of ties (and on an
    all-blank one)."""
    soft, _ = _soft_stream(mode, 3, 0.7, 41)
    uw, _, syms = deframe._mode_params(mode)
    scores = _emulate_topk_scores(soft, mode)
    hard_pm = torch.where(torch.from_numpy(soft) < 0, -1.0, 1.0)
    kern = torch.as_tensor(1.0 - 2.0 * uw.astype(np.float32))
    plain = torch.nn.functional.conv1d(hard_pm[None, None],
                                       kern[None, None])[0, 0]
    n_live = len(soft) - syms - len(uw) + 1
    assert len(scores) == n_live
    np.testing.assert_array_equal(scores, plain[:n_live].numpy())
    rng = np.random.default_rng(2)
    for arr in (rng.integers(-3, 3, 5000), np.full(1300, 7),
                rng.integers(0, 2, 700) * 40 - 20):
        v, i = _emulate_block_argmax(arr)
        assert (v, i) == (arr.max(), int(torch.argmax(torch.as_tensor(arr))))
    assert _emulate_block_argmax(np.full(100, -32768)) == (-32768, 2**31 - 1)


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_deframe_topk_ties_and_exhaustion_match_jax(mode):
    """A periodic stream whose UW hits all score the same (first-maximum
    ties pick the earliest) and more picks than placeable windows
    (exhausted picks: position -1, max_iter): the port equals JAX."""
    one, _ = _soft_stream(mode, 1, 0.0, 43)
    soft = np.resize(one, 3 * len(one) + 77).astype(np.float32)
    k = 7
    got = deframe.deframe_topk(soft, mode, k=k, device="cpu")
    want = jdeframe.deframe_topk(jnp.asarray(soft), mode=mode, k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos = got[3].numpy()
    assert (pos[:3] >= 0).all() and (pos[3:] == -1).all()
    assert int(got[1].sum()) == 3 and (got[2].numpy()[3:] == 10).all()
