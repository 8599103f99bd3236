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


@pytest.mark.parametrize("port_numpy", [False, True],
                         ids=["port_c_fsm", "port_numpy_fsm"])
@pytest.mark.parametrize("force_numpy", [False, True],
                         ids=["jax_c_fsm", "jax_numpy_fsm"])
@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_uw_fsm_matches_jax(mode, force_numpy, port_numpy):
    """The port's UW FSMs (C and numpy) against the JAX package's C FSM and
    its numpy FSM: positions and final bit buffer exact, on clean and noisy
    streams (the noisy ones trigger near-UW hits right after a packet) and
    from a non-zero initial buffer."""
    rng = np.random.default_rng(7)
    nuw = len(jdeframe._mode_params(mode)[0])
    for sigma, seed in ((0.3, 21), (0.75, 22), (1.1, 23)):
        soft, _ = _soft_stream(mode, 4, sigma, seed)
        hard = (soft < 0).astype(np.uint8)
        for init in (None, rng.integers(0, 2, nuw).astype(np.int8)):
            pj, fj = jdeframe.uw_detect_positions(hard, mode, init,
                                                  force_numpy=force_numpy)
            pt, ft = deframe.uw_detect_positions(hard, mode, init,
                                                 force_numpy=port_numpy)
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
    hard bits packed 32 to a word as one ballot packs them (a score block
    of 1024 starts packs the words from its first start, which are these
    words), 64 bits from each start t funnel-shifted out of words t/32 ..
    t/32 + 2, and nuw - 2 popcount((bits ^ UW) & mask)."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    uw, nuw, _ = ktopk.mode_params(mode)
    n = len(soft)
    nlive = ktopk.geometry(n, mode)[0]
    nwords = -(-n // 32) + 2
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


SENT, TILE_MASK = -32768, 0xFFFFFF


def _tile_key(scores, tile):
    """The kernel's key of one tile of 64 scores and its first maximum's
    offset: a start's key is (score + 64) << 8 | (255 - offset), 0 where
    blanked; the tile's is (best >> 8) << 24 | (0xFFFFFF - tile)."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    v = scores[tile * ktopk.TILE:(tile + 1) * ktopk.TILE].astype(np.int64)
    off = np.arange(len(v))
    keys = np.where(v == SENT, 0, ((v + 64) << 8) | (255 - off))
    best = int(keys.max())
    if best == 0:
        return 0, 255
    return ((best >> 8) << 24) | (TILE_MASK - tile), 255 - (best & 255)


def _emulate_tile_picks(scores, mode, k):
    """The pick kernel in numpy: k rounds of a max over the tile keys (the
    largest score, then the smallest tile; its offset gives the first
    maximum), a key of 0 exhausts this and the later picks, and the blank
    [s - reach + 1, s + reach - 1] zeroes the keys of the tiles between its
    boundary tiles and rescans those two, writing the blanked scores back;
    a boundary tile whose key is already 0 is wholly blanked and stays so
    (an earlier blank zeroed it without writing its scores).
    Returns (positions (k,) with -1 where exhausted, exhausted (k,))."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    _, nuw, syms = ktopk.mode_params(mode)
    reach = nuw + syms
    sc = np.asarray(scores, np.int64).copy()
    nlive, ntiles = len(sc), -(-len(sc) // ktopk.TILE)
    keys, offs = np.zeros(ntiles, np.int64), np.zeros(ntiles, np.int64)
    for t in range(ntiles):
        keys[t], offs[t] = _tile_key(sc, t)
    pos, dead = np.full(k, -1), np.ones(k, bool)
    for r in range(k):
        m = int(keys.max()) if ntiles else 0
        if m == 0:
            break
        tile = TILE_MASK - (m & TILE_MASK)
        s = tile * ktopk.TILE + int(offs[tile])
        pos[r], dead[r] = s, False
        a, b = max(s - reach + 1, 0), min(s + reach - 1, nlive - 1)
        ta, tb = a // ktopk.TILE, b // ktopk.TILE
        keys[ta + 1:tb] = 0
        for t in {ta, tb}:
            if keys[t] == 0:
                continue
            lo, hi = t * ktopk.TILE, min((t + 1) * ktopk.TILE, nlive)
            span = np.arange(lo, hi)
            sc[span[(span >= a) & (span <= b)]] = SENT
            keys[t], offs[t] = _tile_key(sc, t)
    return pos, dead


def _plant_uw(soft, mode, starts):
    """soft with a clean copy of the UW at each start (score nuw there)."""
    uw = deframe._mode_params(mode)[0]
    out = soft.copy()
    for s in starts:
        out[s:s + len(uw)] = 1.0 - 2.0 * uw
    return out


def _tile_pick_cases(mode):
    """(label, soft, k): random streams, a stream whose scores all tie,
    UW copies whose blanks start or end exactly on a tile boundary, more
    picks than placeable windows, and a stream shorter than a packet."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    _, nuw, syms = ktopk.mode_params(mode)
    reach = nuw + syms
    rng = np.random.default_rng(61)
    noise = rng.normal(0, 1, 20000).astype(np.float32)
    train, _ = _soft_stream(mode, 3, 0.7, 62)
    # blank of s1 starts at tile 40's first start; blank of s2 ends at the
    # last start of a tile
    s1 = 40 * ktopk.TILE + reach - 1
    s2 = -(-(s1 + 2 * reach) // ktopk.TILE) * ktopk.TILE - reach
    edges = _plant_uw(noise, mode, [s1, s2])
    assert (s1 - reach + 1) % ktopk.TILE == 0
    assert (s2 + reach) % ktopk.TILE == 0
    return [("random", noise, 6), ("train", train, 5),
            ("all_tied", np.ones(9000, np.float32), 5),
            ("tile_edges", edges, 7),
            ("k_above_placeable", train[:3 * reach], 6),
            ("shorter_than_a_packet", noise[:syms], 3)]


@pytest.mark.parametrize("case", range(6), ids=["random", "train", "all_tied",
                                                "tile_edges", "k_above",
                                                "short"])
@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_tile_pick_emulation_matches_reference_and_jax(mode, case):
    """Without a card: the pick kernel's algorithm on the tile maxima
    (emulated in numpy on the emulated scores) gives the positions and
    exhausted flags of topk_windows_reference and of JAX's
    deframe_topk."""
    label, soft, k = _tile_pick_cases(mode)[case]
    pos, dead = _emulate_tile_picks(_emulate_topk_scores(soft, mode), mode,
                                    k)
    _, pos_w, exh_w = deframe.topk_windows_reference(
        torch.from_numpy(soft)[None], mode, k)
    np.testing.assert_array_equal(pos, pos_w[0].numpy())
    np.testing.assert_array_equal(dead, exh_w[0].numpy())
    pos_j = np.asarray(jdeframe.deframe_topk(jnp.asarray(soft), mode=mode,
                                             k=k)[3])
    np.testing.assert_array_equal(pos, pos_j)
    if label == "tile_edges":
        assert not dead[:2].any()
    if label in ("k_above_placeable", "shorter_than_a_packet"):
        assert dead.any()
    if label == "shorter_than_a_packet":
        assert dead.all()


def _emulate_lane_crc(packet):
    """The CRC kernel's warp in numpy: each of 32 lanes takes the CRC of
    its 8 bytes from state 0 with the byte table, five levels join
    neighbours (the left advanced over the right's zero bytes by the high-
    and low-byte tables of kernels/crc_pack.crc_tables), and INIT_TERM
    brings in the init 0xFFFF."""
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    tab = kcrc.crc_tables().astype(np.int64)
    lanes = []
    for lane in range(32):
        c = 0
        for m in range(kcrc.LANE_BYTES):
            byte = int(packet[8 * lane + m])
            c = ((c << 8) & 0xFFFF) ^ tab[((c >> 8) ^ byte) & 0xFF]
        lanes.append(int(c))
    for level in range(kcrc.LEVELS):
        adv = tab[256 + level * 512:]
        nxt = []
        for lane in range(32):
            other = lanes[lane ^ (1 << level)]
            right = (lane >> level) & 1
            left = other if right else lanes[lane]
            nxt.append(int(adv[left >> 8] ^ adv[256 + (left & 0xFF)])
                       ^ (lanes[lane] if right else other))
        lanes = nxt
    assert len(set(lanes)) == 1
    return lanes[0] ^ kcrc.INIT_TERM


def test_lane_split_crc_emulation_matches_jax():
    """Without a card: the lane-split CRC with the advance tables equals
    core.framing.crc16_ccitt and JAX's crc16 on random, all-zero and
    all-0xFF packets."""
    rng = np.random.default_rng(8)
    packets = [rng.integers(0, 256, 256, np.uint8) for _ in range(4)]
    packets += [np.zeros(256, np.uint8), np.full(256, 0xFF, np.uint8)]
    want_j = np.asarray(jcrc.crc16(jnp.asarray(np.stack(packets).astype(
        np.int32))))
    for p, wj in zip(packets, want_j):
        got = _emulate_lane_crc(p)
        assert got == framing.crc16_ccitt(p.tobytes()) == int(wj)


def _emulate_tile_argmax(scores):
    """One round of the pick kernel's argmax: the max over the tiles' keys
    (`_tile_key`: the largest score, then the smallest tile, then the
    tile's first maximum); (SENT, -1) where every start is blanked."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    scores = np.asarray(scores, np.int64)
    keys = [_tile_key(scores, t)
            for t in range(-(-len(scores) // ktopk.TILE))]
    m, off = max(keys)
    if m == 0:
        return SENT, -1
    tile = TILE_MASK - (m & TILE_MASK)
    return (m >> 24) - 64, tile * ktopk.TILE + off


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
        v, i = _emulate_tile_argmax(arr)
        assert (v, i) == (arr.max(), int(torch.argmax(torch.as_tensor(arr))))
    assert _emulate_tile_argmax(np.full(100, SENT)) == (SENT, -1)


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
