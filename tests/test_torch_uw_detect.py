"""The streaming receivers' deframe on the card (`ops.deframe.LaneDeframer`)
and its acquisition kernel (`kernels.uw_detect`).

On the CPU:
- The acquisition's plain version (`uw_detect_lanes_reference`), each case
  the middle lane of a three-lane call, against the host FSM
  (`uw_detect_positions`, its numpy emulation and the C FSM) followed by
  `StreamDeframer.consume`'s tail rule: positions, count, cut and the
  carried register exact.  Cases: random streams, UWs planted with 0 up
  to `allowed` errors, a UW straddling two pushes (its head in the
  carried register), UWs inside the nuw - 1 mixed windows after a packet,
  a detection whose packet does not fit, a non-zero carried register,
  short and empty buffers.
- The card path's plain version fed chunked pushes on two lanes against a
  `StreamDeframer` a lane on the same soft streams: payloads, positions,
  CRC flags, counters, the carried tail and register, push by push.
- The `Receiver` with its deframe on the card path's plain version equals
  the host path: payloads push by push, `RxStats`, `bp_windows`.

The `cuda` cases (skipped here; on the card `python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_uw_detect.py`): the kernel bit for bit
against the C FSM on the cases above; the card path against its plain
version; `Receiver` (v2 and v1, cu8, with the eye probe) and
`WidebandReceiver` (8 lanes) at the flight geometry against the host path
on the card, push by push, with two host waits a serial push; the
windows of the acquisition's detections (`deframe_topk.fsm_llrs`) against
`fsm_windows_reference` and `sd_to_llr`; BP with a live count on the card
and CRC rows written into a larger buffer.

This file imports no JAX."""
import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch import kernels, native
from wenet_tpu_torch.core import framing
from wenet_tpu_torch.ops import channel, deframe, fsk, ldpc
from wenet_tpu_torch.rx import pipeline
from wenet_tpu_torch.tools import pp_breakdown

torch.set_num_threads(1)

GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}


def _params(mode):
    uw, allowed, syms = deframe._mode_params(mode)
    return uw.astype(np.uint8), allowed, syms


def _frame(mode, rng) -> np.ndarray:
    """A framed random payload's bits (preamble, UW, packet)."""
    p = rng.integers(0, 256, 256, np.uint8).tobytes()
    return framing.frame_to_bits(
        framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode)


def _planted(mode, rng, n, errors):
    """n random bits with UWs planted, each with the next count of errors
    of `errors` (the later ones closer than a packet to the one before,
    so the FSM skips them)."""
    uw, _, syms = _params(mode)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    at, k = 100, 0
    while at + len(uw) < n:
        w = uw.copy()
        w[rng.choice(len(uw), errors[k % len(errors)], replace=False)] ^= 1
        bits[at: at + len(uw)] = w
        at += int(rng.integers(syms // 3, 2 * syms))
        k += 1
    return bits


def _case(case, mode):
    """(hard bits uint8, init bit buffer int8 or None) of a case."""
    uw, allowed, syms = _params(mode)
    nuw = len(uw)
    rng = np.random.default_rng([len(case), ord(case[0]), nuw])
    if case == "noise":
        return rng.integers(0, 2, 30_000).astype(np.uint8), None
    if case == "planted":
        return _planted(mode, rng, 40_000, list(range(allowed + 2))), None
    if case == "straddle":
        # the UW's head in the carried register, its tail the buffer's start
        k = nuw // 2
        init = rng.integers(0, 2, nuw).astype(np.int8)
        init[nuw - k:] = uw[:k]
        bits = rng.integers(0, 2, 2 * syms).astype(np.uint8)
        bits[: nuw - k] = uw[k:]
        return bits, init
    if case == "after_packet":
        # a UW at 50, then UWs starting j symbols before the packet's end:
        # they end inside the nuw - 1 windows that mix the frozen register
        bits = rng.integers(0, 2, 6 * syms).astype(np.uint8)
        t, j = 50 + nuw - 1, 1
        bits[t - nuw + 1: t + 1] = uw
        while t + 2 * syms + 2 * nuw < len(bits):
            t0 = t + syms + 1
            bits[t0: t0 + nuw - j] = uw[j:]
            t = t0 + nuw - 1 - j
            j = j % allowed + 1
        return bits, None
    if case == "cut_packet":
        # two frames, the second's packet cut short
        bits = np.concatenate([_frame(mode, rng), _frame(mode, rng)])
        return bits[: len(bits) - syms // 2], None
    if case == "init_register":
        bits = np.concatenate([_frame(mode, rng) for _ in range(3)]
                              + [rng.integers(0, 2, 500).astype(np.uint8)])
        return bits, rng.integers(0, 2, nuw).astype(np.int8)
    if case == "short":
        return rng.integers(0, 2, syms + nuw // 2).astype(np.uint8), \
            rng.integers(0, 2, nuw).astype(np.int8)
    if case == "tiny":
        return rng.integers(0, 2, nuw - 3).astype(np.uint8), \
            rng.integers(0, 2, nuw).astype(np.int8)
    if case == "empty":
        return np.zeros(0, np.uint8), rng.integers(0, 2, nuw).astype(np.int8)
    raise ValueError(case)


CASES = ["noise", "planted", "straddle", "after_packet", "cut_packet",
         "init_register", "short", "tiny", "empty"]


def _want(hard, mode, init, force_numpy):
    """The host FSM and `StreamDeframer.consume`'s tail rule -> (positions,
    cut, the carried bit buffer)."""
    uw, _, syms = _params(mode)
    nuw = len(uw)
    init = np.zeros(nuw, np.int8) if init is None else init
    pos, stale = deframe.uw_detect_positions(hard, mode, init,
                                             force_numpy=force_numpy)
    n = len(hard)
    if len(pos):
        return pos, int(pos[-1]) + syms + 1, stale
    if n > syms + nuw:
        cut = n - syms - nuw
        state = (hard[cut - nuw: cut] if cut >= nuw else np.concatenate(
            [init[cut - nuw:], hard[:cut]]))
        return pos, cut, state.astype(np.int8)
    return pos, 0, init


def _register(bits) -> int:
    return sum(int(b) << (len(bits) - 1 - i) for i, b in enumerate(bits))


def _lane_call(cases, mode, detect):
    """The cases as the lanes of one acquisition call -> [(positions, cut,
    bit buffer)] a lane, read from its meta and positions."""
    nuw = len(_params(mode)[0])
    streams = [_case(c, mode) for c in cases]
    soft = np.concatenate([1.0 - 2.0 * h.astype(np.float32)
                           for h, _ in streams] + [np.ones(1, np.float32)])
    n = np.array([len(h) for h, _ in streams], np.int64)
    cap = deframe.lane_capacity(n, mode)
    lanes = np.stack([np.cumsum(n) - n, n, np.cumsum(cap) - cap, cap], 1)
    init = np.zeros((len(cases), 4), np.int64)
    for i, (_, b) in enumerate(streams):
        reg = 0 if b is None else _register(b)
        init[i, 2:] = reg & 0xFFFFFFFF, reg >> 32
    meta, pos = detect(torch.from_numpy(soft), torch.from_numpy(lanes),
                       torch.from_numpy(init.astype(np.uint32).view(
                           np.int32)), int(n.max()))
    meta, pos = meta.cpu().numpy(), pos.cpu().numpy()
    out = []
    for i in range(len(cases)):
        c = int(meta[i, 0])
        assert c <= cap[i]
        reg = (int(meta[i, 2]) & 0xFFFFFFFF) | (
            (int(meta[i, 3]) & 0xFFFFFFFF) << 32)
        out.append((pos[lanes[i, 2]: lanes[i, 2] + c].astype(np.int64),
                    int(meta[i, 1]), deframe.register_bits(reg, nuw)))
    return out, streams


def _check_lanes(got, streams, mode, force_numpy):
    for (pos, cut, state), (hard, init) in zip(got, streams):
        want_p, want_cut, want_state = _want(hard, mode, init, force_numpy)
        np.testing.assert_array_equal(pos, want_p)
        assert cut == want_cut
        np.testing.assert_array_equal(state, want_state)


@pytest.mark.parametrize("fsm", ["numpy", "c"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_plain_acquisition_is_the_host_fsm(mode, case, fsm):
    if fsm == "c" and not native.available():
        pytest.skip("no C compiler for the C FSM")

    def plain(soft, lanes, init, n_max):
        return deframe.uw_detect_lanes_reference(soft, lanes, init, mode)
    got, streams = _lane_call(["noise", case, "planted"], mode, plain)
    _check_lanes(got, streams, mode, fsm == "numpy")
    if case in ("planted", "straddle", "after_packet", "cut_packet",
                "init_register"):
        assert len(got[1][0]) >= (1 if case in ("straddle", "cut_packet")
                                  else 3)
    if case == "straddle":         # found in the first mixed windows
        assert got[1][0][0] < len(_params(mode)[0]) - 1
    if case == "after_packet":     # every packet followed by a mixed hit
        uw, _, syms = _params(mode)
        gaps = np.diff(got[1][0]) - syms - 1
        assert (gaps < len(uw) - 1).all() and len(gaps) >= 3


def _stream(mode, n_packets, sigma, seed):
    """Framed packets between random idle bits, as noisy soft symbols."""
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 2, 700).astype(np.uint8)]
    for _ in range(n_packets):
        parts.append(_frame(mode, rng))
        parts.append(rng.integers(0, 2, int(rng.integers(0, 400))
                                  ).astype(np.uint8))
    bits = np.concatenate(parts)
    return ((1.0 - 2.0 * bits) + rng.normal(0, sigma, bits.shape)).astype(
        np.float32)


PUSHES = 10


def _pushes(n, seed):
    """PUSHES uneven push boundaries over n symbols, one push empty and one
    (where the draw leaves room) shorter than a UW."""
    rng = np.random.default_rng(seed)
    c = sorted(int(x) for x in rng.choice(np.arange(1, n - 8), PUSHES - 3,
                                          replace=False))
    return [0] + sorted(c + [c[1], c[2] + 7]) + [n]


def _lane_results(dec, lanes, mode):
    """One push of a LaneDeframer, from `decode` to `consume` -> (payloads,
    positions, CRC flags) a lane."""
    host = dec[0].cpu().numpy()
    L = lanes.lanes
    counts = host[: 16 * L].view(np.int32).reshape(L, 4)[:, 0]
    rows = host[16 * L:].reshape(-1, deframe.ROW_BYTES)
    pb, ok, pos = deframe.unpack_decode_results(rows[: counts.sum()])
    got, _ = lanes.consume(dec)
    cuts = np.cumsum(counts)[:-1]
    return got, np.split(pos, cuts), np.split(ok, cuts)


def _compare_pushes(mode, device):
    """Two lanes of chunked soft streams through a LaneDeframer on
    `device` and a StreamDeframer a lane on the CPU, push by push."""
    streams = [_stream(mode, 5, 0.5, 3), _stream(mode, 4, 0.55, 4)]
    lanes = deframe.LaneDeframer(mode, 2, device=device)
    hosts = [deframe.StreamDeframer(mode, device="cpu") for _ in streams]
    cuts = [_pushes(len(s), 9 + i) for i, s in enumerate(streams)]
    total = 0
    for k in range(len(cuts[0]) - 1):
        chunks = [s[c[k]: c[k + 1]] for s, c in zip(streams, cuts)]
        got, pos, ok = _lane_results(lanes.decode(
            [torch.from_numpy(c).to(device) for c in chunks]), lanes, mode)
        for i, (d, c) in enumerate(zip(hosts, chunks)):
            hard, want_p, stale = d.detect(c)
            pkts, want_ok = d.decode(want_p)
            want = d.consume(hard, want_p, stale, pkts, want_ok)
            assert got[i] == want, (k, i)
            np.testing.assert_array_equal(pos[i], want_p)
            np.testing.assert_array_equal(ok[i], want_ok)
            np.testing.assert_array_equal(lanes.tail(i).cpu().numpy(),
                                          d._buf)
            np.testing.assert_array_equal(lanes.state(i), d._state)
            assert lanes.n_detections[i] == d.n_detections
            assert lanes.n_crc_ok[i] == d.n_crc_ok
            total += len(want)
    whole = sum(len(deframe.deframe_soft(s, mode, device="cpu").payloads)
                for s in streams)
    assert total == whole >= 7
    return lanes


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_plain_card_path_is_the_stream_deframer(mode):
    lanes = _compare_pushes(mode, "cpu")
    assert lanes.waits == 0


@functools.lru_cache(maxsize=None)
def _capture(mode, cfg=None, seconds=2.5):
    cfg = fsk.FSKConfig(**GEOM[mode]) if cfg is None else cfg
    raw, n = pp_breakdown.capture(mode, seconds, cfg=cfg)
    return cfg, raw, n


MAX_ITER = 10          # the receivers' default


def _host_path(rx):
    """The receiver's deframe on the host path (a StreamDeframer a lane)."""
    rx._lanes = None
    rx.deframers = [deframe.StreamDeframer(rx.mode, MAX_ITER,
                                           device=rx.device,
                                           clocks=rx.seconds)
                    for _ in rx._stats]
    return rx


def _card_path(rx):
    """The receiver's deframe on the card path (`LaneDeframer`)."""
    rx._lanes = deframe.LaneDeframer(rx.mode, len(rx._stats), MAX_ITER,
                                     rx.device, rx.seconds)
    rx.deframers = []
    return rx


def _stats_rows(rx):
    return [vars(s).copy() for s in rx._stats]


def _run_pushes(rx, raw, step):
    """Each push's (results, the lanes' stats, bp_windows), the flush's
    last."""
    out = []
    for i in range(0, len(raw), step):
        out.append((rx.push(raw[i:i + step]), _stats_rows(rx),
                    list(rx.bp_windows)))
    out.append((rx.flush(), _stats_rows(rx), list(rx.bp_windows)))
    return out


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_receiver_on_the_card_path_equals_the_host_path(mode, pipelined):
    """The core's card path, run by its plain versions, against its host
    path: every push's payloads, stats and candidate counts."""
    cfg, raw, _ = _capture(mode)
    step = pp_breakdown.push_size(cfg, 0.7, "cu8")
    runs = []
    for path in (_host_path, _card_path):
        rx = path(pipeline.Receiver(mode=mode, cfg=cfg, input_format="cu8",
                                    pipelined=pipelined, with_eye=True,
                                    device="cpu"))
        runs.append(_run_pushes(rx, raw, step))
        assert rx.waits == 0               # no card
    assert runs[0] == runs[1]
    assert sum(len(p) for p, _, _ in runs[0]) >= 4


def test_kernel_wrappers_take_only_cuda_tensors():
    """On the CPU the acquisition and window wrappers raise and launch
    nothing; `uw_detect_lanes` takes the plain version for CPU tensors."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.kernels import uw_detect as kuw
    soft = torch.ones(5000)
    lanes = torch.tensor([[0, 5000, 0, 3]])
    init = torch.zeros((1, 4), dtype=torch.int32)
    meta = torch.zeros((1, 4), dtype=torch.int32)
    pos = torch.zeros(3, dtype=torch.int32)
    before = (kuw.launches, ktopk.window_launches)
    with pytest.raises(ValueError):
        kuw.detect(soft, lanes, init, meta, pos, "v2", 5000)
    with pytest.raises(ValueError):
        ktopk.fsm_llrs(soft, lanes, pos, meta, "v2", 3)
    deframe.uw_detect_lanes(soft, lanes, init, meta, pos, "v2", 5000)
    assert (kuw.launches, ktopk.window_launches) == before
    assert meta.tolist() == [[0, 5000 - 2584 - 32, 0, 0]]


# ------------------------------------------------------------- on the card


def _card():
    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_kernel_is_the_c_fsm(mode, case):
    """The acquisition kernel bit for bit the C FSM and the tail rule, and
    its meta and positions those of its plain version, three lanes a call
    (the case in the middle)."""
    dev = _card()
    from wenet_tpu_torch.kernels import uw_detect as kuw

    def kernel(soft, lanes, init, n_max):
        L = lanes.shape[0]
        rows = int(lanes[:, 3].sum())
        meta = torch.full((L, 4), -7, dtype=torch.int32, device=dev)
        pos = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        kuw.detect(soft.to(dev), lanes.to(dev), init.to(dev), meta, pos,
                   mode, n_max)
        torch.cuda.synchronize()
        return meta, pos

    def plain(soft, lanes, init, n_max):
        return deframe.uw_detect_lanes_reference(soft, lanes, init, mode)
    before = kuw.launches
    got, streams = _lane_call(["noise", case, "planted"], mode, kernel)
    assert kuw.launches == before + 1
    _check_lanes(got, streams, mode, force_numpy=False)
    want, _ = _lane_call(["noise", case, "planted"], mode, plain)
    for (p, c, s), (wp, wc, ws) in zip(got, want):
        np.testing.assert_array_equal(p, wp)
        assert c == wc
        np.testing.assert_array_equal(s, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_card_path_is_the_stream_deframer(mode):
    dev = _card()
    lanes = _compare_pushes(mode, dev)
    assert lanes.waits == PUSHES


def _flight_raw(mode, seconds=7.0):
    cfg = pipeline.MODE_CONFIGS[mode]
    _, raw, n = _capture(mode, cfg, seconds)
    return cfg, raw, n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_receiver_card_path_equals_host_path_on_the_card(mode):
    """`Receiver` (cu8, the eye probe on) at the flight geometry: each
    push's payloads, RxStats and bp_windows on the card path equal the
    host path's on the card; the kernels launched; two waits a push."""
    dev = _card()
    from wenet_tpu_torch.kernels import bp_decode
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.kernels import uw_detect as kuw
    cfg, raw, n_pkts = _flight_raw(mode)
    step = pp_breakdown.push_size(cfg, 2.0, "cu8")
    runs = []
    for path in (_host_path, _card_path):
        rx = path(pipeline.Receiver(mode=mode, input_format="cu8",
                                    with_eye=True, device=dev))
        counts = (kuw.launches, ktopk.window_launches, bp_decode.launches)
        runs.append(_run_pushes(rx, raw, step))
        moved = [a - b for a, b in zip((kuw.launches, ktopk.window_launches,
                                        bp_decode.launches), counts)]
        pushes = len(runs[-1]) - 1
        if path is _card_path:
            assert moved == [pushes] * 3
            assert rx.waits == 2 * pushes
        else:
            assert moved[:2] == [0, 0]
    assert runs[0] == runs[1]
    assert sum(len(p) for p, _, _ in runs[0]) >= n_pkts - 2


@pytest.mark.cuda
def test_wideband_card_path_equals_host_path_on_the_card():
    """`WidebandReceiver` (8 lanes, c64) at the flight geometry: each
    push's pairs, the lanes' RxStats and bp_windows on the card path equal
    the host path's on the card; one acquisition launch a push."""
    dev = _card()
    from wenet_tpu_torch.kernels import uw_detect as kuw
    cfg = pipeline.MODE_CONFIGS["v2"]
    wide, sent = channel.wideband_capture(cfg, 8, 4, 15.0, 5)
    step = len(wide) // 5 + 1
    runs = []
    for path in (_host_path, _card_path):
        rx = path(pipeline.WidebandReceiver("v2", 8, input_format="c64",
                                            device=dev))
        before = kuw.launches
        runs.append(_run_pushes(rx, wide, step))
        pushes = len(runs[-1]) - 1
        if path is _card_path:
            assert kuw.launches - before == pushes == rx.waits // 2
    assert runs[0] == runs[1]
    got = {}
    for pairs, _, _ in runs[0]:
        for k, p in pairs:
            got.setdefault(k, []).append(p)
    assert got == {k: v for k, v in sent.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_window_kernel_is_its_plain_version(mode):
    """The windows of three lanes' detections on the card: the live count
    and positions those of `fsm_windows_reference`, the LLRs within
    float32 rounding of its windows' `sd_to_llr`."""
    dev = _card()
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.kernels import uw_detect as kuw
    rng = np.random.default_rng(11)
    hards = [_case(c, mode)[0] for c in ("planted", "init_register",
                                          "after_packet")]
    soft = np.concatenate([1.0 - 2.0 * h + rng.normal(0, 0.3, len(h))
                           for h in hards]).astype(np.float32)
    n = np.array([len(h) for h in hards], np.int64)
    cap = deframe.lane_capacity(n, mode)
    lanes = torch.as_tensor(np.stack([np.cumsum(n) - n, n,
                                      np.cumsum(cap) - cap, cap], 1))
    rows = int(cap.sum())
    soft_d, lanes_d = torch.from_numpy(soft).to(dev), lanes.to(dev)
    meta = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    pos = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    kuw.detect(soft_d, lanes_d, meta, meta, pos, mode, int(n.max()))
    before = ktopk.window_launches
    llr, pos_out, n_live = ktopk.fsm_llrs(soft_d, lanes_d, pos, meta, mode,
                                          rows)
    assert ktopk.window_launches == before + 1
    sd, want_pos = deframe.fsm_windows_reference(
        torch.from_numpy(soft), lanes, pos.cpu(), meta.cpu(), mode)
    live = int(n_live)
    assert 0 < live == len(sd) < rows
    assert torch.equal(pos_out[:live].cpu(), want_pos)
    want = ldpc.sd_to_llr(sd)
    rel = ((llr[:live].cpu() - want).abs()
           / want.abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0, 1, 37, 64])
def test_bp_kernel_decodes_the_live_rows_alone(live):
    """bp_decode with a live count on the card: its first rows equal a
    decode of those rows alone; the CRC kernel writes its rows into a
    view of a larger buffer and nothing around it."""
    dev = _card()
    from wenet_tpu_torch.kernels import bp_decode
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    rng = np.random.default_rng(live)
    sd = (1.0 - 2.0 * rng.integers(0, 2, (64, 2580))
          + rng.normal(0, 0.6, (64, 2580))).astype(np.float32)
    llr = ldpc.sd_to_llr(torch.from_numpy(sd).to(dev))
    n = torch.tensor([live], dtype=torch.int32, device=dev)
    bits, iters, ok = bp_decode.decode(llr, live=n)
    want = bp_decode.decode(llr[:max(live, 1)].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(bits[:live], want[0][:live])
    assert torch.equal(iters[:live], want[1][:live])
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    buf = torch.zeros(16 + 64 * 263, dtype=torch.uint8, device=dev)
    rows = kcrc.pack(bits, positions=pos, out=buf[16:].view(64, 263))
    assert rows.data_ptr() == buf.data_ptr() + 16
    if live:
        assert torch.equal(buf[16:].view(64, 263)[:live],
                           kcrc.pack(want[0][:live].contiguous(),
                                     positions=pos[:live].contiguous()))
    assert not buf[:16].any()
