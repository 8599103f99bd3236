"""The streaming wideband receiver (`rx.pipeline.WidebandReceiver`) and
its streaming channelizer (`ops.channelizer.StreamingChannelizer`) on the
CPU, at the scaled geometry of tests/test_torch_channelizer.py
(FSKConfig(Fs=96000, Rs=9600), 8 channels, a 768-kHz band).

- The streaming channelizer over a band cut into 1, 3 or 7 pushes (some
  not a multiple of N, one shorter than a frame) equals the plain version
  over the whole band within 1e-6 of its rms (the CPU's sums may block
  differently with the length; on a card the kernel's frames are bit for
  bit, the `cuda` cases).
- The port's channelizer against the benchmark's float64 reference
  (`benchmark/reference_wideband.py`, the definition's sum) within 1e-5 of
  its rms, whole and in pieces.
- Each lane's demod frames equal a single-channel `Receiver` (c64) fed
  that channel's samples in the same pushes; the payloads, by channel,
  equal `demod_multichannel` on the whole capture (c64 and cu8, a
  selection with a negative index) and the JAX package's.
- `rx --channels 8` reading a pipe-like stdin chunk by chunk routes the
  whole-capture path's payloads.
- The stage clocks sum to the receiver's "demod" and "deframe" totals, and
  under a CPU profiler each leaf is a range once a push.

This file imports no JAX at its top (the JAX comparison imports it in its
test), so on a machine with the card the `cuda` cases run with
`python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_wideband_receiver.py`; they skip here.
"""
import functools
import io
import sys

import numpy as np
import pytest
import torch

from benchmark import reference_wideband
from wenet_tpu_torch import kernels
from wenet_tpu_torch.ops import channel, channelizer, fsk
from wenet_tpu_torch.rx import pipeline

torch.set_num_threads(1)

GEOM = dict(Fs=96000, Rs=9600)
N = 8
T = 12


def _cfg():
    return fsk.FSKConfig(**GEOM)


@functools.lru_cache(maxsize=None)
def _capture():
    """(complex64 band, {channel: [payloads]}): 3 packets a channel at
    20 dB, every channel busy (`ops.channel.wideband_capture`)."""
    return channel.wideband_capture(_cfg(), N, 3, 20.0, 11)


@functools.lru_cache(maxsize=None)
def _capture_cu8():
    wide, sent = _capture()
    return fsk.iq_to_cu8(wide), sent


def _splits(n: int, pushes: int) -> list:
    """Push boundaries of n samples: uneven, not multiples of N, and for
    7 pushes one push shorter than a frame."""
    if pushes == 1:
        return [0, n]
    rng = np.random.default_rng(pushes)
    cuts = sorted(int(c) for c in rng.choice(np.arange(1, n), pushes - 1,
                                             replace=False))
    if pushes == 7:
        cuts[3] = cuts[2] + 5
    return [0] + cuts + [n]


def _rel(got, want) -> float:
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    return float(np.abs(got - want).max() / rms)


def _pairs(x, fmt):
    if fmt == "cu8":
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.view_as_real(torch.from_numpy(np.ascontiguousarray(x)))


def _stream(x, fmt, pushes, channels=None, device="cpu"):
    """The streaming channelizer's frames over the pushes -> (Nsel, F)
    complex64 numpy, and the frames each push gave."""
    sc = channelizer.StreamingChannelizer(N, channels, fmt)
    w = 2 if fmt == "cu8" else 1
    cuts = _splits(len(x) // w, pushes)
    outs = [sc.push(_pairs(x[w * a: w * b], fmt).to(device))
            for a, b in zip(cuts, cuts[1:])]
    out = torch.cat(outs, dim=1).cpu()
    return torch.view_as_complex(out.contiguous()).numpy(), [
        o.shape[1] for o in outs]


@pytest.mark.parametrize("fmt", ["c64", "cu8"])
@pytest.mark.parametrize("pushes", [1, 3, 7])
def test_streaming_channelizer_equals_the_whole_stream(pushes, fmt):
    x = _capture_cu8()[0] if fmt == "cu8" else _capture()[0]
    w = 2 if fmt == "cu8" else 1
    n = len(x) // w
    whole = channelizer.channelize_pairs(_pairs(x, fmt), N, T,
                                         input_format=fmt)
    whole = torch.view_as_complex(whole.reshape(N, -1, 2)).numpy()
    got, per_push = _stream(x, fmt, pushes)
    cuts = _splits(n, pushes)
    # each push gives the frames its last sample completes
    assert per_push == [b // N - a // N for a, b in zip(cuts, cuts[1:])]
    assert got.shape == whole.shape == (N, n // N)
    assert _rel(got, whole) <= 1e-6


@pytest.mark.parametrize("n_channels", [4, 8])
def test_channelizer_matches_the_float64_reference(n_channels):
    """The port's plain channelizer on a seeded Gaussian band against the
    benchmark's reference from the definition, whole and in three pieces
    (the reference's history argument)."""
    rng = np.random.default_rng(n_channels)
    n = 4000 * n_channels + 3
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * 0.3
    sel = [0, 1, n_channels - 1]
    got = channelizer.channelize(x, n_channels, T, sel, device="cpu").numpy()
    xt = torch.from_numpy(x)
    ref = reference_wideband.channelize(xt, n_channels, T, sel).numpy()
    assert _rel(got, ref) <= 1e-5
    F = n // n_channels
    parts, a = [], 0
    for b in (F // 3, 2 * F // 3 + 1, F):
        parts.append(reference_wideband.channelize(
            xt[a * n_channels: b * n_channels], n_channels, T, sel,
            history=xt[: a * n_channels]).numpy())
        a = b
    np.testing.assert_allclose(np.concatenate(parts, axis=1), ref,
                               rtol=0, atol=1e-12)
    # the control's precision is no longer within the bound
    ctl = reference_wideband.channelize(xt, n_channels, T, sel,
                                        precision="float16").numpy()
    assert _rel(ctl, ref) > 1e-4


def _wide_receiver(fmt="c64", channels=None, device="cpu"):
    return pipeline.WidebandReceiver("v2", N, channels, fmt, cfg=_cfg(),
                                     device=device)


def _push_all(rx, x, w, pushes):
    cuts = _splits(len(x) // w, pushes)
    got = []
    for a, b in zip(cuts, cuts[1:]):
        got += rx.push(x[w * a: w * b])
    return got + rx.flush()


def _by_channel(pairs) -> dict:
    out = {}
    for k, p in pairs:
        out.setdefault(k, []).append(p)
    return out


def _recorded_demods(monkeypatch):
    """Every demod_raw call's valid frames, as host arrays a lane."""
    calls = []
    demod = fsk.demod_raw

    def record(*args, **kwargs):
        res = demod(*args, **kwargs)
        outs = res[1]
        calls.append([{k: getattr(outs, k)[i][outs.valid[i]].cpu().numpy()
                       for k in ("soft", "nin", "f_est")}
                      for i in range(outs.valid.shape[0])])
        return res
    monkeypatch.setattr(fsk, "demod_raw", record)
    return calls


def _lanes_and_receivers(monkeypatch, device):
    """(per lane, the wideband receiver's frames; the same from a Receiver
    a channel fed the streaming channelizer's samples of each push)."""
    wide, _ = _capture()
    calls = _recorded_demods(monkeypatch)
    rx = _wide_receiver(device=device)
    sc = channelizer.StreamingChannelizer(N, None, "c64")
    cuts = _splits(len(wide), 3)
    rxs = [pipeline.Receiver("v2", cfg=_cfg(), device=device)
           for _ in range(N)]
    lane_frames = [[] for _ in range(N)]
    ref_frames = [[] for _ in range(N)]
    for a, b in zip(cuts, cuts[1:]):
        del calls[:]
        rx.push(wide[a:b])
        for i in range(N):
            lane_frames[i].append(calls[0][i])
        chans = torch.view_as_complex(sc.push(_pairs(wide[a:b], "c64").to(
            device)).contiguous()).cpu().numpy()
        for i in range(N):
            del calls[:]
            rxs[i].push(chans[i])
            ref_frames[i] += [c[0] for c in calls]
    rx.flush()                 # the last push's host half
    return lane_frames, ref_frames, rx, rxs


def _joined(frames: list) -> dict:
    return {k: np.concatenate([f[k] for f in frames]) for k in
            ("soft", "nin", "f_est")}


def test_lanes_equal_single_channel_receivers(monkeypatch):
    lanes, refs, rx, rxs = _lanes_and_receivers(monkeypatch, "cpu")
    for i in range(N):
        got, want = _joined(lanes[i]), _joined(refs[i])
        assert len(got["nin"]) > 150
        np.testing.assert_array_equal(got["nin"], want["nin"])
        np.testing.assert_array_equal(got["f_est"], want["f_est"])
        scale = np.abs(want["soft"]).mean()
        assert np.abs(got["soft"] - want["soft"]).max() <= 1e-5 * scale
        assert rx.stats[i].frames == rxs[i].stats.frames == len(got["nin"])


def test_eye_probe_and_stats_a_lane_equal_a_receivers():
    """with_eye: each lane's last valid frame's probe and its stats equal
    those of a with_eye `Receiver` (c64) fed the lane's channel samples."""
    wide, _ = _capture()
    sel = [1, 6]
    rx = pipeline.WidebandReceiver("v2", N, sel, "c64", with_eye=True,
                                   cfg=_cfg(), device="cpu")
    sc = channelizer.StreamingChannelizer(N, sel, "c64")
    rxs = [pipeline.Receiver("v2", cfg=_cfg(), with_eye=True, device="cpu")
           for _ in sel]
    cuts = _splits(len(wide), 3)
    for a, b in zip(cuts, cuts[1:]):
        rx.push(wide[a:b])
        chans = torch.view_as_complex(sc.push(_pairs(
            wide[a:b], "c64")).contiguous()).numpy()
        for i, r in enumerate(rxs):
            r.push(chans[i])
    rx.flush()                 # the last push's host half
    for i, r in enumerate(rxs):
        got, want = rx.last_eye[i], r.last_eye
        assert got[1] == want[1]
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=1e-5 * np.abs(want[0]).max())
        for f in ("frames", "samples", "detections", "crc_ok"):
            assert getattr(rx.stats[i], f) == getattr(r.stats, f), f
        assert rx.stats[i].f_est == r.stats.f_est


@pytest.mark.parametrize("fmt,channels", [("c64", None), ("cu8", None),
                                          ("c64", [-1, 2, 5])],
                         ids=["c64", "cu8", "selection"])
def test_payloads_equal_the_whole_capture(fmt, channels):
    x, sent = _capture_cu8() if fmt == "cu8" else _capture()
    w = 2 if fmt == "cu8" else 1
    want = channelizer.demod_multichannel(
        x, N * GEOM["Fs"], N, _cfg(), channels=channels, device="cpu",
        input_format=fmt)
    rx = _wide_receiver(fmt, channels)
    pairs = _push_all(rx, x, w, 7)
    got = _by_channel(pairs)
    assert got == {k: v for k, v in want.items() if v}
    assert all(len(v) == 3 for v in want.values())
    sel = channels if channels is not None else range(N)
    assert [s.crc_ok for s in rx.stats] == [len(want[k]) for k in sel]
    assert rx.bp_windows == [s.detections for s in rx.stats]


def test_payloads_equal_the_jax_package():
    """The JAX package's whole-capture `demod_multichannel` on the same
    band, channels 2 and 5."""
    pytest.importorskip("jax")
    from wenet_tpu.ops import channelizer as jch
    from wenet_tpu.ops import fsk as jfsk
    wide, sent = _capture()
    want = jch.demod_multichannel(wide, N * GEOM["Fs"], N,
                                  jfsk.FSKConfig(**GEOM), channels=[2, 5])
    rx = _wide_receiver("c64", [2, 5])
    got = _by_channel(_push_all(rx, wide, 1, 3))
    assert got == want == {k: sent[k] for k in (2, 5)}


def test_each_push_returns_channel_order():
    wide, _ = _capture()
    rx = _wide_receiver("c64", [5, -1, 2])
    cuts = _splits(len(wide), 3)
    for a, b in zip(cuts, cuts[1:]):
        keys = [k for k, _ in rx.push(wide[a:b])]
        assert keys == sorted(keys)


def test_cli_streams_the_wideband_mode(tmp_path, monkeypatch, capsys):
    """`rx - --format cu8 --channels 8` on a stdin stream read in chunks of
    0.3 s of the band: the payloads routed are the whole-capture path's,
    in channel order within each chunk."""
    from wenet_tpu_torch.cli import rx as cli
    from wenet_tpu_torch.rx import router
    raw, _ = _capture_cu8()
    want = channelizer.demod_multichannel(raw, N * GEOM["Fs"], N, _cfg(),
                                          device="cpu", input_format="cu8")
    routed = []
    monkeypatch.setattr(router.PacketRouter, "handle_packet",
                        lambda self, p: routed.append(p))
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(
        raw.tobytes())))
    pushes = []
    push = pipeline.WidebandReceiver.push
    monkeypatch.setattr(pipeline.WidebandReceiver, "push",
                        lambda self, c: pushes.append(len(c)) or push(self,
                                                                      c))
    assert cli.main(["-", "--format", "cu8", "--mode", "v2", "--channels",
                     "8", "--fs", "96000", "--rs", "9600", "--device", "cpu",
                     "--no-udp", "--chunk-seconds", "0.3", "--image-dir",
                     str(tmp_path / "img")]) == 0
    assert len(pushes) == -(-len(raw) // (2 * 230400))
    assert sorted(routed) == sorted(p for v in want.values() for p in v)
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert line.startswith(f"wideband: 8 channels, {len(routed)} packets, ")


def test_stage_clocks_sum_to_the_totals():
    from torch.profiler import ProfilerActivity, profile
    wide, _ = _capture()
    rx = _wide_receiver()
    cuts = _splits(len(wide), 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for a, b in zip(cuts, cuts[1:]):
            rx.push(wide[a:b])
        rx.flush()
    s = rx.seconds
    demod = sum(s[k] for k in pipeline.WIDEBAND_DEMOD_STAGES)
    deframe = sum(s[k] for k in pipeline.DEFRAME_STAGES)
    assert demod == pytest.approx(s["demod"], rel=1e-9)
    assert deframe == pytest.approx(s["deframe"], rel=1e-9)
    assert all(s[k] > 0 for k in pipeline.WIDEBAND_DEMOD_STAGES
               + pipeline.DEFRAME_STAGES)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("rx.channelize") == 3
    assert names.count("rx.fetch") == 3
    # the deframe leaves run once a lane, the decode batch once a push
    assert names.count("deframe.fsm") == 3 * N
    assert names.count("deframe.bp") == 3


# ------------------------------------------------------------- on the card


def _card():
    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["c64", "cu8"])
@pytest.mark.parametrize("pushes", [3, 7])
def test_streaming_channelizer_is_the_whole_kernel_bit_for_bit(pushes, fmt):
    dev = _card()
    x = _capture_cu8()[0] if fmt == "cu8" else _capture()[0]
    whole = channelizer.channelize_pairs(_pairs(x, fmt).to(dev), N, T,
                                         input_format=fmt)
    whole = torch.view_as_complex(whole.reshape(N, -1, 2)).cpu().numpy()
    got, _ = _stream(x, fmt, pushes, device=dev)
    np.testing.assert_array_equal(got, whole)


@pytest.mark.cuda
def test_lanes_are_single_channel_receivers_bit_for_bit(monkeypatch):
    dev = _card()
    lanes, refs, rx, rxs = _lanes_and_receivers(monkeypatch, dev)
    for i in range(N):
        got, want = _joined(lanes[i]), _joined(refs[i])
        assert len(got["nin"]) > 150
        for k in ("soft", "nin", "f_est"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
