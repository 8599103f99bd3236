"""The wideband cell (`wideband_v2_n8`) on the CPU at a small size, with
the program's plain versions of its kernels: a sound run is correct;
`correct` comes out false for the control (the reference channelizer at
float16 samples and taps) and for each fault planted under the timed
path (one lane's carried history short by a sample, two channels
swapped); the band generator and the reference load nothing of the
program; the new readers on hand-built traces."""
import subprocess
import sys

import numpy as np
import pytest

from benchmark import devtrace, harness, traffic, traffic_wideband
from benchmark.tests.conftest import ROOT

CELL = "wideband_v2_n8"
SIZE = {"recording_s": 0.3, "push_s": 0.1, "warm_pushes": 2,
        "check": {"block_pushes": 2, "block_start_max": 2, "lanes": 3}}
SEED = 2 ** 31 + 77
V2 = traffic.Deployment("v2_wideband8", "v2", 960000, 96000, 2, 48,
                        (192000, 288000), 10)


def run(control=False, trace=False):
    return harness.run_cell(CELL, SEED, 0.5, trace, device="cpu",
                            overrides=SIZE, control=control)


def failing(out) -> list:
    return [k for k, v, lim in out["checks"] if not v <= lim]


def checked_lanes(seed: int) -> list:
    """The lanes the entry compares for a seed (its draws, in order)."""
    rng = np.random.default_rng([seed % 2 ** 63, 101])
    rng.integers(0, SIZE["check"]["block_start_max"])
    return sorted(int(k) for k in rng.choice(8, size=3, replace=False))


def test_sound_run_is_correct():
    out = run()
    assert out["result"]["correct"] is True, out["checks"]
    assert out["result"]["attempted"] >= 8
    assert set(out["result"]["metrics"]) == {"msps", "setup_s"}


def test_control_fails_the_channel_gap():
    out = run(control=True)
    assert out["result"]["correct"] is False
    assert failing(out) == ["chan_gap"]


def test_a_lane_history_short_by_a_sample_fails(monkeypatch):
    from wenet_tpu_torch.rx import pipeline
    retire = pipeline.WidebandReceiver._retire_state
    lane = checked_lanes(SEED)[0]

    def short(self, inflight):
        retire(self, inflight)
        self._c[lane] -= 1
    monkeypatch.setattr(pipeline.WidebandReceiver, "_retire_state", short)
    out = run()
    assert out["result"]["correct"] is False
    assert {"frames_differ", "soft_gap"} & set(failing(out))


def test_two_channels_swapped_fail(monkeypatch):
    from wenet_tpu_torch.ops import channelizer
    channelize = channelizer.channelize_pairs
    a, b = checked_lanes(SEED)[:2]

    def swapped(*args, **kwargs):
        out = channelize(*args, **kwargs)
        lanes = out.reshape(8, -1, 2).clone()
        lanes[[a, b]] = lanes[[b, a]]
        return lanes.reshape(-1, 2)
    monkeypatch.setattr(channelizer, "channelize_pairs", swapped)
    out = run()
    assert out["result"]["correct"] is False
    assert {"failed", "chan_gap"} <= set(failing(out))


def test_traced_run_reads_the_program_spans():
    out = run(trace=True)["result"]
    m = out["metrics"]
    assert out["correct"] is True
    assert m["wb_demod_wait_ms_per_push"]["value"] > 0
    assert m["wb_deframe_ms_per_push"]["value"] > 0
    assert 0 <= m["wb_device_idle_pct"]["value"] <= 100
    assert 0 <= m["wb_idle_outside_spans_pct"]["value"] <= \
        m["wb_device_idle_pct"]["value"]
    # no card: no peaks, no roofline
    assert "channelize_roofline_pct" not in m


def test_band_is_whole_frames_a_channel_and_repeats_from_its_seed():
    band = traffic_wideband.make_band(V2, 4, 0.1, 15.0, 2 ** 33 + 1, "cpu")
    n_packets = 9600 // V2.frame_bits
    assert band.n_samples == n_packets * V2.frame_bits * 4 * V2.Ts
    assert len(band.raw) == 2 * band.n_samples
    assert [len(p) for p in band.payloads] == [n_packets] * 4
    for ends in band.ends:
        assert np.all(np.diff(ends) == V2.frame_bits * 4 * V2.Ts)
        assert 0 < ends[0] and ends[-1] <= band.n_samples
    assert len({int(e[0]) for e in band.ends}) > 1     # rotated apart
    again = traffic_wideband.make_band(V2, 4, 0.1, 15.0, 2 ** 33 + 1, "cpu")
    assert np.array_equal(band.raw, again.raw)
    assert band.payloads == again.payloads


def test_band_channels_decode_with_the_port_in_a_loop():
    """Each channel of a small band replayed twice, decoded whole by the
    port's `demod_multichannel` (CPU), gives a run of its payloads in air
    order, each of them at least once (the loop's seam and the capture's
    ends cut at most a packet at each end)."""
    from wenet_tpu_torch.ops import channelizer, fsk
    band = traffic_wideband.make_band(V2, 8, 0.2, 15.0, 5, "cpu")
    raw = np.concatenate([band.raw, band.raw])
    got = channelizer.demod_multichannel(raw, 8 * V2.Fs, 8, fsk.V2_CONFIG,
                                         device="cpu", input_format="cu8")
    for k in range(8):
        P = len(band.payloads[k])
        seq = band.payloads[k] * 3
        assert len(got[k]) >= P and set(got[k]) == set(band.payloads[k])
        assert any(seq[j: j + len(got[k])] == got[k] for j in range(P)), k


def test_generator_and_reference_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.traffic_wideband, "
            "benchmark.reference_wideband;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'wenet_tpu_torch', 'wenet_tpu', 'jax', 'jaxlib', 'flax'}),"
            " benchmark.reference_wideband.torch.backends.cuda.matmul"
            ".allow_tf32)")
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[] False"


def test_channelize_work_is_the_smoke_bound():
    """The frozen work of a 2-s cu8 push's channelizer call: 8 channels of
    1.92 M frames, 12 taps a phase."""
    k = harness.load_module("kernels", "channelize")
    rec = {"n": 15_360_000, "N": 8, "T": 12, "nsel": 8, "fmt": "cu8"}
    F = 1_920_000
    assert k.work(rec, [0]) == (F * (8 * 12 * 4 + 8 * 8 * 8),
                                2 * 15_360_000 + 8 * 8 * F)


def test_wideband_span_readers():
    readers = {n: harness.load_module("metrics", n) for n in (
        "wb_demod_wait_ms_per_push", "wb_deframe_ms_per_push")}
    host = [("rx.channelize", 0.0, 1.0), ("rx.wait", 3.0, 5.0),
            ("rx.retire", 5.0, 5.5), ("rx.fetch", 5.5, 6.0),
            ("deframe.fsm", 6.0, 7.0), ("deframe.fsm", 7.0, 8.0),
            ("deframe.bp", 8.0, 9.0)]
    run = harness.Run(None, 10.0)
    run.trace = devtrace.Trace([], host, (0.0, 10.0))
    run.calls = [(0.0, 0.0, 1)] * 2
    assert readers["wb_demod_wait_ms_per_push"].read(run) == \
        pytest.approx(1250.0)
    assert readers["wb_deframe_ms_per_push"].read(run) == \
        pytest.approx(1750.0)
    run.trace = devtrace.Trace([], [], (0.0, 10.0))
    assert all(r.read(run) is None for r in readers.values())


def test_wideband_idle_outside_spans_counts_channelize_as_a_leaf():
    """An idle gap inside `rx.channelize` is the stage's, not unexplained;
    the flight cells' reader, without that leaf, counts it outside."""
    reader = harness.load_module("metrics", "wb_idle_outside_spans_pct")
    flight = harness.load_module("metrics", "idle_outside_spans_pct")
    host = [(devtrace.CALL_SPAN, 0.0, 10.0), ("rx.copy_in", 0.0, 1.0),
            ("rx.channelize", 1.0, 2.0), ("rx.launch", 2.0, 3.0),
            ("rx.wait", 3.0, 9.0)]
    # idle 1.2-1.8 (in rx.channelize) and 9.0-9.5 (after the last leaf)
    device = [("k", 0.0, 1.2), ("k", 1.8, 9.0), ("k", 9.5, 10.0)]
    run = harness.Run(None, 10.0)
    run.trace = devtrace.Trace(device, host, (0.0, 10.0))
    run.calls = [(0.0, 0.0, 1)]
    assert reader.read(run) == pytest.approx(100 * 0.5 / 10.0)
    assert flight.read(run) == pytest.approx(100 * 1.1 / 10.0)
    run.trace = devtrace.Trace(device, [], (0.0, 10.0))
    assert reader.read(run) is None


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    """On the card, at the cell's own size, over three seeds: the
    program's run is correct and the control's judgement of the same run
    fails `chan_gap`.  Prints both readings of every number compared."""
    bench = harness.spec()
    limits = harness.resolve(bench, CELL).traffic["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        out = harness.run_cell(CELL, seed, 3.0, False, device="cuda",
                               control=True, bench=bench)
        program = out["program"]["checks"]
        print(CELL, seed, "program", program, "control", out["checks"])
        assert all(program[k] <= lim for k, lim in limits.items())
        assert out["result"]["correct"] is False
        assert "chan_gap" in failing(out)
