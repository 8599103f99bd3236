"""The readers of the program's stage spans on hand-built traces: spans
clipped to the window and divided by the window's pushes, no number where
the spans are absent, and the idle time no span explains on a planted
gap."""
import pytest

from benchmark import devtrace, harness, spans

READERS = {name: harness.load_module("metrics", name) for name in (
    "rx_ingest_ms_per_push", "demod_wait_ms_per_push",
    "rx_fetch_ms_per_push", "uw_fsm_ms_per_push", "bp_batch_ms_per_push",
    "idle_outside_spans_pct")}


def _run(device, host, window, pushes):
    run = harness.Run(None, window[1] - window[0])
    run.trace = devtrace.Trace(device, host, window)
    run.calls = [(0.0, 0.0, 1)] * pushes
    return run


def _push(t0):
    """One push's host events from t0: a timed call holding the eleven
    leaves one after another (each 1 s but rx.launch, 3 s, and
    deframe.bp, 2 s), with the benchmark's taps inside three of them."""
    host, t = [], t0
    for name in spans.LEAVES:
        d = {"rx.launch": 3.0, "deframe.bp": 2.0}.get(name, 1.0)
        host.append((name, t, t + d))
        t += d
    host.append((devtrace.CALL_SPAN, t0, t + 0.5))
    host += [("ops.fsk.demod_raw", t0 + 2.5, t0 + 4.0),
             ("ops.deframe.uw_detect_positions", t0 + 9.2, t0 + 9.8),
             ("ops.deframe.decode_candidates", t0 + 10.0, t0 + 13.0)]
    return host, t + 0.5


def test_the_leaves_are_the_programs():
    from wenet_tpu_torch.rx import pipeline
    assert spans.LEAVES == pipeline.DEMOD_STAGES + pipeline.DEFRAME_STAGES


def test_spans_summed_in_the_window_over_the_pushes():
    first, end = _push(0.0)
    second, end = _push(end)            # a push of 14.5 s, from 14.5
    host = first + second
    run = _run([], host, (0.0, end), 2)
    got = {n: r.read(run) for n, r in READERS.items() if "ms" in n}
    assert got == {"rx_ingest_ms_per_push": pytest.approx(5e3),
                   "demod_wait_ms_per_push": pytest.approx(2e3),
                   "rx_fetch_ms_per_push": pytest.approx(1e3),
                   "uw_fsm_ms_per_push": pytest.approx(3e3),
                   "bp_batch_ms_per_push": pytest.approx(3e3)}
    # the five add up to the push's leaves: 14 s of its 14.5
    assert sum(got.values()) == pytest.approx(14e3)
    # a window that starts 0.5 s into rx.buffer and ends 0.5 s into the
    # second push's rx.copy_in clips both
    run = _run([], host, (0.5, 14.5 + 1.5), 1)
    assert READERS["rx_ingest_ms_per_push"].read(run) == pytest.approx(
        (0.5 + 1 + 3 + 1 + 0.5) * 1e3)
    assert READERS["rx_fetch_ms_per_push"].read(run) == pytest.approx(1e3)


def test_no_number_without_the_spans():
    """The parent program, or a span renamed: the taps and the call are
    there, the leaves not, and every reader gives None, never 0."""
    host, _ = _push(0.0)
    taps_only = [h for h in host if h[0] not in spans.LEAVES]
    run = _run([("k", 0.0, 1.0)], taps_only, (0.0, 14.5), 1)
    assert {n: r.read(run) for n, r in READERS.items()} == dict.fromkeys(
        READERS)
    # leaves wholly outside the window count as absent
    run = _run([("k", 0.0, 1.0)], host, (20.0, 30.0), 1)
    assert {n: r.read(run) for n, r in READERS.items()} == dict.fromkeys(
        READERS)
    # an untraced run has no trace
    run = harness.Run(None, 10.0)
    run.calls = [(0.0, 1.0, 1)]
    assert {n: r.read(run) for n, r in READERS.items()} == dict.fromkeys(
        READERS)


def test_idle_outside_the_spans_on_a_planted_gap():
    host, _ = _push(0.0)                 # leaves end at 14.0, the call 14.5
    # the device busy but for three gaps: 1.2-1.8 inside rx.copy_in
    # (credited to it), 14.0-14.5 after the last leaf but inside the call
    # (outside the spans), 14.5-15.0 between calls
    device = [("k", 0.0, 1.2), ("k", 1.8, 14.0), ("k", 15.0, 20.0)]
    run = _run(device, host, (0.0, 20.0), 1)
    assert READERS["idle_outside_spans_pct"].read(run) == pytest.approx(
        100 * 0.5 / 20.0)
    idle = dict(run.trace.idle_by_host(spans.LEAVES, top=13))
    assert idle == {"rx.copy_in": pytest.approx(0.6),
                    spans.OUTSIDE: pytest.approx(0.5),
                    "host: between calls": pytest.approx(0.5)}
    # an idle gap that the leaves cover wholly leaves nothing outside
    device = [("k", 0.0, 1.2), ("k", 1.8, 20.0)]
    run = _run(device, host, (0.0, 20.0), 1)
    assert READERS["idle_outside_spans_pct"].read(run) == 0.0
    # the benchmark's taps are no leaves: given only them, the same gap
    # counts as outside the traced functions
    assert dict(run.trace.idle_by_host(
        ["ops.fsk.demod_raw"]))[spans.OUTSIDE] == pytest.approx(0.6)
