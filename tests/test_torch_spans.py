"""The streaming Receiver's stage spans (`wenet_tpu_torch.utils.spans`) on
the CPU: under a CPU torch.profiler each leaf span appears once a
processed chunk, in the order a chunk meets them, with no two spans
overlapping, for the serial and the pipelined Receiver in v2 and v1; the
stage clocks sum to `seconds["demod"]` and `seconds["deframe"]`; payloads
are the same with the profiler on and off; with the profiler off no
`record_function` is entered.

Scaled geometries as in the other port tests, torch on one thread."""
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wenet_tpu_torch.ops import deframe, fsk
from wenet_tpu_torch.rx import pipeline
from wenet_tpu_torch.tools import captures, pp_breakdown
from wenet_tpu_torch.utils import spans

torch.set_num_threads(1)

GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}
LEAVES = pipeline.DEMOD_STAGES + pipeline.DEFRAME_STAGES
PUSH_S = 0.8


@functools.lru_cache(maxsize=None)
def _capture(mode):
    """(cfg, cu8 bytes, push size): about 2.5 s of packets at 12 dB."""
    cfg = fsk.FSKConfig(**GEOM[mode])
    raw, _ = pp_breakdown.capture(mode, 2.5, cfg=cfg)
    return cfg, raw, pp_breakdown.push_size(cfg, PUSH_S, "cu8")


def _run(mode, pipelined):
    """A Receiver over the capture -> (receiver, payloads, pushes)."""
    cfg, raw, step = _capture(mode)
    rx = pipeline.Receiver(mode=mode, cfg=cfg, input_format="cu8",
                           pipelined=pipelined, device="cpu")
    got = []
    for i in range(0, len(raw), step):
        got += rx.push(raw[i:i + step])
    return rx, got + rx.flush(), -(-len(raw) // step)


def _leaf_events(prof):
    """[(start ns, end ns, name)] of the leaves, in start order; read from
    the profiler's raw events (building its event tree over the CPU
    demod's many small ops takes tens of seconds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in LEAVES:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out)


def test_the_receiver_clocks_every_leaf():
    assert LEAVES == ("rx.buffer", "rx.copy_in", "rx.launch", "rx.wait",
                      "rx.retire", "rx.fetch", "deframe.detect",
                      "deframe.fsm", "deframe.gather", "deframe.bp",
                      "deframe.consume")
    rx = pipeline.Receiver(mode="v2", cfg=fsk.FSKConfig(**GEOM["v2"]),
                           device="cpu")
    assert set(rx.seconds) == {"demod", "deframe", *LEAVES}
    assert rx.deframer.seconds is rx.seconds


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_leaf_spans_tile_each_chunk(mode, pipelined):
    _, want, _ = _run(mode, pipelined)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, got, pushes = _run(mode, pipelined)
    assert got == want and len(got) >= 3
    events = _leaf_events(prof)
    chunks = pushes            # each push here completes a chunk
    by_name = {n: [(s, e) for s, e, m in events if m == n] for n in LEAVES}
    assert {n: len(v) for n, v in by_name.items()} == dict.fromkeys(
        LEAVES, chunks)
    # chunk k meets its leaves in the table's order
    for k in range(chunks):
        starts = [by_name[n][k][0] for n in LEAVES]
        assert starts == sorted(starts), (k, starts)
    # no two leaves overlap: each ends before the next one starts
    for (_, end, a), (start, _, b) in zip(events, events[1:]):
        assert end <= start, (a, b)
    if not pipelined:          # the table's order, chunk after chunk
        assert [n for _, _, n in events] == list(LEAVES) * chunks


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_stage_clocks_sum_to_the_totals(mode, pipelined):
    rx, got, _ = _run(mode, pipelined)
    s = rx.seconds
    demod = sum(s[k] for k in pipeline.DEMOD_STAGES)
    defr = sum(s[k] for k in pipeline.DEFRAME_STAGES)
    assert s["demod"] == pytest.approx(demod, rel=1e-9)
    assert s["deframe"] == pytest.approx(defr, rel=1e-9)
    assert all(s[k] > 0 for k in LEAVES if k != "rx.wait")
    assert len(got) >= 3


def _counting(real, entered):
    """A stand-in for a profiler range class that counts its entries."""
    class Counted:
        def __init__(self, name):
            self.inner = real(name)

        def __enter__(self):
            entered.append(1)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)
    return Counted


def test_profiler_off_enters_no_record_function(monkeypatch):
    """Neither the Python nor the C++ profiler range is entered while no
    profiler records; with one recording, each push enters the C++ range
    once a leaf."""
    python_ranges, fast_ranges = [], []
    monkeypatch.setattr(torch.profiler, "record_function", _counting(
        torch.profiler.record_function, python_ranges))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        _counting(torch._C._profiler._RecordFunctionFast,
                                  fast_ranges))
    _, off, pushes = _run("v2", False)
    assert python_ranges == fast_ranges == []
    with profile(activities=[ProfilerActivity.CPU]):
        _, on, _ = _run("v2", False)
    assert len(fast_ranges) == len(LEAVES) * pushes
    assert python_ranges == []
    assert on == off


def test_span_helper():
    clocks = {"a": 0.0, "b": 0.0, "total": 0.0}
    with spans.span("a", clocks, "total"):
        pass
    with pytest.raises(ValueError):
        with spans.span("b", clocks, "total"):
            raise ValueError
    assert clocks["a"] > 0 and clocks["b"] > 0
    assert clocks["total"] == clocks["a"] + clocks["b"]
    with spans.span("c", None, "total"):      # no clocks: nothing at all
        pass
    assert set(clocks) == {"a", "b", "total"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("a", clocks, "total"):
            torch.zeros(3).sum()
    assert [e.name for e in prof.events()].count("a") == 1


def test_stream_deframer_alone_keeps_its_own_clocks():
    """A StreamDeframer without a Receiver: its clocks, summed into
    "deframe", and its payloads those of one `deframe_soft` call."""
    rng = np.random.default_rng(5)
    cfg = fsk.FSKConfig(**GEOM["v2"])
    bits = captures.make_packet_bits(cfg, 4, rng, lead_bits=300)
    soft = (1.0 - 2.0 * bits + rng.normal(0, 0.5, len(bits))).astype(
        np.float32)
    d = deframe.StreamDeframer("v2", device="cpu")
    assert set(d.seconds) == {"deframe", *deframe.STAGES}
    got = []
    for i in range(0, len(soft), 7_000):
        got += d.push(soft[i:i + 7_000])
    assert got == deframe.deframe_soft(soft, "v2", device="cpu").payloads
    assert len(got) == 4
    assert d.seconds["deframe"] == pytest.approx(
        sum(d.seconds[k] for k in deframe.STAGES), rel=1e-9)
