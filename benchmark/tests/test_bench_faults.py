"""`correct` comes out false for the control and for each fault the cells
can have, planted under the timed path; a sound run is correct.  The runs
skip the look for a card and go through the rest of a run on the CPU at a
small size, with the program's plain versions of its kernels."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import bench_with_fused

SIZES = {
    "v2_receiver": {"recording_s": 0.3, "push_s": 0.1, "warm_pushes": 2,
                    "check": {"block_pushes": 2, "block_start_max": 2}},
    "v2_fused": {"recording_s": 0.3, "recordings": 2, "n_chunks": 4,
                 "warm_calls": 1, "check": {"call_max": 2, "lanes": 3}},
}
SEED = 2 ** 31 + 77


def run(cell, control=False):
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu",
                            overrides=SIZES[cell], control=control,
                            bench=bench_with_fused())


def failing(out) -> list:
    return [k for k, v, lim in out["checks"] if not v <= lim]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["result"]["correct"] is True, out["checks"]
    assert out["result"]["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails(cell):
    """The reference at TF32 in the program's place fails the soft gap."""
    out = run(cell, control=True)
    assert out["result"]["correct"] is False
    assert "soft_gap" in failing(out)


def test_state_left_unchanged_fails(monkeypatch):
    from wenet_tpu_torch.ops import fsk
    demod = fsk.demod_raw

    def stuck(*args, **kwargs):
        res = demod(*args, **kwargs)
        state = args[6] if len(args) > 6 else kwargs.get("state")
        return (state,) + tuple(res[1:])
    monkeypatch.setattr(fsk, "demod_raw", stuck)
    out = run("v2_receiver")
    assert out["result"]["correct"] is False
    assert "frames_differ" in failing(out) or "soft_gap" in failing(out)


def test_half_the_lanes_left_out_fails(monkeypatch):
    from wenet_tpu_torch.ops import fsk
    demod = fsk.demod_raw

    def half(*args, **kwargs):
        final, outs = demod(*args, **kwargs)[:2]
        valid = outs.valid.clone()
        valid[1::2] = False
        return final, outs._replace(valid=valid)
    monkeypatch.setattr(fsk, "demod_raw", half)
    out = run("v2_fused")
    assert out["result"]["correct"] is False
    assert {"failed", "frames_differ"} <= set(failing(out))


def test_altered_payload_fails_the_receiver(monkeypatch):
    from wenet_tpu_torch.ops import deframe
    decode = deframe.decode_candidates

    def altered(*args, **kwargs):
        pkts, ok, rest = decode(*args, **kwargs)
        pkts = np.array(pkts)
        pkts[:, 5] ^= 0x40
        return pkts, ok, rest
    monkeypatch.setattr(deframe, "decode_candidates", altered)
    out = run("v2_receiver")
    assert out["result"]["correct"] is False
    assert failing(out) == ["failed"]


def test_altered_payload_fails_the_fused_path(monkeypatch):
    from wenet_tpu_torch.ops import deframe
    topk = deframe.deframe_topk

    def altered(*args, **kwargs):
        packed = topk(*args, **kwargs).clone()
        packed[..., 5] ^= torch.tensor(0x40, dtype=packed.dtype)
        return packed
    monkeypatch.setattr(deframe, "deframe_topk", altered)
    out = run("v2_fused")
    assert out["result"]["correct"] is False
    assert failing(out) == ["failed"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v2_receiver", "v2_fused", "v1_receiver"])
def test_control_fails_at_the_cells_size(card, cell):
    """On the card, at the cell's own sizes and load, over three seeds: the
    program's run is correct and the control's judgement of the same run
    is not.  Prints both readings of every number compared."""
    bench = bench_with_fused()
    limits = harness.resolve(bench, cell).traffic["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        out = harness.run_cell(cell, seed, 3.0, False, device="cuda",
                               control=True, bench=bench)
        program = out["program"]["checks"]
        print(cell, seed, "program", program, "control", out["checks"])
        assert all(program[k] <= lim for k, lim in limits.items())
        assert out["result"]["correct"] is False
        assert "soft_gap" in failing(out)


def test_half_the_batch_left_out_fails_the_receiver(monkeypatch):
    from wenet_tpu_torch.ops import deframe
    decode = deframe.decode_candidates

    def half(*args, **kwargs):
        pkts, ok, rest = decode(*args, **kwargs)
        ok = np.array(ok)
        ok[1::2] = False
        return pkts, ok, rest
    monkeypatch.setattr(deframe, "decode_candidates", half)
    out = run("v2_receiver")
    assert out["result"]["correct"] is False
    assert failing(out) == ["failed"]
