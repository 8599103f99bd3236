"""The golden flight-rate tables through the port: the jax-free capture
functions and sweeps of wenet_tpu_torch/tools against tools/per_table.py
and tools/robustness_table.py, and the port's Receiver on the CPU held to
tests/golden/{per_table,robustness}_{v1,v2}.json under the bounds of
tests/test_per_table.py and tests/test_robustness_table.py (+-2 packets a
row, the floor and above-cliff rows, the baud-error and shift envelope).

The per_table rows from 5.0 to 8.5 dB (the floor, the cliff and the first
row held above it) and every robustness point run here; the whole grids
run on the card (chip_smoke.py, phase `golden`).
"""
import os
import sys

import numpy as np
import pytest
import torch

from wenet_tpu.ops import fsk as jfsk
from wenet_tpu_torch.ops import fsk
from wenet_tpu_torch.tools import load_golden
from wenet_tpu_torch.tools import per_table as tper
from wenet_tpu_torch.tools import robustness_table as trob

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import per_table as jper  # noqa: E402
import robustness_table as jrob  # noqa: E402

torch.set_num_threads(1)

MODES = ("v1", "v2")
CPU_GRID = [e for e in tper.GRID if e <= tper.ABOVE_CLIFF_DB]


def _cfgs(mode):
    return ((jfsk.V1_CONFIG, fsk.V1_CONFIG) if mode == "v1"
            else (jfsk.V2_CONFIG, fsk.V2_CONFIG))


def test_constants_match():
    assert (tper.GRID, tper.PACKETS, tper.SEED_BASE) == (
        jper.GRID, jper.PACKETS, jper.SEED_BASE)
    assert (trob.PACKETS, trob.SEED_BASE, trob.RESAMPLE_POINTS,
            trob.SHIFT_POINTS) == (jrob.PACKETS, jrob.SEED_BASE,
                                   jrob.RESAMPLE_POINTS, jrob.SHIFT_POINTS)
    assert tper.GRID == load_golden("per_table_v2")["grid"]


@pytest.mark.parametrize("seed", [7050, 7120])
@pytest.mark.parametrize("mode", MODES)
def test_per_table_captures_are_byte_equal(mode, seed):
    jcfg, tcfg = _cfgs(mode)
    ebno = (seed - tper.SEED_BASE) / 10
    rj, pj = jper.make_flight_capture(jcfg, mode, tper.PACKETS,
                                      np.random.default_rng(seed), ebno)
    rt, pt = tper.make_flight_capture(tcfg, mode, tper.PACKETS,
                                      np.random.default_rng(seed), ebno)
    assert rt.dtype == rj.dtype == np.uint8
    assert rt.tobytes() == rj.tobytes() and pt == pj


@pytest.mark.parametrize("point", [0, 10])
@pytest.mark.parametrize("mode", MODES)
def test_robustness_captures_are_byte_equal(mode, point):
    """A resample point and a shift point: the JAX tool's construction
    (tools/robustness_table.py:sweep) against the port's."""
    from wenet_tpu.ops import channel as jchannel
    jcfg, tcfg = _cfgs(mode)
    kind, i, value, ebno = trob.points()[point]
    got, pt = trob.impaired_capture(tcfg, mode, kind, i, value, ebno)
    rng = np.random.default_rng(jrob.SEED_BASE + (i if kind == "resample"
                                                  else 50 + i))
    sig, pj = jrob.make_flight_capture(jcfg, mode, jrob.PACKETS, rng)
    iq = (jchannel.resample_linear(sig, value) if kind == "resample"
          else jchannel.freq_shift(sig, value * jcfg.Rs, jcfg.Fs))
    want = jchannel.add_awgn(iq, ebno, jcfg.Fs, jcfg.Rs, rng=rng)
    assert got.dtype == want.dtype == np.complex64
    assert got.tobytes() == want.tobytes() and pt == pj


@pytest.mark.parametrize("mode", MODES)
def test_per_table_cliff_rows_hold_the_golden(mode):
    table = tper.sweep(mode, device="cpu", grid=CPU_GRID)
    assert [r["ebno_db"] for r in table["rows"]] == CPU_GRID
    assert tper.violations(table, load_golden(f"per_table_{mode}")) == []


@pytest.mark.parametrize("mode", MODES)
def test_robustness_table_holds_the_golden(mode):
    table = trob.sweep(mode, device="cpu")
    assert trob.violations(table, load_golden(f"robustness_{mode}")) == []


def test_violations_catch_drift():
    """The checks fail a row 3 packets off the golden, a packet on the
    floor, two lost above the cliff, other points, and a broken envelope."""
    golden = load_golden("per_table_v2")

    def table(**over):
        rows = [dict(r, packets_ok=over.get(str(r["ebno_db"]),
                                            r["packets_ok"]))
                for r in golden["rows"]]
        return dict(golden, rows=rows)
    assert tper.violations(table(), golden) == []
    assert len(tper.violations(table(**{"7.5": 7}), golden)) == 1
    assert len(tper.violations(table(**{"5.5": 1}), golden)) == 1
    assert len(tper.violations(table(**{"9.0": 10}), golden)) == 1
    rob = load_golden("robustness_v2")
    assert trob.violations(rob, rob) == []
    rows = [dict(r) for r in rob["rows"]]
    rows[4]["packets_ok"] = 2            # 1.006 decodes two of eight
    assert len(trob.violations(dict(rob, rows=rows), rob)) == 1
    assert trob.violations(dict(rob, rows=rows[:-1]), rob) == [
        "the table's points differ from the golden's"]
