"""BENCHMARK.json keeps to the benchmark's contract, its cells are found
by name, a cell added as files alone is picked up, and a run's last line
has the keys a result needs."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, bench_with_fused

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"recording_s": 0.3, "push_s": 0.1, "warm_pushes": 2,
         "check": {"block_pushes": 2, "block_start_max": 2}}
SMALL_FUSED = {"recording_s": 0.3, "recordings": 2, "n_chunks": 4,
               "warm_calls": 1, "check": {"call_max": 2, "lanes": 3}}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and not re.search(r"[\t\r\n]", text)


def test_names_units_and_keys():
    bench = harness.spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_every_cell_finds_its_files_and_reports_enough():
    bench = harness.spec()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        harness.load_module("entries", cell.traffic["entry"]).Entry
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
        for m in cell.end_to_end + cell.per_layer:
            reader = harness.load_module("metrics", m["name"])
            kernel = getattr(reader, "KERNEL", None)
            if kernel:
                k = harness.load_module("kernels", kernel)
                assert k.NAMES and k.OP and k.record and k.work
        assert set(cell.traffic["limits"]) >= {"failed", "soft_gap"}
    assert e2e["setup_s"]["bound"] <= 0.25


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "v2_receiver",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_jax_check_compares_whole_top_level_names():
    code = ("import sys, types; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness;"
            "sys.modules['wenet_tpu_torch_x'] = types.ModuleType('x');"
            "a = harness.forbidden_modules();"
            "sys.modules['jax.numpy'] = types.ModuleType('y');"
            "print(a, harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[] ['jax']"


def test_last_line_keys():
    out = harness.run_cell("v2_receiver", 2 ** 31 + 21, 0.5, False,
                           device="cpu", overrides=SMALL)
    line = json.loads(json.dumps(out["result"]))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"msps", "push_latency_p95_ms",
                                    "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    traced = harness.run_cell("v2_fused", 2 ** 31 + 22, 0.5, True,
                              device="cpu", overrides=SMALL_FUSED,
                              bench=bench_with_fused())["result"]
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(traced["device"])


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A copy of the benchmark gains a v1 whole-capture cell by a traffic
    file and a workloads entry, and runs it, without an edit to any
    file."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.spec()
    bench["workloads"].append({"name": "v1_fused", "config": "v1_classic",
                               "traffic": "v1_fused", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    fused = harness.load_json(os.path.join(ROOT, "benchmark", "workloads",
                                           "v2_fused.json"))
    (tmp_path / "benchmark" / "workloads" / "v1_fused.json").write_text(
        json.dumps(fused))
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "sys.path.insert(1, sys.argv[2]);"
            "from benchmark import harness;"
            "assert harness.ROOT == sys.argv[1];"
            "out = harness.run_cell('v1_fused', 2**31 + 23, 0.3, False,"
            " device='cpu', overrides=json.loads(sys.argv[3]));"
            "print(json.dumps(out['result']))")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT,
                           json.dumps(SMALL_FUSED)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0


@pytest.mark.cuda
def test_no_result_without_the_program(card, tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "v2_receiver",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert proc.stdout == ""
