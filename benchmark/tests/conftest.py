"""The benchmark's own tests.  Run from the repository's root:

    python -m pytest benchmark/tests -q

Tests marked `cuda` run the harness on an NVIDIA GPU and skip without
one; the rest run on the CPU at small sizes, with the
program's plain versions of its kernels.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device or no nvcc."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from wenet_tpu_torch import kernels
    if kernels.nvcc_path() is None:
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def bench_with_fused() -> dict:
    """BENCHMARK.json with the whole-capture cell `v2_fused`, whose entry
    and traffic are in the benchmark but whose cell is not (PERF.md: its
    rate spreads too widely between runs for a bound)."""
    from benchmark import harness
    bench = harness.spec()
    bench["workloads"].append({"name": "v2_fused", "config": "v2_flight",
                               "traffic": "v2_fused", "chips": 1,
                               "why": "decode_iq_fused on 60-s recordings"})
    for m in bench["per_layer"]:
        if m["moves"] == "msps":
            m["workloads"].append("v2_fused")
    return bench
