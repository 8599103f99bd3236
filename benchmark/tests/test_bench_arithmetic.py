"""The yardstick's arithmetic on hand-worked cases: the demod's work, the
device's busy time as a union, kernel names."""
import pytest

from benchmark import devtrace, harness

fsk_demod = harness.load_module("kernels", "fsk_demod")

V2 = {"N": 480, "Ts": 10, "P": 10, "M": 2, "Nsym": 48, "Nmem": 500,
      "Ndft": 256, "Nbits": 48}


def test_demod_work_hand_worked():
    # one v2 frame at nin = 480: one estimator block windowed over
    # 480 - 256 = 224 samples, 128 bins, NP = 490 integrator phases
    fs_part = 224 * (2 + 8 * 128) + 1 * 128 * 6
    rest = (2 * 128 + 2 * 500 * 14 + 2 * 490 * 9 * 2 + 490 * (3 * 2 + 4)
            + 48 * 2 * 8)
    assert fsk_demod.frame_ops(V2, 480) == fs_part + rest == 268_156
    rec = {"geometry": V2, "lanes": 1, "frames": 4, "samples": 2000,
           "fmt": "cu8", "eye": False, "nin_lo": 475}
    hist = [0] * 12
    hist[5] = 3                      # three valid frames at nin = 480
    hist[11] = 1                     # one invalid frame
    ops, nbytes = fsk_demod.work(rec, hist)
    assert ops == 3 * 268_156
    assert nbytes == (2000 * 2 + 1 * 4 * (5 * 48 + 4 * 2 + 13)
                      + 2 * 1 * (4 * 128 + 8 * 2 + 24))
    eye = dict(rec, eye=True)
    assert fsk_demod.work(eye, hist)[1] == nbytes + 8 * 2 * 490 + 5


def test_busy_time_is_the_union_of_device_intervals():
    intervals = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.7), (5.0, 6.0), (9.0, 12.0)]
    assert devtrace.union_length(intervals, 0.0, 10.0) == pytest.approx(5.0)
    assert devtrace.union_length(intervals, 1.5, 5.5) == pytest.approx(2.0)
    assert devtrace.idle_gaps(intervals, 0.0, 10.0) == [(3.0, 5.0),
                                                         (6.0, 9.0)]
    host = [("bench.call", 0.0, 8.0), ("ops.fsk.demod_raw", 3.5, 4.5),
            ("aten::mul", 5.0, 9.0)]
    trace = devtrace.Trace([("k", s, e) for s, e in intervals], host,
                           (0.0, 10.0))
    assert trace.busy_s() == pytest.approx(5.0)
    got = dict(trace.idle_by_host(["ops.fsk.demod_raw"]))
    assert got == {"ops.fsk.demod_raw": pytest.approx(1.0),
                   "host: in the call, outside the traced functions":
                   pytest.approx(3.0),
                   "host: between calls": pytest.approx(1.0)}


def test_kernel_names():
    assert devtrace.kernel_base_name(
        "void fsk_demod_kernel<2, false>(DemodGeom, DemodPtrs)") \
        == "fsk_demod_kernel"
    assert devtrace.kernel_base_name("topk_scores_kernel(TopkArgs)") \
        == "topk_scores_kernel"
    trace = devtrace.Trace(
        [("void fsk_demod_kernel<2, false>(DemodGeom, DemodPtrs)", 0.0, 1.0),
         ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.5),
         ("void fsk_demod_kernel<1, true>(DemodGeom, DemodPtrs)", 2.0, 2.25)],
        [], (0.0, 2.1))
    assert trace.kernel_s(fsk_demod.NAMES) == pytest.approx(1.1)
