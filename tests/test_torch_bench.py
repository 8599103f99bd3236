"""The port's benchmark (wenet_tpu_torch/bench.py) on the CPU at the scaled
v2 geometry (Fs=96000, Rs=9600), small sizes set through bench.py's own
WENET_BENCH_* variables, every capture cache under a temporary directory:

- the four stages' record: bench.py's keys, each rate beside its packet
  (or codeword) count and the count sent, every gate held, the headline
  rule of bench.py's `emit`;
- the stream stage's payloads on every path equal JAX's `decode_iq_fused`
  on the same bytes, and those bytes, the chain's signal and the LDPC
  stage's codewords equal what bench.py's steps make from the same seeds
  (bench.make_packet_bits and the JAX package's modulator, channel and
  encoder, at the scaled geometry);
- main(): one JSON line, exit status 1 when a stage raises or a gate
  fails, 0 otherwise.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from wenet_tpu.ops import channel as jchannel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.rx import pipeline as jpipe
from wenet_tpu_torch import bench
from wenet_tpu_torch.ops import fsk
from wenet_tpu_torch.tools import captures, wideband_scaling

torch.set_num_threads(1)

TCFG = fsk.FSKConfig(Fs=96000, Rs=9600)
JCFG = jfsk.FSKConfig(Fs=96000, Rs=9600)
SIZES = {"WENET_BENCH_STREAMS": "2", "WENET_BENCH_CHAIN_ROUNDS": "1",
         "WENET_BENCH_STREAM_SECS": "1.5", "WENET_BENCH_PAR_CHUNKS": "4",
         "WENET_BENCH_SLABS": "2", "WENET_BENCH_PUSH_CHUNKS": "2",
         "WENET_BENCH_WIDEBAND_N": "2"}
LDPC_BATCH = 16
CPU = torch.device("cpu")

# bench.py's names for each stage's quantities
CHAIN_KEYS = {"full_chain_msps", "realtime_x", "packets_ok", "packets_sent",
              "packets_ok_parity_band", "packets_sent_parity_band",
              "batch_streams", "chain_rounds", "chain_reps",
              "chain_first_run_s", "chain_compile_s",
              "chain_dispatch_overhead_s", "full_chain_msps_program"}
STREAM_KEYS = {
    "stream_capture_cached", "stream_capture_s", "stream_packets_sent",
    "h2d_mbps", "stream_h2d_ceiling_x", "stream_fused_first_call_s",
    "stream_fused_chunks", "stream_fused_msps", "stream_fused_packets_ok",
    "stream_fused_gate", "stream_overlap_first_call_s",
    "stream_overlap_slabs", "stream_overlap_msps",
    "stream_overlap_packets_ok", "stream_overlap_gate",
    "stream_program_full_msps", "stream_program_full_rt_x",
    "stream_program_full_packets_ok", "stream_program_full_chunks",
    "stream_push_fused_compile_s", "stream_push_fused_msps",
    "stream_push_fused_packets_ok", "stream_push_fused_packets_sent",
    "time_to_first_packet_cold_s", "time_to_first_packet_warm_s",
    "stream_push_compile_s", "stream_push_packets_ok",
    "stream_push_packets_sent", "stream_pp_msps", "stream_serial_msps",
    "pp_speedup", "stream_ingest_msps", "stream_ingest_path",
    "stream_realtime_x", "dispatch_overhead_s",
    # under 50 x real time, as on this CPU: the program-rate record
    "stream_program_msps", "stream_program_realtime_x",
    "stream_program_packets_ok", "stream_program_packets_expected",
    "stream_program_first_call_s", "stream_program_prefix_s"}
WIDEBAND_KEYS = {"wideband_msps_n2", "wideband_rt_x_n2",
                 "wideband_channels_ok_n2"}
LDPC_KEYS = {"ldpc_compile_s", "ldpc_codewords_per_s",
             "minsum_codewords_per_s"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four stages once, at the scaled geometry -> (record, what the
    chain and stream stages returned)."""
    cache = str(tmp_path_factory.mktemp("bench_cache"))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SIZES.items():
            mp.setenv(k, v)
        mp.setattr(captures, "CACHE_DIR", cache)
        mp.setattr(wideband_scaling, "CACHE_DIR", cache)
        res = {}
        out = {"chain": bench.stage_chain(res, CPU, TCFG, reps=1),
               "stream": bench.stage_stream(res, CPU, TCFG, reps=1)}
        bench.stage_wideband(res, CPU, TCFG, reps=1)
        bench.stage_ldpc(res, CPU, reps=1, batch=LDPC_BATCH)
        assert sorted(os.listdir(cache))      # the caches went there
    return res, out


def test_record_keys_and_gates(run):
    res, _ = run
    assert CHAIN_KEYS | STREAM_KEYS | WIDEBAND_KEYS | LDPC_KEYS <= set(res)
    assert not [k for k in res if k.endswith("_error")]
    gates = {k: v for k, v in res.items() if k.endswith("_gate")}
    assert gates and all(v is True for v in gates.values()), gates
    assert bench.failures(res) == []
    assert "stream_ingest_gate_failed" not in res
    json.dumps(res)


def test_packet_counts_against_those_sent(run):
    res, out = run
    B, R = int(SIZES["WENET_BENCH_STREAMS"]), 1
    assert (res["batch_streams"], res["chain_rounds"]) == (B, R)
    assert res["packets_sent"] == R * B * bench.CHAIN_PACKETS
    assert res["packets_ok"] == int(out["chain"]["ok"].sum())
    # linspace(8, 15, 2): one stream in the parity band, all of it back
    assert res["packets_sent_parity_band"] == bench.CHAIN_PACKETS
    assert res["packets_ok_parity_band"] == res["packets_sent_parity_band"]
    assert res["chain_parity_band_misses"] == []
    n = res["stream_packets_sent"]
    assert n == captures._stream_packets(1.5, TCFG) > 0
    for path, key in (("fused", "stream_fused_packets_ok"),
                      ("fused_overlap", "stream_overlap_packets_ok"),
                      ("program_full", "stream_program_full_packets_ok"),
                      ("push_fused", "stream_push_fused_packets_ok"),
                      ("push_pp", "stream_pp_packets_ok"),
                      ("push_serial", "stream_serial_packets_ok")):
        assert res[key] == len(out["stream"][path]) == n, path
    assert res["stream_push_packets_sent"] == n
    assert res["wideband_packets_sent_n2"] == 2 * 12
    assert res["wideband_packets_ok_n2"] >= 2 * 11
    assert res["wideband_channels_ok_n2"] == "2/2"
    for name in ("ldpc", "minsum"):
        assert res[f"{name}_codewords_ok"] == res["ldpc_codewords_sent"] \
            == LDPC_BATCH


def test_headline_rule(run):
    res, _ = run
    line = bench.headline(res)
    assert (line["metric"], line["unit"]) == ("full_chain_iq_throughput",
                                              "Msamples/s/chip")
    assert line["value"] == round(res["full_chain_msps"], 2)
    assert line["vs_baseline"] == round(res["full_chain_msps"] / 7.3, 2)
    assert list(line)[:4] == ["metric", "value", "unit", "vs_baseline"]
    no_chain = {k: v for k, v in res.items() if k != "full_chain_msps"}
    line = bench.headline(no_chain)
    assert line["metric"] == "stream_ingest_throughput"
    assert line["value"] == res["stream_ingest_msps"]
    # the stream headline is the fastest path whose gate held
    assert res["stream_ingest_path"] in ("fused", "fused_overlap",
                                         "push_fused", "push_pp",
                                         "push_serial")
    r = {}
    bench.finish_stream(r, [(5e6, False, "a"), (3e6, True, "b"),
                            (2e6, True, "c")], TCFG)
    assert r == {"stream_ingest_msps": 3.0, "stream_ingest_path": "b",
                 "stream_realtime_x": round(3e6 / TCFG.Fs, 1)}
    r = {}
    bench.finish_stream(r, [(5e6, False, "a")], TCFG)
    assert r == {"stream_ingest_gate_failed": [{"path": "a", "msps": 5.0}]}
    assert bench.failures(r) == ["stream_ingest_gate_failed"]
    line = bench.headline({"ldpc_codewords_per_s": 1234.4})
    assert (line["metric"], line["value"], line["vs_baseline"]) == (
        "ldpc_decode_rate", 1234.0, 0.0)


def test_stream_payloads_match_jax_decode_iq_fused(run, tmp_path,
                                                   monkeypatch):
    """The stage's capture is bench.py's steps at the scaled geometry,
    byte for byte; every path's payloads equal JAX's decode_iq_fused on
    those bytes."""
    _, out = run
    monkeypatch.setattr(captures, "CACHE_DIR", str(tmp_path))
    raw, n = captures.stream_capture(1.5, 12.0, cfg=TCFG)
    rng = np.random.default_rng(3)
    bits = jbench.make_packet_bits(JCFG, n, rng)
    sig, _ = jfsk.fsk_mod_np(JCFG, bits, 2 * JCFG.Rs, JCFG.Rs)
    iq = jchannel.add_awgn(sig.astype(np.complex64), 12.0, JCFG.Fs, JCFG.Rs,
                           rng=rng)
    want_raw = jfsk.iq_to_cu8(iq / np.abs(iq).max())
    assert raw.dtype == want_raw.dtype == np.uint8
    assert raw.tobytes() == want_raw.tobytes()
    want = jpipe.decode_iq_fused(raw, "v2", JCFG, n_chunks=4,
                                 input_format="cu8")
    assert want == captures.stream_payloads(1.5, cfg=TCFG)
    for path, got in out["stream"].items():
        assert got == want, path


def test_chain_signal_and_ldpc_batch_match_bench_steps():
    sig, var = bench.chain_signal(TCFG)
    bits = jbench.make_packet_bits(JCFG, 12, np.random.default_rng(0))
    want, _ = jfsk.fsk_mod_np(JCFG, bits, 2 * JCFG.Rs, JCFG.Rs)
    assert sig.dtype == want.dtype and sig.tobytes() == want.tobytes()
    assert var == float(np.mean(np.abs(want) ** 2))
    cw, llr = bench.ldpc_batch(8, CPU)
    r2 = np.random.default_rng(1)
    ib = np.unpackbits(r2.integers(0, 256, (8, 258), dtype=np.uint8), axis=1)
    want_cw = np.concatenate([ib, jldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** 0.75 * 0.8
    sd = (1 - 2.0 * want_cw) + r2.normal(0, np.sqrt(1 / (2 * esn0)),
                                         want_cw.shape)
    want_llr = np.asarray(jldpc.sd_to_llr(jnp.asarray(sd, jnp.float32)))
    np.testing.assert_array_equal(cw, want_cw)
    np.testing.assert_allclose(llr.numpy(), want_llr, rtol=1e-6, atol=1e-6)


def _fake_stage(key, value):
    def stage(res, dev, cfg):
        res[key] = value
    return stage


def _raise(res, dev, cfg):
    raise RuntimeError("stage blew up")


@pytest.mark.parametrize("case,rc", [("ok", 0), ("raises", 1),
                                     ("gate", 1), ("ingest_gate", 1)])
def test_main_exit_status(case, rc, monkeypatch, capsys, tmp_path):
    """One JSON line whatever happens; 1 when a stage raised or a gate
    failed, with the failure named on stderr; 0 otherwise."""
    stages = {"chain": _fake_stage("full_chain_msps", 10.0),
              "ldpc": _fake_stage("ldpc_gate", True)}
    if case == "raises":
        stages["chain"] = _raise
    elif case == "gate":
        stages["ldpc"] = _fake_stage("ldpc_gate", False)
    elif case == "ingest_gate":
        stages["stream"] = _fake_stage("stream_ingest_gate_failed",
                                       [{"path": "fused", "msps": 1.0}])
    monkeypatch.setattr(bench, "STAGES", stages)
    out_path = tmp_path / "bench.jsonl"
    assert bench.main(["--device", "cpu", "--out", str(out_path)]) == rc
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert out_path.read_text().strip() == lines[0]
    assert line["platform"] == "cpu"
    assert set(line["kernel_launches"]) >= {
        "fsk_demod", "deframe_topk", "bp_decode", "bp_onehot", "crc_pack",
        "channelize"}
    if case == "raises":
        assert "stage blew up" in line["chain_error"]
        assert line["metric"] == "ldpc_decode_rate"
        assert "chain_error" in captured.err
    else:
        assert line["metric"] == "full_chain_iq_throughput"
    if case == "gate":
        assert "ldpc_gate" in captured.err
