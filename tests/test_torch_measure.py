"""The port's measurement tools (wenet_tpu_torch/tools) on the CPU against
their tools/ counterparts and the JAX package, on the same inputs:

- captures: `make_packet_bits`, `decodable_packets` and `stream_capture`
  byte-equal to bench.py's (imported here only; its disk cache redirected
  to a temporary directory);
- `chain_lanes`: (ok, pos) exactly those of JAX's `demod_stream` +
  `deframe_topk` on the same noisy IQ (noise made with numpy and given to
  both, since the JAX tools draw theirs from jax.random);
- `census`: the record of tools/loss_census.py's own classification (its
  main() run with its chain replaced by the given picks) on hand-built
  picks (exhausted, duplicate, a warm-up offset) and on the chain's;
- `minsum_scaling`: the tool's LLRs, and bits, iterations and iteration
  histograms exactly those of JAX's decoders on them;
- `build_wideband_capture`: byte-equal;
- `pp_breakdown.run`: JAX's run's packet count and the Receiver's list;
- `stream_tune`'s lists: equal to `decode_iq_fused` of both packages;
- the stage splits of fused_where, fused_profile and wideband_where: each
  stage computes what the fused path computes.

Scaled geometries as in the other port tests, torch on one thread.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from wenet_tpu.ops import deframe as jdeframe
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.rx import pipeline as jpipe
from wenet_tpu_torch.ops import channel, channelizer, deframe, fsk
from wenet_tpu_torch.rx import pipeline
from wenet_tpu_torch.tools import captures, chain_scaling, fused_profile
from wenet_tpu_torch.tools import fused_where, loss_census, minsum_scaling
from wenet_tpu_torch.tools import pp_breakdown, stream_tune
from wenet_tpu_torch.tools import wideband_scaling, wideband_where

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import loss_census as jcensus  # noqa: E402
import pp_breakdown as jpp  # noqa: E402
import wideband_scaling as jwide  # noqa: E402

torch.set_num_threads(1)

GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}
TCFG = fsk.FSKConfig(**GEOM["v2"])
JCFG = jfsk.FSKConfig(**GEOM["v2"])


# ------------------------------------------------------------------ captures


def test_capture_constants_match():
    assert (captures.LEAD_BITS, captures.FRAME_BITS_V2,
            captures.PKT_CYCLE_V2) == (bench.LEAD_BITS, bench.FRAME_BITS_V2,
                                       bench.PKT_CYCLE_V2)


@pytest.mark.parametrize("n_packets,seed,flight", [(3, 0, False),
                                                   (5, 7, True)])
def test_make_packet_bits_is_byte_equal(n_packets, seed, flight):
    tcfg, jcfg = ((fsk.V2_CONFIG, jfsk.V2_CONFIG) if flight
                  else (TCFG, JCFG))
    got = captures.make_packet_bits(tcfg, n_packets,
                                    np.random.default_rng(seed))
    want = bench.make_packet_bits(jcfg, n_packets,
                                  np.random.default_rng(seed))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the replayed payloads are the ones framed, each at its cycle
    from wenet_tpu.core import framing
    pays = captures.packet_payloads(n_packets, np.random.default_rng(seed))
    for i, p in enumerate(pays):
        frame = framing.frame_to_bits(framing.frame_packet(
            p, jldpc.encode_bytes, mode="v2"), "v2")
        at = captures.LEAD_BITS + i * captures.PKT_CYCLE_V2
        assert np.array_equal(got[at: at + len(frame)], frame)


@pytest.mark.parametrize("n_bits", [0, 2048, 2048 + 2744 - 1, 2048 + 2744,
                                    50_000, 96_000, 10**7])
def test_decodable_packets_match(n_bits):
    for n_packets in (1, 12, 27):
        assert captures.decodable_packets(n_bits, n_packets) == \
            bench.decodable_packets(n_bits, n_packets)


def test_stream_capture_is_byte_equal(tmp_path, monkeypatch):
    """One second at the flight geometry; both caches go to temporary
    directories."""
    monkeypatch.setattr(bench, "__file__", str(tmp_path / "bench.py"))
    monkeypatch.setattr(captures, "CACHE_DIR", str(tmp_path / "port"))
    want, nj = bench.stream_capture(1.0)
    got, nt, cached = captures.stream_capture(1.0, with_cache_flag=True)
    assert (nt, cached) == (nj, False)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert len(captures.stream_payloads(1.0)) == nt


def test_stream_capture_cache_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(captures, "CACHE_DIR", str(tmp_path))
    a, n, was = captures.stream_capture(0.4, with_cache_flag=True)
    b, m, now = captures.stream_capture(0.4, with_cache_flag=True)
    assert (was, now, n) == (False, True, m)
    assert a.tobytes() == b.tobytes()
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


# ------------------------------------------------------------- chain_lanes


def _noise(B, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n))
            + 1j * rng.standard_normal((B, n))).astype(np.complex64)


def _jax_chain(sig, var, noise, ebnos, k):
    """The vmapped `one` of tools/chain_scaling.py and tools/loss_census.py
    with its jax.random draw replaced by the given noise."""
    nf = JCFG.num_frames(len(sig))

    @jax.jit
    def chain(sig, noise, ebno_db):
        def one(z, e):
            nvar = var * JCFG.Fs / (JCFG.Rs * 10.0 ** (e / 10.0))
            iq = sig + jnp.sqrt(nvar / 2) * z
            iq = iq / jnp.max(jnp.abs(iq))
            _, outs = jfsk.demod_stream(JCFG, iq, nf)
            _, ok, _, pos = jdeframe.deframe_topk(
                outs.soft.reshape(-1), mode="v2", k=k)
            return ok, pos
        return jax.vmap(one)(noise, ebno_db)
    ok, pos = chain(jnp.asarray(sig), jnp.asarray(noise),
                    jnp.asarray(ebnos))
    return np.asarray(ok), np.asarray(pos)


@pytest.mark.parametrize("B", [2, 3])
def test_chain_lanes_match_jax(B):
    sig, var = chain_scaling.chain_signal(TCFG)
    assert var == float(np.mean(np.abs(sig) ** 2))
    ebnos = np.linspace(*chain_scaling.EBNO_RANGE, B).astype(np.float32)
    noise = _noise(B, len(sig), 10 + B)
    ok, pos = chain_scaling.chain_lanes(TCFG, sig, ebnos, 12, noise=noise,
                                        device="cpu")
    jok, jpos = _jax_chain(sig, var, noise, ebnos, 12)
    assert ok.shape == pos.shape == (B, 12)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    assert ok.sum() >= 12 * B - 2


def test_chain_lanes_draw_from_the_generator():
    sig, var = chain_scaling.chain_signal(TCFG, n_packets=3)
    ebnos = [12.0, 14.0]

    def lanes(seed):
        gen = torch.Generator().manual_seed(seed)
        return chain_scaling.chain_lanes(TCFG, sig, ebnos, 3, generator=gen,
                                         device="cpu")
    a, b = lanes(5), lanes(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the stream has no lead-in: its first packet may go to the warm-up
    assert (a[0].sum(dim=1) >= 2).all()


# ------------------------------------------------------------------ census


def _jax_census(monkeypatch, capsys, oks, poss, argv):
    """tools/loss_census.py's main() with its compiled chain returning
    (oks, poss): its own classification and record."""
    from wenet_tpu.utils import jaxcache
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a: None)
    monkeypatch.setattr(jax, "jit", lambda fn: lambda *a: (
        jnp.asarray(oks), jnp.asarray(poss)))
    monkeypatch.setattr(sys, "argv", ["loss_census.py"] + argv)
    capsys.readouterr()
    jcensus.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


CENSUS_CASES = {
    # R=2, B=3, k=12: all decoded but a miss of packet 0, of the last,
    # of an interior packet, an exhausted pick and a duplicate
    "misses": dict(R=2, B=3, first=0, k=None, edits=[
        (0, 0, 0, "fail"), (0, 1, 11, "fail"), (1, 2, 5, "fail"),
        (1, 0, 3, "exhaust"), (1, 1, 7, "dup")]),
    # one warm-up packet, k past n_packets: picks beyond the packets
    "warmup": dict(R=1, B=2, first=1, k=15, edits=[
        (0, 0, 1, "fail"), (0, 1, 0, "fail"), (0, 1, 12, "fail")]),
}


@pytest.mark.parametrize("case", sorted(CENSUS_CASES))
def test_census_matches_the_jax_tool(case, monkeypatch, capsys):
    c = CENSUS_CASES[case]
    R, B, first = c["R"], c["B"], c["first"]
    n_packets = 12 + first
    k = c["k"] or n_packets
    pos = np.full((R, B, k), -1, np.int32)
    ok = np.zeros((R, B, k), bool)
    rng = np.random.default_rng(4)
    for r in range(R):
        for b in range(B):
            order = rng.permutation(n_packets)
            pos[r, b, :n_packets] = (captures.LEAD_BITS + order
                                     * captures.PKT_CYCLE_V2 + 3)
            ok[r, b, :n_packets] = True
    for r, b, pi, what in c["edits"]:
        j = int(np.flatnonzero(pos[r, b] == captures.LEAD_BITS + pi
                               * captures.PKT_CYCLE_V2 + 3)[0])
        if what == "fail":
            ok[r, b, j] = False
        elif what == "exhaust":
            pos[r, b, j], ok[r, b, j] = -1, False
        else:                  # another pick decodes the same packet
            other = (j + 1) % n_packets
            pos[r, b, other] = pos[r, b, j] + 40
    argv = ["--streams", str(B), "--rounds", str(R),
            "--warmup-packets", str(first)]
    argv += ["--k", str(k)] if c["k"] else []
    want = _jax_census(monkeypatch, capsys, ok, pos, argv)
    ebnos = np.linspace(10.5, 15.0, B).astype(np.float32)
    got = loss_census.census(ok, pos, ebnos, n_packets, first)
    assert json.loads(json.dumps(got)) == want
    kinds = [e[3] for e in c["edits"]]
    assert got["duplicate_position_picks"] == kinds.count("dup")
    assert got["exhausted_picks"] == kinds.count("exhaust") + R * B * (
        k - n_packets)
    assert got["miss_first_pct"] > 0 and got["miss_last_pct"] > 0


def test_census_of_the_chain_matches_the_jax_tool(monkeypatch, capsys):
    """The census of the chain's picks at 10.5-15 dB (R=1, B=2), as
    loss_census.run computes it from the given noise, against the JAX
    tool's classification of the same picks."""
    sig, var, n_packets = loss_census.census_signal(TCFG)
    noise = _noise(2, len(sig), 21)
    ebnos = np.linspace(10.5, 15.0, 2).astype(np.float32)
    ok, pos = chain_scaling.chain_lanes(TCFG, sig, ebnos, n_packets,
                                        noise=noise, device="cpu")
    jok, jpos = _jax_chain(sig, var, noise, ebnos, n_packets)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    got = loss_census.run(2, 1, cfg=TCFG, device="cpu", noise=noise[None])
    want = _jax_census(monkeypatch, capsys, jok[None], jpos[None],
                       ["--streams", "2", "--rounds", "1"])
    assert json.loads(json.dumps(got)) == want
    assert got["loss_pct"] <= 100 / 24


# ----------------------------------------------------------- minsum_scaling


@pytest.mark.parametrize("B", [16, 64])
def test_minsum_scaling_matches_jax_decoders(B):
    """The tool's LLRs are the JAX tool's draws through sd_to_llr; on them
    both decoders' bits and iterations, and the histograms, are exact."""
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    llr = minsum_scaling.llr_batch(B, 7.5, rng_t, "cpu")
    esn0 = 10 ** (7.5 / 10.0) * 0.8
    ib = np.unpackbits(rng_j.integers(0, 256, (B, 258), dtype=np.uint8),
                       axis=1)
    cw = np.concatenate([ib, jldpc.encode_bits_np(ib)], axis=1)
    sd = (1 - 2.0 * cw) + rng_j.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    jllr = np.asarray(jldpc.sd_to_llr(jnp.asarray(sd, jnp.float32)))
    np.testing.assert_allclose(llr.numpy(), jllr, rtol=1e-5, atol=1e-5)
    for name, fn in minsum_scaling.decoders():
        jfn = {"minsum": jldpc.decode_minsum, "sumproduct": jldpc.decode}[name]
        bits, iters, ok = fn(llr)
        jbits, jiters, jok = (np.asarray(t) for t in jfn(jnp.asarray(
            llr.numpy())))
        np.testing.assert_array_equal(bits.numpy(), jbits)
        np.testing.assert_array_equal(iters.numpy(), jiters)
        np.testing.assert_array_equal(ok.numpy(), jok)
        hist = np.bincount(np.clip(jiters, 0, 10), minlength=11)
        assert minsum_scaling.iter_hist(iters) == hist.tolist()
        rec = minsum_scaling.measure(name, fn, llr, reps=1)
        assert rec["iter_hist"] == hist.tolist()
        assert rec["parity_ok_frac"] == round(float(jok.mean()), 3)


def test_minsum_scaling_cli_appends_records(tmp_path, capsys):
    out = tmp_path / "minsum.jsonl"
    assert minsum_scaling.main(["--batches", "8,4", "--reps", "1",
                                "--device", "cpu", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert recs == printed
    assert [(r["decoder"], r["B"]) for r in recs] == [
        ("minsum", 8), ("sumproduct", 8), ("minsum", 4), ("sumproduct", 4)]
    assert all(r["platform"] == "cpu" and sum(r["iter_hist"]) == r["B"]
               for r in recs)


# ------------------------------------------------------------- wideband


def test_wideband_capture_is_byte_equal():
    got, fs_t = wideband_scaling.build_wideband_capture(2, cache=False)
    want, fs_j = jwide.build_wideband_capture(2, cache=False)
    assert fs_t == fs_j == 2 * fsk.V2_CONFIG.Fs
    assert got.dtype == want.dtype == np.complex64
    assert got.tobytes() == want.tobytes()


def test_wideband_where_stages_are_the_fused_path():
    """The `full` stage's packed rows are demod_multichannel(fused=True)'s
    payloads; every channel complete."""
    wide, fs = wideband_scaling.build_wideband_capture(2, TCFG, cache=False)
    x = channelizer._device_input(wide, "cpu")
    stages = dict(wideband_where.stages(TCFG, 2))
    pb, ok, pos = deframe.unpack_decode_results(stages["full"](x).numpy())
    want = channelizer.demod_multichannel(wide, fs, 2, TCFG, fused=True,
                                          device="cpu")
    for ch in range(2):
        hits = sorted((int(pos[ch, j]), pb[ch, j, :256].tobytes())
                      for j in range(pb.shape[1])
                      if ok[ch, j] and pos[ch, j] >= 0)
        assert [p for _, p in hits] == want[ch]
        assert len(want[ch]) >= wideband_scaling.PACKETS_PER_CHANNEL - 1
    assert float(stages["chanz_only"](x)) > 0


# ------------------------------------------------------------ pp_breakdown


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_pp_breakdown_matches_jax_and_the_receiver(mode):
    tcfg = fsk.FSKConfig(**GEOM[mode])
    jcfg = jfsk.FSKConfig(**GEOM[mode])
    want = jpp.run(mode, 4.0, 1.0, 12.0, "cu8", jcfg)
    got = pp_breakdown.run(mode, 4.0, 1.0, 12.0, "cu8", tcfg, device="cpu")
    assert (got["packets_ok"], got["packets_sent"], got["pushes"]) == (
        want["packets_ok"], want["packets_sent"], want["pushes"])
    assert set(got["per_push_ms"]) == set(want["per_push_ms"])
    raw, n = pp_breakdown.capture(mode, 4.0, cfg=tcfg)
    _, pushes, payloads = pp_breakdown.breakdown(
        raw, mode, tcfg, chunk=pp_breakdown.push_size(tcfg, 1.0, "cu8"),
        device="cpu")
    rx = pipeline.Receiver(mode=mode, cfg=tcfg, input_format="cu8",
                           device="cpu")
    step = pp_breakdown.push_size(tcfg, 1.0, "cu8")
    ref = [p for i in range(0, len(raw), step)
           for p in rx.push(raw[i:i + step])]
    assert payloads == ref and len(ref) == want["packets_ok"] >= n - 1


# -------------------------------------------------------------- stream_tune


def _short_capture(n_packets=5, seed=3):
    rng = np.random.default_rng(seed)
    bits = captures.make_packet_bits(TCFG, n_packets, rng)
    sig, _ = fsk.fsk_mod_np(TCFG, bits, 2 * TCFG.Rs, TCFG.Rs)
    iq = channel.add_awgn(sig, 12.0, TCFG.Fs, TCFG.Rs, rng=rng)
    return fsk.iq_to_cu8(iq / np.abs(iq).max()), captures.packet_payloads(
        n_packets, np.random.default_rng(seed))


def test_stream_tune_lists_match_decode_iq_fused():
    raw, sent = _short_capture()
    recs = []
    lists = stream_tune.tune(raw, len(sent), fused_list=(4,),
                             ov_list=((2, 2),), reps=1, device="cpu",
                             emit=recs.append, cfg=TCFG)
    want = jpipe.decode_iq_fused(raw, "v2", JCFG, n_chunks=4,
                                 input_format="cu8")
    assert lists["fused4_ingest"] == pipeline.decode_iq_fused(
        raw, "v2", TCFG, n_chunks=4, device="cpu") == want
    assert set(lists) == {"fused4_devres", "fused4_ingest",
                          "overlap2x2_ingest"}
    for got in lists.values():
        assert got == want and len(want) == len(sent)
    assert [r["config"] for r in recs] == sorted(lists)
    assert recs[0]["packets_ok"] == len(sent) == recs[0]["packets_expected"]
    assert {"program_msps", "h2d_s", "first_call_s"} <= set(recs[0])


def test_stream_tune_compile_only_times_first_calls():
    raw, sent = _short_capture(2)
    recs = []
    lists = stream_tune.tune(raw, len(sent), fused_list=(2,),
                             ov_list=((1, 2),), compile_only=True,
                             device="cpu", emit=recs.append, cfg=TCFG)
    assert [r["config"] for r in recs] == ["fused2_devres",
                                           "overlap1x2_ingest"]
    assert all("first_call_s" in r and "program_msps" not in r
               and "ingest_msps" not in r for r in recs)
    assert lists["fused2_devres"] == lists["overlap1x2_ingest"] == sent


def test_fused_stages_are_the_fused_step():
    """fused_where's stages and fused_profile's top-k: the soft bits the
    step hands on decode to the step's rows; the gathered chunk samples
    are the capture's."""
    raw, sent = _short_capture(3)
    f = fused_where.Fused(raw, 3, torch.device("cpu"), TCFG)
    assert torch.equal(deframe.deframe_topk(f.soft(), "v2", f.k,
                                            packed=True), f.chain())
    z = fsk.to_iq(f.data, "cu8")
    iq = f.iq()
    for c, s in enumerate(f.starts):
        part = z[int(s): int(s) + f.chunk_len]
        assert torch.equal(iq[c, : len(part)], part)
        assert not iq[c, len(part):].abs().any()
    got = pipeline._dedup_payloads(pipeline._unpack_fused(
        f.chain().numpy(), f.starts, TCFG), f.syms_pp)
    assert got == sent
    assert fused_profile.run.__defaults__[:3] == (32, 2, 95.0)
