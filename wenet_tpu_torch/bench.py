"""Benchmark of the port: full-chain RX throughput, real-ingest streaming,
wideband scaling and LDPC rate on the card (counterpart of bench.py).

    python -m wenet_tpu_torch.bench [--device cpu] [--out PATH]

Prints ONE JSON line, with bench.py's headline rule:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}
The headline is `full_chain_iq_throughput` (the chain stage), else
`stream_ingest_throughput` (the fastest stream path that decoded its
packets), else `ldpc_decode_rate`; `vs_baseline` is against the reference
C chain's 7.3 Msamples/s (BASELINE.md).  The other keys keep bench.py's
names where the quantity means the same; `*_compile_s` and
`*_first_call_s` are the first call, which includes loading the built
kernels.

The four stages run in order, in this process:
  chain     B streams x R rounds through the whole v2 chain (the demod,
            top-k acquisition, BP and CRC kernels; `tools.chain_scaling.
            chain_lanes`), 12 packets a stream at Eb/N0 8-15 dB, each
            round on fresh noise from one torch.Generator
  stream    a v2 cu8 capture at 12 dB (`tools.captures.stream_capture`):
            decode_iq_fused, decode_iq_fused_overlap, the fused step on
            the capture already on the device, FusedReceiver pushes and
            its time to first packet, and Receiver pushes of an 8-s prefix,
            pipelined and serial
  wideband  `tools.wideband_scaling.measure` at N channels
  ldpc      the sum-product and min-sum BP kernels at B=2048, 7.5 dB
            (and the one-hot kernel with WENET_BENCH_PALLAS=1)

Every timed region ends with `torch.cuda.synchronize()` and a copy to
the host: one element of a tensor result, or the packed results of the
paths that return payload lists.  Every rate stands beside its packet (or
codeword) count and the count sent, and a rate whose packets are missing
does not set the headline.

Sizes, as in bench.py: WENET_BENCH_STREAMS (256), WENET_BENCH_CHAIN_ROUNDS
(16), WENET_BENCH_STREAM_SECS (95 on the card, else 6),
WENET_BENCH_PAR_CHUNKS (128), WENET_BENCH_SLABS (4), WENET_BENCH_SLAB_CPS
(PAR_CHUNKS / 2), WENET_BENCH_PUSH_CHUNKS (16), WENET_BENCH_WIDEBAND_N
(8,16), WENET_BENCH_PALLAS.

`kernel_launches` gives each kernel's launches over the whole run.
A stage that raises is recorded as `<stage>_error` and the next stage
runs; the line is printed all the same, and the exit status is 1 if any
stage raised or any gate (`*_gate`, `stream_ingest_gate_failed`) failed,
else 0.  It runs on the card unless `--device cpu` is given, and raises
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from .device import resolve_device
from .tools import fetch, platform

BASELINE_MSPS = 7.3
CHAIN_PACKETS = 12
CHAIN_EBNO = (8.0, 15.0)
PARITY_BAND_DB = 10.5       # the chain's Eb/N0 above the ~9.5 dB cliff
PARITY_BAND_MAX_LOSS = 1e-3  # the chain's gate: packets lost in the band
STREAM_EBNO_DB = 12.0
PUSH_SECONDS = 2.0          # a push: 2 s of cu8 bytes
LDPC_BATCH = 2048
LDPC_EBNO_DB = 7.5


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _v2(cfg):
    from .ops import fsk
    return fsk.V2_CONFIG if cfg is None else cfg


def _wait(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(seconds, result) of fn(), ended by a wait for the device."""
    t0 = time.perf_counter()
    out = fn()
    _wait(dev)
    return time.perf_counter() - t0, out


def dispatch_overhead_s(dev: torch.device, reps: int = 5) -> float:
    """Seconds of one small launch ended by a one-element fetch."""
    z = torch.ones((8, 128), device=dev)
    fetch(z * 2.0 + 1.0)
    t0 = time.perf_counter()
    for _ in range(reps):
        fetch(z * 2.0 + 1.0)
    return (time.perf_counter() - t0) / reps


def h2d_mbps(raw: np.ndarray, dev: torch.device) -> float:
    """MB/s of one copy of raw from a pinned (on the CPU, plain) buffer to
    the device, ended by a fetch of its last element."""
    src = torch.from_numpy(raw)
    if dev.type == "cuda":
        src = src.pin_memory()
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    dst.copy_(src, non_blocking=True)
    fetch(dst[-1:])
    t0 = time.perf_counter()
    dst.copy_(src, non_blocking=True)
    fetch(dst[-1:])
    return raw.nbytes / (time.perf_counter() - t0) / 1e6


# ------------------------------------------------------------------ chain


def chain_signal(cfg):
    """The chain stage's stream: 12 random packets after the 2048-bit
    lead-in, each followed by 512 random bits, FSK-modulated ->
    (complex64 samples, their mean power)."""
    from .ops import fsk
    from .tools.captures import make_packet_bits
    from .tools.chain_scaling import signal_power
    bits = make_packet_bits(cfg, CHAIN_PACKETS, np.random.default_rng(0))
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    return sig, signal_power(sig)


def stage_chain(res: dict, dev: torch.device, cfg=None, reps: int = 2):
    """B streams at Eb/N0 linspace(8, 15, B), R rounds a run, each round
    one `chain_lanes` call on noise drawn from one generator; the CRC-ok
    count of each stream summed over the rounds.  The gate: at most
    PARITY_BAND_MAX_LOSS of the packets sent at or above PARITY_BAND_DB
    are lost (near the cliff a correct receiver still loses a rare
    packet to the noise); each band stream that lost any is listed with
    its Eb/N0 in `chain_parity_band_misses`."""
    from .tools.chain_scaling import chain_lanes
    cfg = _v2(cfg)
    sig, var = chain_signal(cfg)
    B = _env_int("WENET_BENCH_STREAMS", 256)
    R = _env_int("WENET_BENCH_CHAIN_ROUNDS", 16)
    ebnos = np.linspace(*CHAIN_EBNO, B).astype(np.float32)
    sig_t = torch.as_tensor(sig, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rounds(n):
        ok = torch.zeros(B, dtype=torch.int64, device=dev)
        for _ in range(n):
            ok += chain_lanes(cfg, sig_t, ebnos, CHAIN_PACKETS,
                              generator=gen, device=dev, var=var)[0].sum(1)
        return ok

    t0 = time.perf_counter()
    fetch(rounds(1))
    res["chain_compile_s"] = round(time.perf_counter() - t0, 3)
    samples = R * B * len(sig)
    t0 = time.perf_counter()
    fetch(rounds(R))
    res["chain_first_run_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    for _ in range(reps):
        ok = rounds(R)
    fetch(ok)
    dt = (time.perf_counter() - t0) / reps
    ok = ok.cpu().numpy()
    band = ebnos >= PARITY_BAND_DB
    res.update(
        full_chain_msps=round(samples / dt / 1e6, 2),
        realtime_x=round(samples / dt / cfg.Fs, 1),
        batch_streams=B, chain_rounds=R, chain_reps=reps,
        chain_samples_per_stream=len(sig),
        packets_ok=int(ok.sum()), packets_sent=R * B * CHAIN_PACKETS,
        packets_ok_parity_band=int(ok[band].sum()),
        packets_sent_parity_band=int(R * CHAIN_PACKETS * band.sum()),
        packets_note=(
            "streams span EbN0 8-15 dB across the ~9.5 dB decode cliff by "
            "design; sub-cliff losses are expected (parity band reported "
            "separately). Capture has a 2048-bit lead-in before frame 0"))
    lost = R * CHAIN_PACKETS - ok
    res["chain_parity_band_misses"] = [
        [round(float(e), 3), int(n)] for e, n, b in zip(ebnos, lost, band)
        if b and n]
    res["chain_gate"] = (res["packets_ok_parity_band"] >= (
        1 - PARITY_BAND_MAX_LOSS) * res["packets_sent_parity_band"])
    overhead = dispatch_overhead_s(dev)
    res["chain_dispatch_overhead_s"] = round(overhead, 6)
    res["full_chain_msps_program"] = round(
        samples / max(dt - overhead, 1e-9) / 1e6, 2)
    return {"ok": ok}


# ----------------------------------------------------------------- stream


def _gate(n_ok: int, n_sent: int) -> bool:
    """bench.py's stream gate: the path decoded all but at most two of
    the packets sent (a cold start can cost the first)."""
    return n_ok >= n_sent - 2


def _program(f, reps: int, dev: torch.device):
    """(first call's s, s a call over reps more, payloads) of the fused
    step `f` (tools.fused_where.Fused) on its capture on the device, each
    call ended by the packed results' copy to the host."""
    from .rx import pipeline as P
    first, packed = _timed(lambda: f.chain().cpu(), dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        packed = f.chain().cpu()
    dt = (time.perf_counter() - t0) / reps
    pk = P._dedup_payloads(P._unpack_fused(packed.numpy(), f.starts, f.cfg),
                           f.syms_pp)
    return first, dt, pk


def stage_stream(res: dict, dev: torch.device, cfg=None, reps: int = 2):
    """Raw cu8 bytes in host memory -> CRC-valid payloads on each ingest
    path; the headline `stream_ingest_msps` is the fastest path that
    decoded all but two of the packets sent.  Returns each path's
    payloads."""
    from .rx import pipeline as P
    from .tools.captures import decodable_packets, stream_capture
    from .tools.fused_where import Fused
    cfg = _v2(cfg)
    secs = float(os.environ.get("WENET_BENCH_STREAM_SECS",
                                "95" if dev.type == "cuda" else "6"))
    t0 = time.perf_counter()
    raw, n_packets, was_cached = stream_capture(
        secs, STREAM_EBNO_DB, with_cache_flag=True, cfg=cfg)
    res["stream_capture_cached"] = bool(was_cached)
    res["stream_capture_gen_s"] = round(time.perf_counter() - t0, 1)
    n_samples = len(raw) // 2
    res["stream_capture_s"] = round(n_samples / cfg.Fs, 1)
    res["stream_packets_sent"] = n_packets
    res["h2d_mbps"] = round(h2d_mbps(raw, dev), 0)
    res["stream_h2d_ceiling_x"] = round(res["h2d_mbps"] * 1e6 / 2 / cfg.Fs,
                                        1)
    candidates, lists = [], {}
    n_chunks = _env_int("WENET_BENCH_PAR_CHUNKS", 128)

    def best_of(fn):
        """(first call's s, the fastest of reps more, last result)."""
        first, out = _timed(fn, dev)
        dts = []
        for _ in range(reps):
            dt, out = _timed(fn, dev)
            dts.append(dt)
        return first, min(dts), out

    # (a) decode_iq_fused: one copy in, one fused step, one copy out
    first, dt, pk = best_of(lambda: P.decode_iq_fused(
        raw, "v2", cfg, n_chunks=n_chunks, input_format="cu8", device=dev))
    lists["fused"] = pk
    res.update(stream_fused_first_call_s=round(first, 3),
               stream_fused_chunks=n_chunks,
               stream_fused_msps=round(n_samples / dt / 1e6, 2),
               stream_fused_packets_ok=len(pk),
               stream_fused_gate=_gate(len(pk), n_packets))
    candidates.append((n_samples / dt, res["stream_fused_gate"], "fused"))

    # (b) the slab-pipelined fused path
    n_slabs = _env_int("WENET_BENCH_SLABS", 4)
    cps = _env_int("WENET_BENCH_SLAB_CPS", max(n_chunks // 2, 1))
    first, dt, pk = best_of(lambda: P.decode_iq_fused_overlap(
        raw, "v2", cfg, n_slabs=n_slabs, chunks_per_slab=cps,
        input_format="cu8", device=dev))
    lists["fused_overlap"] = pk
    res.update(stream_overlap_first_call_s=round(first, 3),
               stream_overlap_slabs=n_slabs,
               stream_overlap_msps=round(n_samples / dt / 1e6, 2),
               stream_overlap_packets_ok=len(pk),
               stream_overlap_gate=_gate(len(pk), n_packets))
    candidates.append((n_samples / dt, res["stream_overlap_gate"],
                       "fused_overlap"))

    # (c) the same fused step on the capture already on the device
    f = Fused(raw, n_chunks, dev, cfg)
    fetch(f.data[-1:])
    _, dt, pk = _program(f, reps, dev)
    del f
    lists["program_full"] = pk
    res.update(stream_program_full_msps=round(n_samples / dt / 1e6, 2),
               stream_program_full_rt_x=round(n_samples / dt / cfg.Fs, 1),
               stream_program_full_packets_ok=len(pk),
               stream_program_full_chunks=n_chunks,
               stream_program_full_gate=_gate(len(pk), n_packets))

    # (d) the live throughput path: FusedReceiver fed 2-s pushes
    chunk = 2 * int(cfg.Fs * PUSH_SECONDS)

    def push_all(rx, data):
        got = []
        for i in range(0, len(data), chunk):
            got += rx.push(data[i:i + chunk])
        return got + rx.flush()

    def fused_push():
        return push_all(P.FusedReceiver(
            "v2", cfg, push_samples=4 * cfg.Fs,
            n_chunks=_env_int("WENET_BENCH_PUSH_CHUNKS", 16),
            input_format="cu8", depth=2, device=dev), raw)

    res["stream_push_fused_compile_s"] = round(_timed(fused_push, dev)[0], 3)
    dt, pk = _timed(fused_push, dev)
    lists["push_fused"] = pk
    res.update(stream_push_fused_msps=round(n_samples / dt / 1e6, 2),
               stream_push_fused_packets_ok=len(pk),
               stream_push_fused_packets_sent=n_packets,
               stream_push_fused_gate=_gate(len(pk), n_packets))
    candidates.append((n_samples / dt, res["stream_push_fused_gate"],
                       "push_fused"))

    # (e) time to first packet of the low-latency configuration: cold is
    # this process's first use of it, warm the second
    def ttfp():
        rx = P.FusedReceiver("v2", cfg, push_samples=cfg.Fs, n_chunks=4,
                             depth=0, input_format="cu8", device=dev)
        t0 = time.perf_counter()
        for i in range(0, len(raw), chunk):
            if rx.push(raw[i:i + chunk]):
                return time.perf_counter() - t0
        return time.perf_counter() - t0 if rx.flush() else None
    cold, warm = ttfp(), ttfp()
    if cold is not None:
        res["time_to_first_packet_cold_s"] = round(cold, 4)
    if warm is not None:
        res["time_to_first_packet_warm_s"] = round(warm, 4)
    res["time_to_first_packet_gate"] = cold is not None and warm is not None

    # (f) the exact-FSM Receiver on an 8-s prefix, pipelined and serial
    push_secs = min(secs, 8.0)
    sub = raw[: 2 * int(push_secs * cfg.Fs)]
    push_samples = len(sub) // 2
    push_expected = decodable_packets(push_samples * cfg.Rs // cfg.Fs,
                                      n_packets)

    def receiver(pipelined):
        return push_all(P.Receiver("v2", cfg, pipelined=pipelined,
                                   input_format="cu8", device=dev), sub)

    dt, pk = _timed(lambda: receiver(True), dev)
    res.update(stream_push_compile_s=round(dt, 3),
               stream_push_packets_ok=len(pk),
               stream_push_packets_sent=push_expected)
    dt_pp, lists["push_pp"] = _timed(lambda: receiver(True), dev)
    dt_serial, lists["push_serial"] = _timed(lambda: receiver(False), dev)
    for key, dt, name in (("pp", dt_pp, "push_pp"),
                          ("serial", dt_serial, "push_serial")):
        n_ok = len(lists[name])
        res[f"stream_{key}_msps"] = round(push_samples / dt / 1e6, 2)
        res[f"stream_{key}_packets_ok"] = n_ok
        res[f"stream_{key}_gate"] = _gate(n_ok, push_expected)
        candidates.append((push_samples / dt, res[f"stream_{key}_gate"],
                           name))
    res["pp_speedup"] = round(dt_serial / dt_pp, 3)

    finish_stream(res, candidates, cfg)
    if res.get("stream_realtime_x", 0) < 50:
        lists["program_prefix"] = program_rate(res, raw, n_packets, cfg,
                                               dev, reps)
    res["dispatch_overhead_s"] = round(dispatch_overhead_s(dev), 6)
    return lists


def finish_stream(res: dict, candidates, cfg):
    """The headline of the stream stage: the fastest path whose gate
    held, else the list of the paths that failed theirs."""
    gated = [c for c in candidates if c[1]]
    if gated:
        rate, _, label = max(gated)
        res["stream_ingest_msps"] = round(rate / 1e6, 2)
        res["stream_ingest_path"] = label
        res["stream_realtime_x"] = round(rate / cfg.Fs, 1)
    else:
        res["stream_ingest_gate_failed"] = [
            {"path": c[2], "msps": round(c[0] / 1e6, 2)} for c in candidates]


def program_rate(res: dict, raw, n_packets: int, cfg, dev, reps: int = 2):
    """bench.py's degraded-day record: the program rate of the fused step
    (C=32, `tools.stream_tune`'s timing) on a 12-s prefix already on the
    device, recorded when the ingest rate is under 50 x real time."""
    from .tools.captures import decodable_packets
    from .tools.fused_where import Fused
    secs_p = 12.0
    f = Fused(raw[: 2 * int(secs_p * cfg.Fs)], 32, dev, cfg)
    fetch(f.data[-1:])
    first, dt, pk = _program(f, reps, dev)
    expected = decodable_packets(f.n * cfg.Rs // cfg.Fs, n_packets)
    res.update(stream_program_first_call_s=round(first, 3),
               stream_program_prefix_s=secs_p,
               stream_program_msps=round(f.n / dt / 1e6, 2),
               stream_program_realtime_x=round(f.n / dt / cfg.Fs, 1),
               stream_program_packets_ok=len(pk),
               stream_program_packets_expected=expected,
               stream_program_gate=_gate(len(pk), expected))
    return pk


# --------------------------------------------------------------- wideband


def stage_wideband(res: dict, dev: torch.device, cfg=None, reps: int = 2):
    """The fused wideband path at each N of WENET_BENCH_WIDEBAND_N; every
    channel must be complete (at least 11 of its 12 packets)."""
    from .tools import wideband_scaling
    for nch in (int(x) for x in os.environ.get(
            "WENET_BENCH_WIDEBAND_N", "8,16").split(",")):
        rec = wideband_scaling.measure(nch, reps, device=dev, cfg=cfg)
        res[f"wideband_msps_n{nch}"] = rec["wideband_msps"]
        res[f"wideband_rt_x_n{nch}"] = rec["band_realtime_x"]
        res[f"wideband_channels_ok_n{nch}"] = (
            f"{rec['channels_complete']}/{nch}")
        res[f"wideband_packets_ok_n{nch}"] = rec["packets_ok"]
        res[f"wideband_packets_sent_n{nch}"] = rec["packets_sent"]
        res[f"wideband_first_call_s_n{nch}"] = rec["first_call_s"]
        res[f"wideband_gate_n{nch}"] = rec["channels_complete"] == nch


# ------------------------------------------------------------------- ldpc


def ldpc_batch(batch: int, dev: torch.device):
    """bench.py's decoder batch: random codewords through BPSK at Es/N0
    7.5 dB less 1 dB (x0.8) -> (codewords (B, 2580) uint8, LLRs on dev)."""
    from .ops import ldpc
    r2 = np.random.default_rng(1)
    ib = np.unpackbits(r2.integers(0, 256, (batch, 258), dtype=np.uint8),
                       axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (LDPC_EBNO_DB / 10) * 0.8
    sd = (1 - 2.0 * cw) + r2.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return cw, ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32,
                                              device=dev))


def stage_ldpc(res: dict, dev: torch.device, cfg=None, reps: int = 3,
               batch: int = LDPC_BATCH):
    """Codewords/s of each decoder on one batch (first call timed apart),
    each region ended by a fetch of one element of the bits; a decoder
    passes its gate when all but two codewords come back whole."""
    from .ops import ldpc, ldpc_onehot
    cw, llr = ldpc_batch(batch, dev)
    decoders = [("ldpc", ldpc.decode), ("minsum", ldpc.decode_minsum)]
    if os.environ.get("WENET_BENCH_PALLAS") == "1":
        decoders.append(("pallas", lambda x: ldpc_onehot.decode_onehot(
            x, batch_tile=64)))
    for name, fn in decoders:
        t0 = time.perf_counter()
        bits = fn(llr)[0]
        fetch(bits)
        res[f"{name}_compile_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        for _ in range(reps):
            bits = fn(llr)[0]
        fetch(bits)
        res[f"{name}_codewords_per_s"] = round(
            batch * reps / (time.perf_counter() - t0), 0)
        whole = int((bits.cpu().numpy() == cw).all(axis=1).sum())
        res[f"{name}_codewords_ok"] = whole
        res[f"{name}_gate"] = whole >= batch - 2
    res["ldpc_codewords_sent"] = batch


# ------------------------------------------------------------------- main

STAGES = {"chain": stage_chain, "stream": stage_stream,
          "wideband": stage_wideband, "ldpc": stage_ldpc}


def run_stages(res: dict, dev: torch.device, cfg=None,
               stages: dict | None = None) -> dict:
    """Each stage in order; one that raises is recorded as
    `<stage>_error` (its traceback on stderr) and the next runs.  Returns
    what each stage that finished returned."""
    out = {}
    for name, stage in (STAGES if stages is None else stages).items():
        try:
            out[name] = stage(res, dev, cfg)
        except Exception as e:
            res[f"{name}_error"] = repr(e)[:160]
            traceback.print_exc()
    return out


def headline(res: dict) -> dict:
    """bench.py's line: the headline metric, then every result."""
    chain = res.get("full_chain_msps")
    stream = res.get("stream_ingest_msps")
    if chain:
        metric, value, unit = ("full_chain_iq_throughput", round(chain, 2),
                               "Msamples/s/chip")
        vs = round(chain / BASELINE_MSPS, 2)
    elif stream:
        metric, value, unit = ("stream_ingest_throughput", round(stream, 2),
                               "Msamples/s/chip")
        vs = round(stream / BASELINE_MSPS, 2)
    else:
        metric, value, unit = ("ldpc_decode_rate",
                               round(res.get("ldpc_codewords_per_s", 0.0),
                                     0), "codewords/s")
        vs = 0.0
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs, **res}


def kernel_launches() -> dict:
    """The launch counts of the card's kernels in this process (each
    wrapper counts where it launches; all 0 on the CPU)."""
    from .kernels import bp_decode, bp_onehot, channelize, crc_pack
    from .kernels import deframe_topk, fsk_demod
    return {"fsk_demod": fsk_demod.launches,
            "deframe_topk": deframe_topk.launches,
            "bp_decode": bp_decode.launches,
            "bp_minsum": bp_decode.minsum_launches,
            "bp_onehot": bp_onehot.launches, "crc_pack": crc_pack.launches,
            "channelize": channelize.launches}


def failures(res: dict) -> list:
    """The keys that make the run fail: stage errors, gates not held."""
    bad = [k for k in res if k.endswith("_error")]
    bad += [k for k, v in res.items() if k.endswith("_gate") and v is not True]
    if "stream_ingest_gate_failed" in res:
        bad.append("stream_ingest_gate_failed")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also append the line to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"platform": platform(dev)}
    run_stages(res, dev)
    res["kernel_launches"] = kernel_launches()
    line = json.dumps(headline(res))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    bad = failures(res)
    if bad:
        print(f"bench: failed: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
