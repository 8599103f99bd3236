"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from wenet_tpu_torch/csrc with nvcc (one process
per source, all at once) and holds each against its plain PyTorch version
on the card: the sum-product BP kernel, its min-sum variant and the one-hot
tensor-core BP kernel, at B = 16, 32, 70 and 128 (and the one-hot kernel
at B = 7), printing the one-hot kernel's launch shape (cluster, blocks,
shared memory per block) at each batch; and the demod frame-loop kernel
against its plain loop (valid, nin and f_est exact, hard bits where the
soft bit is clear of zero, soft bits within DEMOD_SOFT_TOL of the mean
|soft|; with the eye probe, high_sample exact and f_int within the same
share of its mean magnitude) on 600 frames of one lane and 120 frames of
16 lanes; the CRC kernel (bit-exact, B = 128 and 176, the Receiver's push
batches and the wideband fused step's 8 kk), the top-k acquisition kernel
(positions, exhausted picks and windows exact, LLRs within rtol 1e-5, and
the decodes of both LLRs equal) on the fused steps' soft bits (v2 and v1,
16 streams) and on the wideband fused mode's (8 streams, kk picks), the
streaming receivers' acquisition kernel (meta and positions equal to its
plain version and to the C FSM; one lane of a 2-s v2 and v1 push and 8
lanes of a wideband push, frames back to back, with the whole card
deframe of such a push timed), the
channelizer kernel (within 1e-5 of the output's rms; all 8 channels, a
selection, the capture's cu8 bytes read by the kernel (bit for bit the
float-pair route on the same samples), N = 6 read at run time, and N =
3228 at 4 taps a phase, the first version's largest, whose block keeps no
tile in flight, on Gaussian pairs) on an
8-channel wideband capture at 7.68 MHz, and the demod kernel on the
channelizer's 8 c64 lanes.  Kernel
times are CUDA-event times: for the BP kernels `ms` over replays of a
CUDA graph of many launches (the kernel alone) and `call_ms` over many
eager calls (the wrapper's host work included); for the demod kernel and
all plain versions, over eager calls.  Each time is printed beside its
bound (the larger of bytes at 3.35 TB/s and operations at 67 TFLOP/s,
counted from this run's data; for the demod kernel also a one-SM bound,
the operations at 67/132 TFLOP/s on each lane's SM, since a lane's frames
are serial) and the card's name and power limit.  The
gather probes' counterpart (the var -> edge gather inside the BP kernel)
gets its own bound and the time of torch.index_select at the probes'
shape.  Then it drives the port's paths, each with the launch counts set
to 0 just before it and read just after: the streaming receiver at the v2
and v1 flight geometries on synthetic captures (printing the decode batch
of each push), the v2 receiver again with the eye probe on (as the CLI
builds it unless --no-udp) and its stats record's eye diagram, a negative
probe below the decode cliff, the fused paths
(decode_iq_fused on both captures, decode_iq_fused_overlap, FusedReceiver
on the v2 capture three times over; one fused step's stages timed and
the device's busy share of a step and of a Receiver run from
torch.profiler, its kernels under 50), the wideband receive path
(`demod_multichannel` on 8 channels of 12 packets each, fused, vectorized
and per-Receiver: at least 11 packets a channel, the fused mode all 12,
the others the same lists less the packet a false UW lock costs the
reference's FSM; the capture quantised to cu8 bytes through the raw-cu8
route, fused and vectorized, equal to the float-pair route on the same
samples; the fused call's stages timed on both routes), the
`python -m wenet_tpu_torch rx` CLI streaming, with --parallel and
--slabs, and with --channels 8 (and --channel-select, and on the cu8
bytes); the decoder-throughput
stage of bench.py (B = 2048 at 7.5 dB); LDPC BER sweeps with both
algorithms; a full-chain PER sweep; the coarse acquisition search,
alone and through the CLI's --acquire, on a capture tuned 300 kHz off;
and the modem tools and the transmit side: `utils/probe.probe_demod` on
600 v2 frames (the demod kernel's PROBE variant, held against the plain
loop with traces and its soft bits bit-equal to the flight kernel's,
both timed in turns), `rx/selftest.run`, `python -m wenet_tpu_torch tx`
of 40 (v2) and 20 (v1) text messages at the flight geometries decoded
by `python -m wenet_tpu_torch rx --format c64` (every text back),
`cli/ber.run_ber` at two levels (at the higher, sync and a BER under
1e-3) and `cli/bench_demod.run_sweep` at three levels (decoded bytes
equal to the plain path's on the CPU, its table printed); then the apps
that the receiver feeds, at the v2 flight geometry: `LinkEmulator(
through_modem=True)` (texts and SimulatedGPS fixes all back, the same
packets as on the CPU), a flight capture made in-process (SimulatedGPS
fixes, texts and one SSDV image through PacketTX into an IQRadio c64
file) decoded by `python -m wenet_tpu_torch rx --format c64` (every GPS
record in the router's log, the image byte-equal to ssdv.decode of the
packets sent), and that capture through a Receiver with the eye probe
into a router whose UDP side-channels feed the web server's SSE stream
and /latest.jpg, the telemetry console and the modem-stats GUI model;
then the scale-out layer (`mesh`): two gloo ranks sharing the card,
started fresh by `parallel.dryrun.launch`, run decode_iq_fused and
decode_iq_parallel with the chunks split over them, chain_per_sweep and
ldpc_ber_sweep split over them, and decode_sharded (B = 128, tp = 2),
each equal to the unsharded call (to bp_decode.cu for the BP), every
rank launching the four receive kernels, and one NCCL rank runs
decode_iq_fused with its gather through NCCL; and the JAX package's
golden flight-rate tables (`golden`: tests/golden/, every row within
two packets, the cliff and the envelope) through the port's Receiver.
The host runtime (`native`): the C UW FSM of csrc/deframe_fsm.c, built
with the host C compiler beside the kernels, against its numpy version
(positions and final buffers exact) on the v2 and v1 captures, whole and
across the Receiver's 2-s pushes, and on each wideband channel (the
false lock in both), each FSM's ms per Msymbol, and the Receiver and the
wideband FSM modes re-timed beside the numpy FSM's earlier figures; and
the deploy script (`deploy`): wenet_tpu_torch/deploy/start_rx.sh with a fake
rtl_sdr at the v1 and v2 flight rates, its rtl_sdr arguments and the
router's image equal to an in-process Receiver's on the same bytes.
The measurement tools (`tools`, wenet_tpu_torch/tools, with the six
receive kernels' counts zeroed before and read after): chain_scaling at
B = 8-64, loss_census (B=16, R=4), minsum_scaling at B = 128-8192 for
both decoders, wideband_scaling at N = 4, 8, 16 (every channel
complete), pp_breakdown on v2 and v1 (the Receiver's payloads),
stream_tune on a 20-s capture (its lists within the packets sent and
each ingest list equal to its on-device program's) and the stage splits
of fused_where, fused_profile and wideband_where; then chain_lanes and
the census at B=2 against the plain versions on the same noise, and the
iteration histograms at B=512 against the plain decoders'.
Each phase prints one line (the receive paths their Msamples/s beside
real time); any failed check raises, so the script exits non-zero before
its last line.  The last three lines are a JSON object with the kernels'
numbers, the card's name and power limit, and a JSON object with the
device.  Without a CUDA device the script fails at once.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
V2_PACKETS = 40
V1_PACKETS = 20
EBNO_DB = 12.0
# (batch, dB): the v2 capture's push batches (16, 32: clustered launches),
# a flight-traffic push (70) and its power-of-two bucket (128)
BP_CASES = ((16, 2.5), (32, 2.5), (70, 2.5), (128, 2.5), (128, 3.0),
            (128, 6.0))
MAIN_CASE = (128, 2.5)        # the v2 push's bucketed batch, slow codewords
STAGE_BATCH = 2048            # bench.py stage_ldpc
STAGE_EBNO_DB = 7.5
STAGE_BATCH_TILE = 64         # bench.py's decode_pallas(..., batch_tile=64)
PROBE_SHAPE = (8, 256, 512)   # tools/pallas_gather_probe.py: X (8, 256) f32,
#                               IDX (512,) i32
SWEEP_EBNO_DB = (1.5, 2.5, 3.5, 5.0)
ACQ_PACKETS = 4
ACQ_SHIFT_HZ = 300e3
ACQ_LOCK_HZ = (132e3, 468e3)  # offsets that bring both tones into the band
DEMOD_CASES = ((1, 600), (16, 120))  # (lanes, frames) of demod_vs_plain
#                               (the lane path: short calls)
# (mode, lanes, frames) of demod_vs_plain at the main path's 2-s pushes:
# one lane of v2 and of v1 (the frame-parallel path) and the wideband
# receiver's eight v2 lanes (the lane path, as the shape rule has it)
DEMOD_PUSH_CASES = (("v2", 1, 4000), ("v1", 1, 4800), ("v2", 8, 4000))
DEMOD_LANE_STRIDE = 30000     # samples between the lanes' starts
DEMOD_SOFT_TOL = 1e-4         # max |d soft| / mean |soft|: summation order
DEMOD_BIT_TOL = 1e-3          # hard bits compared where |soft| > this share
FUSED_CHUNKS = 16             # decode_iq_fused's default
OVERLAP_SLABS, OVERLAP_CHUNKS = 4, 4
RX_TILES = 3                  # FusedReceiver: the v2 capture three times over
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 rate; FP32 peak below
FP32_OPS_PER_S = 67e12
SMS = 132
CRC_BATCHES = (128, 176)      # crc_pack: the BP cases' main batch, the
#                               fused step's C*k (the Receiver's push
#                               batches and the wideband fused C*k are
#                               added as the run meets them)
WIDE_CHANNELS = 8             # wideband: 8 channels of V2_CONFIG, 7.68 MHz
WIDE_PACKETS = 12             # a channel's packets (tools/wideband_scaling)
WIDE_EBNO_DB = 30.0           # per channel
WIDE_SELECT = (6, 1, 3)       # a channel selection, in this order
# (channel, packet) that the reference's UW FSM loses to a false UW lock on
# this capture, and top-k acquisition keeps; the JAX package does the same
# (tests/test_torch_channelizer.py::test_false_uw_lock_matches_jax)
WIDE_FALSE_LOCK = (6, 9)
CHANNELIZE_TOL = 1e-5         # max |d| / rms of the channelizer's output
WIDE_CU8_SCALE = 1 / 8        # the capture quantised to cu8 after this
#                               scale: 8 unit-amplitude channels peak near 8
RUNTIME_N = 6                 # a channel count the kernel reads at run time
WIDE_N = 256                  # more phases than the kernel's FIR threads
WIDE_N_SELECT = (255, 3, 128)
RUNTIME_TAPS = 16             # taps a phase read at run time
TOPK_LLR_RTOL = 1e-5          # sd_to_llr's sums in another order
CALL_REPS = 200               # eager calls behind the CRC and acquisition
#                               kernels' call_ms (the host's share is noisy)
VALID_EDGES = 7223            # of the 516 x 14 edge slots of H2064_516
PROBE_FRAMES = 600            # probe: v2 frames through utils/probe
TRACE_TOL = 1e-5              # probe traces f_int, EMA: max |d| / rms
TXRX_TEXTS = {"v2": 40, "v1": 20}    # tx_rx: text messages a mode
BER_EBNO_DB = (9.0, 13.0)     # ber: the higher syncs with BER < 1e-3
BER_SECONDS = 2.0
BENCH_PACKETS = 20            # bench: run_sweep("v2", 20, BENCH_EBNO_DB)
BENCH_EBNO_DB = (7.0, 7.5, 12.0)  # a few, most, all packets at flight rate
REACH = (3228, 4)             # channelize: the first version's largest N
#                               at 4 taps a phase (no tile in flight)
LINK_TEXTS, LINK_FIXES = 4, 4  # link: texts and GPS fixes through the
#                               link emulator at the v2 flight geometry
FLIGHT_FIXES, FLIGHT_TEXTS = 10, 3   # flight: GPS fixes and texts
FLIGHT_IDLES = 4              # flight: idle packets before the capture's
FLIGHT_IMAGE = (320, 240)     # flight: the SSDV image's width, height
MESH_RANKS = 2                # mesh: gloo ranks sharing the card
MESH_CHAIN_DB, MESH_CHAIN_TRIALS = [4.0, 20.0], 8   # chain_per_sweep
MESH_BER_DB, MESH_BER_CODEWORDS = [2.5, 3.5], 2048  # ldpc_ber_sweep
MESH_BP = (128, 2.5)          # decode_sharded: codewords, Es/N0 dB; tp = 2
# native: PERF.md section 5's earlier figures of the numpy UW FSM (measured
# on one NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's
# rates under the C FSM: (Msamples/s, demod_share, deframe_share), None
# where PERF.md has no figure
NUMPY_FSM_RATES = {"receiver_v2": (31.8650, 0.483, 0.515),
                   "receiver_v1": (35.3828, None, None),
                   "wideband_vectorized": (48.6092, None, None),
                   "wideband_receiver": (24.5960, None, None)}
FSM_REPS = 5                  # native: timed calls of each UW FSM
PUSH_SECONDS = 2.0            # native: the Receiver's push, in seconds
DEPLOY_IMAGE = (160, 128)     # deploy: the SSDV image's width, height
# deploy: start_rx.sh's environment at each flight rate (the script's
# defaults are v1's 115177 Bd x 8)
DEPLOY_SETTINGS = (("v1", {}),
                   ("v2", {"BAUD_RATE": "96000", "OVERSAMPLING": "10"}))
DEPLOY_RXFREQ = 443500000     # start_rx.sh's default centre frequency
TOOL_CHAIN_B = (8, 16, 32, 64)          # tools: chain_scaling's B
TOOL_MINSUM_B = (128, 512, 2048, 8192)  # tools: minsum_scaling's B
TOOL_WIDE_N = (4, 8, 16)      # tools: wideband_scaling's channel counts
TOOL_PP_SECONDS = 8.0         # tools: pp_breakdown's capture, each mode
TOOL_STREAM_SECS = 20.0       # tools: stream_tune's and the splits' capture
PP_PUSH_SECONDS = 2.0         # pipelined: the Receiver's push, seconds
PORT_BENCH_ENV = {            # port_bench: the one-hot decoder on, and the
    "WENET_BENCH_PALLAS": "1",  # stream stage on the tools' 20-s capture
    "WENET_BENCH_STREAM_SECS": str(int(TOOL_STREAM_SECS))}
PORT_BENCH_STREAMS = 256      # port_bench: the chain stage's B
CORPUS_IMAGES = 2             # corpus: synthetic images, 800 x 608
CORPUS_FUSED = 16             # corpus: --fused chunks
DEPLOY_UNSET = ("MYCALL", "RXFREQ", "GAIN", "BIAS", "BAUD_RATE",
                "OVERSAMPLING", "FRAMING_MODE", "DEVICE", "RX_DEVICE",
                "RX_FLOW")    # start_rx.sh's variables, left at its defaults


def require(ok, msg: str):
    """Fail the run (checks must hold even under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def make_capture(cfg, mode, payloads, ebno_db, rng, shift_hz=0.0):
    """Framed packets with random idle bits between them -> FSK -> a
    frequency shift -> AWGN -> cu8 bytes."""
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import channel, fsk, ldpc

    bits = [rng.integers(0, 2, 4000).astype(np.uint8)]
    for p in payloads:
        frame = framing.frame_packet(p, ldpc.encode_bytes, mode=mode)
        bits.append(framing.frame_to_bits(frame, mode))
        bits.append(rng.integers(0, 2, int(rng.integers(3000, 6000))
                                 ).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    if shift_hz:
        sig = channel.freq_shift(sig, shift_hz, cfg.Fs)
    return fsk.iq_to_cu8(channel.add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs,
                                          rng=rng))


def text_message(message: str, count: int) -> bytes:
    """Wenet text-message packet: type 0x00, length, big-endian count,
    ASCII text."""
    return (b"\x00" + struct.pack(">BH", len(message), count)
            + message.encode("ascii"))


def event_ms(fn, n):
    """CUDA-event ms per call over n eager calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def graph_ms(fn, n=20, replays=5):
    """CUDA-event ms per launch over replays of a CUDA graph of n calls:
    the device time of the kernel without the wrapper's host work."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.synchronize()
    return event_ms(graph.replay, replays) / n


def bp_bound(batch, iters_total, table_bytes, minsum, log_ops=1, tanh_ops=1):
    """(bound ms, 'bytes' or 'operations') of one BP decode: the llr in, the
    tables in, bits, iterations and parity flags out, each once, at
    HBM_BYTES_PER_S; and the reference's float32 operations for the
    iterations this run took, at FP32_OPS_PER_S.  Per valid edge and
    iteration, sum-product: q = qi - r, |q|, x * 0.5, tanh, log, negate,
    the check sum; acc - m, x * 0.5, tanh, log, negate, the sign; the var
    sum (10 + 2 tanh + 2 log); min-sum: q, |q|, two minima, the scaled
    select, the sign, the var sum (7).  logf and tanhf count log_ops and
    tanh_ops each."""
    per_edge = 7 if minsum else 10 + 2 * (log_ops + tanh_ops)
    ops = iters_total * VALID_EDGES * per_edge
    nbytes = batch * (4 * 2580 + 2580 + 4 + 1) + table_bytes
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


PROBE_SRC = r"""
extern "C" __global__ void probe_half(float* x) { x[threadIdx.x] *= 0.5f; }
extern "C" __global__ void probe_logf(float* x) {
    x[threadIdx.x] = logf(x[threadIdx.x]);
}
extern "C" __global__ void probe_tanhf(float* x) {
    x[threadIdx.x] = tanhf(x[threadIdx.x]);
}
"""


def libdevice_expansion(nvcc, flags, build_dir):
    """Static SASS instructions of logf and tanhf as the BP kernel is built
    (the kernels' nvcc flags): a probe kernel of each, less one that
    only scales its input, counted with cuobjdump."""
    import re
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "libdevice_probe.cu")
    cubin = os.path.join(build_dir, "libdevice_probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    cflags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC",
                                            "-Xptxas=-v")]
    subprocess.run([nvcc, *cflags, "-cubin", "-o", cubin, src], check=True,
                   capture_output=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]", line) \
                and " NOP" not in line:
            counts[name] += 1
    base = counts["probe_half"]
    return {"logf": counts["probe_logf"] - base,
            "tanhf": counts["probe_tanhf"] - base}


def mismatches(got, want):
    """(codewords differing in bits, in iters, in parity_ok; max |diff|)
    of two (bits, iters, parity_ok) results."""
    bk, ik, ok_k, br, ir, ok_r = (t.cpu().numpy() for t in (*got, *want))
    err = max(int(np.abs(bk.astype(int) - br).max(initial=0)),
              int(np.abs(ik - ir).max(initial=0)))
    return (int((bk != br).any(axis=1).sum()), int((ik != ir).sum()),
            int((ok_k != ok_r).sum()), err)


def noisy_llrs(n, snr_db, rng, dev):
    """LLRs of n random codewords at Es/N0 = snr_db (rate 0.8) on dev."""
    import torch
    from wenet_tpu_torch.ops import ldpc
    ib = np.unpackbits(rng.integers(0, 256, (n, 258), dtype=np.uint8),
                       axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (snr_db / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32,
                                          device=dev))


def run_receiver(cfg, mode, raw, pipelined=False, chunk_seconds=2.0,
                 with_eye=False, input_format="cu8"):
    from wenet_tpu_torch.rx.pipeline import Receiver
    import torch

    rx = Receiver(mode=mode, cfg=cfg, input_format=input_format,
                  device="cuda", pipelined=pipelined, with_eye=with_eye)
    step = (2 if input_format == "cu8" else 1) * int(cfg.Fs * chunk_seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = []
    for i in range(0, len(raw), step):
        got += rx.push(raw[i:i + step])
    got += rx.flush()
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, rx


def n_pushes(cfg, raw, chunk_seconds=2.0) -> int:
    """The pushes `run_receiver` makes of a cu8 capture."""
    return -(-len(raw) // (2 * int(cfg.Fs * chunk_seconds)))


def run_cli(path, *args, fmt="cu8"):
    """`python -m wenet_tpu_torch rx path ...` -> (rc, last stderr line,
    stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx", path, "--format",
         fmt, "--no-udp", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    err = proc.stderr.strip()
    line = err.splitlines()[-1] if err else ""
    return proc.returncode, line, proc.stderr, dt


def demod_compare(got, want):
    """Mismatches of the demod kernel against its plain loop: frames whose
    valid flag differs, valid frames whose nin or f_est differs, hard bits
    that differ where |soft| > DEMOD_BIT_TOL of the mean |soft|; max |d
    soft| and its share of the mean |soft| on valid frames; with eye
    probes, lanes whose ok or high_sample differs and the largest |d f_int|
    as a share of the mean |f_int|."""
    (_, go), (_, wo) = got[:2], want[:2]
    g = {k: v.cpu().numpy() for k, v in go._asdict().items()}
    w = {k: v.cpu().numpy() for k, v in wo._asdict().items()}
    v = w["valid"]
    scale = float(np.abs(w["soft"][v]).mean())
    clear = np.abs(w["soft"][v]) > DEMOD_BIT_TOL * scale
    err = float(np.abs(g["soft"][v] - w["soft"][v]).max())
    out = {"valid": int((g["valid"] != v).sum()),
           "nin": int((g["nin"][v] != w["nin"][v]).sum()),
           "f_est": int((g["f_est"][v] != w["f_est"][v]).any(-1).sum()),
           "bits": int((g["bits"][v][clear] != w["bits"][v][clear]).sum()),
           "max_abs_err": err, "rel_err": err / scale,
           "frames": int(v.sum())}
    if len(got) == 3:
        ge, we = got[2], want[2]
        fw = we.f_int.cpu().numpy()
        out["eye"] = int((ge.ok.cpu() != we.ok.cpu()).sum()
                         + (ge.high_sample.cpu() != we.high_sample.cpu()).sum())
        out["eye_rel_err"] = float(np.abs(ge.f_int.cpu().numpy() - fw).max()
                                   / np.abs(fw).mean())
    return out


def demod_bound(cfg, outs, n_samples, bytes_per_sample, traces=False):
    """(bound ms, 'bytes' or 'operations', one-SM bound ms) of one
    frame-loop call from the frames this run's data made valid.  Bytes:
    the lanes' raw samples read once, the frame outputs and the states
    written once (with traces, the PROBE variant's: also each frame's
    integrators, EMA, timing and high sample written once).  Operations (float32 and float64 alike, at
    FP32_OPS_PER_S): per estimator block used, the Hann window (2 a
    sample), the DFT (8 a sample and bin) and the magnitude and EMA (6 a
    bin); M peak picks over the bins; per tone and window sample the angle
    (6), cos and sin (1 each) and the mix (6); the window sums (2 a sample
    and integrator); the timing line (3 a tone and integrator, 4 an
    integrator); the decisions (8 a tone and symbol).  A lane's frames are
    serial, so the one-SM bound is the operations at FP32_OPS_PER_S / SMS
    on each of min(lanes, SMS) SMs."""
    valid = outs.valid.cpu().numpy()
    nins = outs.nin.cpu().numpy()[valid]
    half, M, Nmem = cfg.Ndft // 2, cfg.M, cfg.Nmem
    NP = (cfg.Nsym + 1) * cfg.P
    rest = (M * half + M * Nmem * 14 + M * NP * (cfg.Ts - 1) * 2
            + NP * (3 * M + 4) + cfg.Nsym * M * 8)
    ops = 0
    for nin in nins:
        nb = int(nin) // cfg.Ndft
        fs = sum(min(max(int(nin) - (j + 1) * cfg.Ndft, 0), cfg.Ndft)
                 for j in range(nb))
        ops += fs * (2 + 8 * half) + nb * half * 6 + rest
    L, nf = valid.shape
    nbytes = (n_samples * bytes_per_sample
              + L * nf * (5 * cfg.Nbits + 4 * M + 13)
              + 2 * L * (4 * half + 8 * M + 24)
              + (L * nf * (8 * M * NP + 4 * half + 8) if traces else 0))
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    one_sm = ops / (FP32_OPS_PER_S / SMS * min(L, SMS))
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", one_sm * 1e3)


def device_busy(fn, per_kernel=None):
    """(host wall s, device kernel ms, kernels) of one call of fn under
    torch.profiler: the summed durations of the CUDA kernels it traced
    (None when the profiler records no device events).  per_kernel, a
    dict, receives each traced kernel name's summed ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kern:
        return wall, None, 0
    for e in kern if per_kernel is not None else ():
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
    return wall, sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)


def bound_ms(nbytes, ops):
    """(bound ms, 'bytes' or 'operations'): the larger of nbytes at
    HBM_BYTES_PER_S and ops at FP32_OPS_PER_S."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def crc_bound(B):
    """One crc_pack call on B codewords with positions: the 2064 packet
    bits and the position read once, the 263-byte row written once; per
    codeword 7 operations a byte to pack it and 4 a byte of CRC, and the
    trailer compare."""
    return bound_ms(B * (2064 + 4 + 263), B * (258 * 7 + 256 * 4 + 2))


def topk_bound(C, n, k, nlive, nuw):
    """One acquisition call: the soft bits read once, the LLRs, positions
    and exhausted flags written once; per placeable start the correlation
    (nuw multiply-adds) and k compares for the picks; per window symbol
    the gather, the descramble, |sd| and x, x^2 and the LLR (about 10)."""
    return bound_ms(4 * C * n + C * k * (4 * 2580 + 5),
                    C * nlive * (2 * nuw + k) + C * k * 2580 * 10)


def channelize_bound(n, N, T, nsel, in_bytes=8):
    """One channelizer call: the samples read once (8 bytes as float
    pairs, 2 as cu8), the selected channels written once; per frame the N
    phases' T complex-by-real multiply-adds (4 each) and each selected
    channel's N complex multiply-adds (8)."""
    F = n // N
    return bound_ms(in_bytes * n + 8 * nsel * F,
                    F * (N * T * 4 + nsel * N * 8))


def probe_phase(cfg, raw, dev, smi) -> dict:
    """probe: utils/probe.probe_demod on PROBE_FRAMES v2 frames (one launch
    of the PROBE variant, the count read around the call), held against
    the plain loop with traces on the card (valid, nin, high sample exact;
    soft bits within DEMOD_SOFT_TOL of the mean |soft|; f_int and the EMA
    within TRACE_TOL of their rms; rx_timing within 1e-4), and its rx_sd
    bit-equal to demod_iq_np (the flight kernel) on the same capture.
    Times: the PROBE variant and the flight kernel on the same tensor, in
    turns (flight, probe, probe, flight), and the plain loop once."""
    import torch
    from wenet_tpu_torch.kernels import fsk_demod
    from wenet_tpu_torch.ops import fsk
    from wenet_tpu_torch.utils import probe

    iq = fsk.iq_from_cu8(raw[: 2 * PROBE_FRAMES * cfg.N])
    fsk_demod.launches = fsk_demod.probe_launches = 0
    traces = probe.probe_demod(cfg, iq)
    launches = fsk_demod.probe_launches
    require(launches == 1 and fsk_demod.launches == 0,
            f"probe: {launches} PROBE and {fsk_demod.launches} flight "
            "launches")
    x = torch.from_numpy(iq).to(dev)
    nf = cfg.num_frames(len(iq))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, wo, wt = fsk.demod_stream_reference(cfg, x, nf, with_probe=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    v = wo.valid.cpu().numpy()
    require(np.array_equal(traces["valid"], v) and v.sum() >= PROBE_FRAMES - 2,
            f"probe: {int(v.sum())} valid frames")
    for k, want in (("t_nin", wo.nin), ("t_high_sample", wt.high_sample),
                    ("t_f_est", wo.f_est)):
        require(np.array_equal(traces[k][v], want.cpu().numpy()[v]),
                f"probe: {k} differs from the plain loop")
    soft_w = wo.soft.cpu().numpy()[v]
    scale = float(np.abs(soft_w).mean())
    err = float(np.abs(traces["rx_sd"][v] - soft_w).max())
    require(err <= DEMOD_SOFT_TOL * scale, f"probe: soft {err} of {scale}")
    require(np.allclose(traces["t_rx_timing"][v],
                        wt.rx_timing.cpu().numpy()[v], rtol=1e-4, atol=1e-4),
            "probe: rx_timing")
    rel = {}
    for k, want in (("t_f_int", wt.f_int), ("t_fft_est", wt.fft_est)):
        w = want.cpu().numpy()[v]
        rel[k] = float(np.abs(traces[k][v] - w).max()
                       / np.sqrt(np.mean(np.abs(w) ** 2)))
        require(rel[k] <= TRACE_TOL, f"probe: {k} {rel[k]:.3e} of its rms")
    soft_k, _, _ = fsk.demod_iq_np(cfg, iq)
    require(np.array_equal(traces["rx_sd"][v].reshape(-1), soft_k),
            "probe: rx_sd differs from demod_iq_np on the same capture")

    def flight():
        return fsk.demod_stream(cfg, x, nf)

    def probed():
        return fsk.demod_stream(cfg, x, nf, with_probe=True)
    t = [event_ms(fn, 5) for fn in (flight, probed, probed, flight)]
    ms, flight_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    bound, by, bound_sm = demod_bound(   # wo with a lane axis of 1
        cfg, type(wo)(*(t[None] for t in wo)), len(iq), 8, traces=True)
    frames = int(v.sum())
    say("probe", kernel="fsk_demod_probe", frames=frames,
        max_abs_err=f"{err:.3e}", rel_err=f"{err / scale:.3e}",
        tol=DEMOD_SOFT_TOL, f_int_rel_err=f"{rel['t_f_int']:.3e}",
        fft_est_rel_err=f"{rel['t_fft_est']:.3e}", trace_tol=TRACE_TOL,
        rx_sd_equals_demod_iq_np=True, launches=launches,
        kernel_ms=f"{ms:.4f}", kernel_ms_per_frame=f"{ms / frames:.5f}",
        flight_kernel_ms=f"{flight_ms:.4f}",
        flight_ms_per_frame=f"{flight_ms / frames:.5f}",
        turns_ms=[round(x_, 4) for x_ in t], plain_ms=f"{plain_ms:.2f}",
        plain_ms_per_frame=f"{plain_ms / frames:.4f}",
        bound_ms=f"{bound:.6f}", bound_by=by,
        share_of_bound=f"{bound / ms:.5f}", bound_one_sm_ms=f"{bound_sm:.6f}",
        card=repr(smi))
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "flight_ms": flight_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "bound_one_sm_ms": bound_sm, "frames": frames,
            "trace_rel_err": max(rel.values())}


def receive_counts():
    """Launch counts of the three kernels every receive path runs."""
    from wenet_tpu_torch.kernels import bp_decode, crc_pack, fsk_demod
    return {"fsk_demod": fsk_demod.launches, "bp_decode": bp_decode.launches,
            "crc_pack": crc_pack.launches}


def zero_receive_counts():
    from wenet_tpu_torch.kernels import bp_decode, crc_pack, fsk_demod
    fsk_demod.launches = bp_decode.launches = crc_pack.launches = 0


def selftest_phase(smi):
    """selftest: rx/selftest.run on the card returns 0, through the BP,
    demod and CRC kernels (counts zeroed before, read after)."""
    from wenet_tpu_torch.rx import selftest

    zero_receive_counts()
    t0 = time.perf_counter()
    rc = selftest.run(verbose=True, device="cuda")
    dt = time.perf_counter() - t0
    counts = receive_counts()
    require(rc == 0, f"selftest returned {rc}")
    require(all(counts.values()), f"selftest: launches {counts}")
    say("selftest", rc=rc, wall_s=f"{dt:.3f}", launches=counts,
        card=repr(smi))


def run_module(*args, timeout=600):
    """`python -m wenet_tpu_torch *args` -> (rc, stderr, seconds)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "wenet_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc.returncode, proc.stderr, time.perf_counter() - t0


def tx_rx_phase(tmp, modes, smi):
    """tx_rx: `python -m wenet_tpu_torch tx` writes TXRX_TEXTS[mode] text
    messages at each flight geometry as c64, and `python -m wenet_tpu_torch
    rx --format c64` (on the card) recovers every one, read back from its
    text log."""
    import glob
    for mode, cfg in modes:
        texts = [f"tx_rx {mode} message {i}" for i in range(TXRX_TEXTS[mode])]
        cap = os.path.join(tmp, f"tx_{mode}.c64")
        geom = ("--fs", str(cfg.Fs), "--rs", str(cfg.Rs))
        rc, err, tx_s = run_module("tx", "--out", cap, "--mode", mode,
                                   "--text", *texts, *geom)
        require(rc == 0, f"tx_rx {mode}: tx exit {rc}: {err}")
        logs = os.path.join(tmp, f"tx_rx_logs_{mode}")
        rc, err, rx_s = run_module(
            "rx", cap, "--format", "c64", "--mode", mode, *geom, "--no-udp",
            "--image-dir", os.path.join(tmp, f"tx_rx_img_{mode}"),
            "--log-dir", logs)
        require(rc == 0, f"tx_rx {mode}: rx exit {rc}: {err}")
        got = []
        for path in glob.glob(os.path.join(logs, "*_text.log")):
            with open(path) as fh:
                got += [json.loads(ln)["text"] for ln in fh]
        require(sorted(got) == sorted(texts),
                f"tx_rx {mode}: {len(got)} of {len(texts)} texts back")
        line = err.strip().splitlines()[-1]
        say("tx_rx", mode=mode, texts=f"{len(got)}/{len(texts)}",
            capture_bytes=os.path.getsize(cap), tx_wall_s=f"{tx_s:.2f}",
            rx_wall_s=f"{rx_s:.2f}", rx_stderr=repr(line), card=repr(smi))


def ber_phase(cfg, smi):
    """ber: cli/ber.run_ber on BER_SECONDS of the v2 flight geometry at
    each of BER_EBNO_DB through the demod kernel (one launch a level); at
    the higher level the testframe syncs with a BER under 1e-3."""
    from wenet_tpu_torch.cli import ber
    from wenet_tpu_torch.kernels import fsk_demod

    fsk_demod.launches = 0
    t0 = time.perf_counter()
    res = [ber.run_ber(cfg, e, BER_SECONDS) for e in BER_EBNO_DB]
    dt = time.perf_counter() - t0
    require(fsk_demod.launches == len(BER_EBNO_DB),
            f"ber: {fsk_demod.launches} fsk_demod launches")
    require(res[-1]["sync_found"] and res[-1]["ber"] < 1e-3,
            f"ber at {BER_EBNO_DB[-1]} dB: {res[-1]}")
    say("ber", ebno_db=list(BER_EBNO_DB), seconds=BER_SECONDS,
        bits=[r["bits"] for r in res], errs=[r["errs"] for r in res],
        ber=[f"{r['ber']:.3e}" for r in res],
        sync_found=[r["sync_found"] for r in res],
        launches=fsk_demod.launches, wall_s=f"{dt:.3f}", card=repr(smi))


def bench_phase(smi):
    """bench: cli/bench_demod.run_sweep("v2", BENCH_PACKETS, BENCH_EBNO_DB)
    through the Receiver on the card (counts zeroed before, read after),
    its table printed; the decoded bytes at each level equal the plain
    path's (device="cpu") on the same captures, all packets at the top
    level."""
    from wenet_tpu_torch.cli import bench_demod

    zero_receive_counts()
    lines = []
    res = bench_demod.run_sweep("v2", BENCH_PACKETS, BENCH_EBNO_DB,
                                log=lines.append)
    counts = receive_counts()
    require(all(counts.values()), f"bench: launches {counts}")
    t0 = time.perf_counter()
    plain = bench_demod.run_sweep("v2", BENCH_PACKETS, BENCH_EBNO_DB,
                                  log=lambda *a: None, device="cpu")
    plain_s = time.perf_counter() - t0
    require([r[1] for r in res] == [r[1] for r in plain],
            f"bench: {[r[1] for r in res]} bytes against the plain path's "
            f"{[r[1] for r in plain]}")
    require(res[-1][1] == 256 * BENCH_PACKETS, f"bench: {res[-1]}")
    for ln in lines:
        print(f"[bench] {ln}", flush=True)
    say("bench", ebno_db=list(BENCH_EBNO_DB), packets=BENCH_PACKETS,
        decoded_bytes=[r[1] for r in res],
        runtime_s=[f"{r[2]:.4f}" for r in res],
        plain_decoded_bytes=[r[1] for r in plain],
        plain_wall_s=f"{plain_s:.2f}", launches=counts, card=repr(smi))



def free_ports(n):
    """n localhost UDP ports the OS reports free (bound to 0, released)."""
    import socket
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def tx_payload(frame: bytes) -> bytes:
    """The 256-byte payload of a v2 frame (preamble and UW stripped,
    descrambled, CRC and parity dropped)."""
    from wenet_tpu_torch.core import framing
    return framing.tx_scramble(frame[20:])[:framing.PAYLOAD_BYTES]


def link_phase(cfg, smi):
    """link: examples/link_emulation.LinkEmulator(through_modem=True) at
    the v2 flight geometry on the card: LINK_TEXTS text messages and
    LINK_FIXES SimulatedGPS fixes through PacketTX, drained, a trailing
    idle.  Every message comes back, and the packets received equal those
    of a second emulator on the CPU fed the same frames (the GPS packets
    carry the host's load and temperature, so the frames are replayed,
    not made again)."""
    from wenet_tpu_torch.examples.link_emulation import LinkEmulator
    from wenet_tpu_torch.tx.gps import SimulatedGPS

    tel_port, = free_ports(1)
    zero_receive_counts()
    t0 = time.perf_counter()
    emu = LinkEmulator(tx_port=None, telemetry_port=tel_port,
                       through_modem=True, cfg=cfg, device="cuda")
    frames = []
    on_frame = emu.tx.radio.on_frame
    emu.tx.radio.on_frame = lambda f: (frames.append(f), on_frame(f))
    texts = [f"link message {i}" for i in range(LINK_TEXTS)]
    for t in texts:
        emu.tx.transmit_text_message(t)
    gps = SimulatedGPS(realtime=False)
    for _ in range(LINK_FIXES):
        emu.tx.transmit_gps_telemetry(gps.step())
    emu.drain()
    emu.tx.radio.transmit_packet(emu.tx.idle_message)
    emu.close()
    dt = time.perf_counter() - t0
    counts = receive_counts()
    sent = [tx_payload(f) for f in frames if f != emu.tx.idle_message]
    require(len(sent) == LINK_TEXTS + LINK_FIXES, f"link: {len(sent)} sent")
    require(emu.packets_received == sent,
            f"link: {len(emu.packets_received)} of {len(sent)} back")
    require(all(counts.values()), f"link: launches {counts}")
    t0 = time.perf_counter()
    plain = LinkEmulator(tx_port=None, telemetry_port=tel_port,
                         through_modem=True, cfg=cfg, device="cpu")
    for f in frames:
        plain.tx.radio.transmit_packet(f)
    plain.close()
    plain_s = time.perf_counter() - t0
    require(plain.packets_received == emu.packets_received,
            "link: the card's packets differ from the CPU's")
    say("link", texts=LINK_TEXTS, fixes=LINK_FIXES, frames=len(frames),
        packets=f"{len(emu.packets_received)}/{len(sent)}",
        equal_to_cpu=True, wall_s=f"{dt:.3f}", cpu_wall_s=f"{plain_s:.3f}",
        launches=counts, card=repr(smi))


def payload_digest(payloads):
    """[count, sha256 of the payloads in order]: a list compared whole."""
    return [len(payloads), hashlib.sha256(b"".join(payloads)).hexdigest()]


def as_lists(result: dict) -> dict:
    """A sweep's dict with its arrays as lists (as JSON carries them)."""
    return {k: np.asarray(v).tolist() for k, v in result.items()}


def bits_digest(bits) -> str:
    """sha256 of a decode's bits tensor."""
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()


def mesh_rank(path, stages, device="cuda"):
    """The rank side of the mesh phase, run in every rank by
    `parallel.dryrun.launch`: each of `stages` once on the parent's inputs
    (the v2 capture's cu8 bytes, the LLRs), with the four receive kernels'
    launch counts zeroed before it and read after, and its wall."""
    import torch
    from wenet_tpu_torch.kernels import bp_decode, crc_pack, deframe_topk
    from wenet_tpu_torch.kernels import fsk_demod
    from wenet_tpu_torch.ops import fsk
    from wenet_tpu_torch.parallel import sharded_ldpc, sweep
    from wenet_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from wenet_tpu_torch.rx import pipeline

    kern = {"fsk_demod": fsk_demod, "deframe_topk": deframe_topk,
            "bp_decode": bp_decode, "crc_pack": crc_pack}
    d = np.load(path)
    mesh = make_mesh(device=device)
    out = {"backend": mesh.backend, "device": str(mesh.device),
           "launches": {}}

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def run(name, fn):
        for m in kern.values():
            m.launches = 0
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        out["launches"][name] = {k: m.launches for k, m in kern.items()}
        return res

    digest, listed = payload_digest, as_lists
    meshes = [mesh]
    if "fused" in stages:
        out["fused"] = digest(run("fused", lambda: pipeline.decode_iq_fused(
            d["raw"], "v2", n_chunks=FUSED_CHUNKS, mesh=mesh)))
    if "parallel" in stages:
        out["parallel"] = digest(run(
            "parallel", lambda: pipeline.decode_iq_parallel(
                d["raw"], "v2", n_chunks=FUSED_CHUNKS, input_format="cu8",
                mesh=mesh)))
    if "sweeps" in stages:
        out["chain"] = listed(run("chain", lambda: sweep.chain_per_sweep(
            fsk.V2_CONFIG, MESH_CHAIN_DB, MESH_CHAIN_TRIALS, mesh=mesh)))
        out["ber"] = listed(run("ber", lambda: sweep.ldpc_ber_sweep(
            MESH_BER_DB, MESH_BER_CODEWORDS, mesh=mesh)))
    if "sharded" in stages:
        mesh2 = make_mesh_2d(mesh.size // 2, 2, device=device)
        meshes.append(mesh2)
        llr = torch.from_numpy(d["llr"]).to(mesh2.device)
        bits, iters, ok = run("sharded", lambda: sharded_ldpc.decode_sharded(
            llr, mesh2))
        loops = int(iters.max())          # the loop stops at the slowest
        wall = out["sharded_wall_s"]
        out["sharded"] = {
            "bits": bits_digest(bits), "iters": iters.tolist(), "ok": ok.tolist(), "loops": loops,
            "ms_per_iter": wall * 1e3 / loops,
            "collective_share": mesh2.collective_s / wall,
            "collectives": mesh2.collectives,
            "staged_bytes": mesh2.staged_bytes}
    out["staged_bytes"] = sum(m.staged_bytes for m in meshes)
    return out


def mesh_phase(cfg, raw, tmp, smi):
    """mesh: the scale-out layer on the card.  (a) MESH_RANKS gloo ranks,
    each on cuda:0 (NCCL refuses two ranks on one card), started fresh by
    `parallel.dryrun.launch`: decode_iq_fused(mesh=) and
    decode_iq_parallel(mesh=) on the v2 capture (C=16) give every packet,
    in every rank the unsharded call's list; chain_per_sweep and
    ldpc_ber_sweep equal the one-rank sweeps; decode_sharded at
    MESH_BP with tp=2 equals bp_decode.cu on the same LLRs; each rank
    launched fsk_demod, deframe_topk, bp_decode and crc_pack.  (b) one
    NCCL rank: decode_iq_fused(mesh=) equal to the unsharded call, its
    gather through NCCL.  Several NCCL ranks need a card each: unproven on
    one card."""
    import torch
    from wenet_tpu_torch.ops import ldpc
    from wenet_tpu_torch.parallel import dryrun, sweep
    from wenet_tpu_torch.rx import pipeline

    dev = torch.device("cuda")
    fused = pipeline.decode_iq_fused(raw, "v2", n_chunks=FUSED_CHUNKS,
                                     device=dev)
    par = pipeline.decode_iq_parallel(raw, "v2", n_chunks=FUSED_CHUNKS,
                                      input_format="cu8", device=dev)
    require(len(fused) == len(par) == V2_PACKETS,
            f"mesh: {len(fused)} and {len(par)} of {V2_PACKETS} unsharded")
    want = {"fused": payload_digest(fused), "parallel": payload_digest(par),
            "chain": as_lists(sweep.chain_per_sweep(
                cfg, MESH_CHAIN_DB, MESH_CHAIN_TRIALS, device=dev)),
            "ber": as_lists(sweep.ldpc_ber_sweep(
                MESH_BER_DB, MESH_BER_CODEWORDS, device=dev))}
    llr = noisy_llrs(*MESH_BP, np.random.default_rng(SEED + 12), dev)
    bits, iters, ok = ldpc.decode(llr)            # bp_decode.cu
    want["sharded"] = {"bits": bits_digest(bits), "iters": iters.tolist(),
                       "ok": ok.tolist()}
    path = os.path.join(tmp, "mesh_inputs.npz")
    np.savez(path, raw=raw, llr=llr.cpu().numpy())

    worlds = {}
    for label, n, backend, stages, keys in (
            ("gloo", MESH_RANKS, None,
             ["fused", "parallel", "sweeps", "sharded"],
             ["fused", "parallel", "chain", "ber", "sharded"]),
            ("nccl", 1, "nccl", ["fused"], ["fused"])):
        t0 = time.perf_counter()
        ranks = dryrun.launch(n, "chip_smoke:mesh_rank", [path, stages],
                              backend, "cuda", timeout=300)
        worlds[label] = (ranks, time.perf_counter() - t0)
        for r in ranks:
            require(r["backend"] == label and r["device"] == "cuda:0",
                    f"mesh {label}: rank {r['rank']} {r['backend']} "
                    f"{r['device']}")
            for key in keys:
                got = r[key]
                if key == "sharded":
                    got = {k: got[k] for k in want[key]}
                require(got == want[key], f"mesh {label}: rank {r['rank']} "
                        f"{key} differs from the unsharded call")
            counts = r["launches"]
            require(all(counts["fused"].values()),
                    f"mesh {label}: rank {r['rank']} launches {counts}")
    gloo, wall = worlds["gloo"]
    sh = gloo[0]["sharded"]
    say("mesh", world="gloo", ranks=MESH_RANKS, device=gloo[0]["device"],
        packets=f"{want['fused'][0]}/{V2_PACKETS}", equal_to_unsharded=True,
        launch_s=f"{wall:.2f}",
        stage_wall_s={k[:-7]: [round(r[k], 4) for r in gloo]
                      for k in gloo[0] if k.endswith("_wall_s")},
        launches=gloo[0]["launches"],
        sharded_batch=MESH_BP[0], sharded_snr_db=MESH_BP[1], tp=2,
        sharded_loops=sh["loops"],
        sharded_ms_per_iter=[round(r["sharded"]["ms_per_iter"], 4)
                             for r in gloo],
        sharded_collective_share=[round(r["sharded"]["collective_share"],
                                        4) for r in gloo],
        sharded_collectives=sh["collectives"],
        staged_bytes=[r["staged_bytes"] for r in gloo], card=repr(smi))
    nccl, wall = worlds["nccl"]
    say("mesh", world="nccl", ranks=1, device=nccl[0]["device"],
        packets=f"{nccl[0]['fused'][0]}/{V2_PACKETS}",
        equal_to_unsharded=True, launch_s=f"{wall:.2f}",
        fused_wall_s=round(nccl[0]["fused_wall_s"], 4),
        staged_bytes=nccl[0]["staged_bytes"],
        launches=nccl[0]["launches"], card=repr(smi))


def golden_phase(smi):
    """golden: the JAX package's flight-rate tables (tests/golden/) through
    the port's Receiver on the card, whole grids (wenet_tpu_torch/tools):
    every row within 2 packets of the golden, the floor and above-cliff
    rows, and the baud-error and shift envelope; counts zeroed before each
    table and mode, read after."""
    from wenet_tpu_torch.tools import load_golden, per_table
    from wenet_tpu_torch.tools import robustness_table

    for name, tool in (("per_table", per_table),
                       ("robustness", robustness_table)):
        for mode in ("v1", "v2"):
            golden = load_golden(f"{name}_{mode}")
            zero_receive_counts()
            t0 = time.perf_counter()
            table = tool.sweep(mode, device="cuda")
            dt = time.perf_counter() - t0
            counts = receive_counts()
            bad = tool.violations(table, golden)
            require(not bad, f"golden {name} {mode}: {bad}")
            require(all(counts.values()), f"golden: launches {counts}")
            say("golden", table=name, mode=mode, rows=len(table["rows"]),
                packets_ok=[r["packets_ok"] for r in table["rows"]],
                golden_packets_ok=[r["packets_ok"] for r in golden["rows"]],
                wall_s=f"{dt:.3f}", launches=counts, card=repr(smi))


def forced_fsm(force_numpy, log=None):
    """A stand-in for ops.deframe.uw_detect_positions that always takes
    the C FSM (force_numpy=False) or its numpy version, whatever its
    caller asks, appending (symbols, positions, final buffer) of each call
    to log."""
    from wenet_tpu_torch.ops import deframe
    real = deframe.uw_detect_positions

    def fsm(hard, mode, init=None, **_):
        pos, final = real(hard, mode, init, force_numpy=force_numpy)
        if log is not None:
            log.append((len(hard), pos.tolist(), final.tolist()))
        return pos, final
    return fsm


def fsm_pushes(chunks, mode, force_numpy, dev):
    """A StreamDeframer on dev fed chunks, its UW FSM forced to C or
    numpy: (each FSM call's (symbols, positions, final buffer), payloads)."""
    from wenet_tpu_torch.ops import deframe
    log = []
    with mock.patch.object(deframe, "uw_detect_positions",
                           forced_fsm(force_numpy, log)):
        d = deframe.StreamDeframer(mode, device=dev)
        got = [p for c in chunks for p in d.push(c)]
    return log, got


def fsm_vs_plain(label, mode, chunks, dev):
    """The C UW FSM against its numpy version on one soft stream: the
    whole stream's positions and final buffer exact, and across the
    pushes of chunks (the final buffer carried) every call's; -> (whole
    positions, payloads of the pushes)."""
    from wenet_tpu_torch.ops import deframe
    hard = (np.concatenate(chunks) < 0).astype(np.uint8)
    pc, fc = deframe.uw_detect_positions(hard, mode)
    pn, fn = deframe.uw_detect_positions(hard, mode, force_numpy=True)
    require(np.array_equal(pc, pn) and np.array_equal(fc, fn),
            f"native {label}: the C FSM's whole-stream positions or final "
            f"buffer differ from numpy's ({len(pc)} / {len(pn)})")
    log_c, got_c = fsm_pushes(chunks, mode, False, dev)
    log_n, got_n = fsm_pushes(chunks, mode, True, dev)
    require(log_c == log_n and got_c == got_n,
            f"native {label}: the pushes' positions, buffers or payloads "
            "differ between the C and numpy FSMs")
    return pc, got_c


UW_SHAPES = (("v2_flight", "v2", 1, 192_000), ("v1_flight", "v1", 1, 230_000),
             ("v2_wideband", "v2", 8, 192_000))   # (case, mode, lanes, push)


def packet_soft(mode, n, rng, sigma=0.35):
    """n soft symbols of back-to-back frames (random payloads) with
    Gaussian noise, starting at a random point of the first frame."""
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import ldpc
    parts, have = [], 0
    while have < n + 4000:
        frame = framing.frame_packet(rng.integers(0, 256, 256, np.uint8)
                                     .tobytes(), ldpc.encode_bytes,
                                     mode=mode)
        parts.append(framing.frame_to_bits(frame, mode))
        have += len(parts[-1])
    bits = np.concatenate(parts)[int(rng.integers(0, 3000)):][:n]
    return (1.0 - 2.0 * bits + rng.normal(0, sigma, n)).astype(np.float32)


def uw_detect_phase(dev, smi) -> dict:
    """uw_detect_vs_plain: the streaming receivers' acquisition kernel
    (csrc/uw_detect.cu) at the flight push's shapes (one lane of a 2-s v2
    or v1 push and its carried tail) and the wideband push's (8 lanes),
    on frames back to back: meta and positions equal to its plain version
    and every lane's positions, cut and register to the C FSM's; the
    kernel's time (CUDA events over CALL_REPS calls) beside its bound (the
    soft bits read once) and the plain version's (host clock, one call).
    Then the windows of its detections (`deframe_topk.fsm_llrs`): the
    live count and positions equal to `fsm_windows_reference`'s, the LLRs
    within TOPK_LLR_RTOL of its windows' `sd_to_llr`; and BP with that
    live count on the card (`bp_decode.decode(live=...)`): its first rows
    bit for bit a decode of those rows alone.  Last, the whole card
    deframe of such a push (`LaneDeframer`: append, acquisition, windows,
    BP, CRC, copy and wait, unpack), host clock after a warm push."""
    import torch
    from wenet_tpu_torch.kernels import bp_decode
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.kernels import uw_detect as kuw
    from wenet_tpu_torch.ops import deframe, ldpc
    out = {}
    for case, mode, L, push in UW_SHAPES:
        before = kuw.launches
        rng = np.random.default_rng([SEED, L, push])
        _, nuw, _, syms = kuw.mode_params(mode)
        n = push + syms + nuw                  # the push and a full tail
        softs = [packet_soft(mode, n, rng) for _ in range(L)]
        flat = torch.from_numpy(np.concatenate(softs)).to(dev)
        ns = np.full(L, n, np.int64)
        cap = deframe.lane_capacity(ns, mode)
        table = torch.as_tensor(np.stack([np.cumsum(ns) - ns, ns,
                                          np.cumsum(cap) - cap, cap], 1),
                                device=dev)
        init = torch.zeros((L, 4), dtype=torch.int32, device=dev)
        meta = torch.empty((L, 4), dtype=torch.int32, device=dev)
        pos = torch.full((int(cap.sum()),), -1, dtype=torch.int32,
                         device=dev)

        def run():
            kuw.detect(flat, table, init, meta, pos, mode, n)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_m, want_p = deframe.uw_detect_lanes_reference(
            flat.cpu(), table.cpu(), init.cpu(), mode)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got_m, got_p = meta.cpu(), pos.cpu()
        counts = got_m[:, 0].numpy()
        require(torch.equal(got_m, want_m), f"uw_detect {case}: meta "
                f"{got_m.tolist()} against the plain {want_m.tolist()}")
        for i in range(L):
            a, c = int(table[i, 2]), int(counts[i])
            require(torch.equal(got_p[a: a + c], want_p[a: a + c]),
                    f"uw_detect {case}: lane {i}'s positions")
            hard = (softs[i] < 0).astype(np.uint8)
            pc, _ = deframe.uw_detect_positions(hard, mode)
            require(np.array_equal(got_p[a: a + c].numpy(), pc),
                    f"uw_detect {case}: lane {i} against the C FSM "
                    f"({c} / {len(pc)} detections)")
        kernel_ms = event_ms(run, CALL_REPS)
        bound, by = bound_ms(4 * L * n + 16 * L + 4 * int(counts.sum()), 0)

        rows = int(cap.sum())
        llr, pos_out, n_live = ktopk.fsm_llrs(flat, table, pos, meta, mode,
                                              rows)
        sd_w, pos_w = deframe.fsm_windows_reference(
            flat.cpu(), table.cpu(), pos.cpu(), meta.cpu(), mode)
        llr_w = ldpc.sd_to_llr(sd_w)
        live = int(n_live)
        require(live == len(sd_w) == int(counts.sum()) > 0,
                f"fsm_windows {case}: {live} live rows for "
                f"{int(counts.sum())} detections")
        require(torch.equal(pos_out[:live].cpu(), pos_w),
                f"fsm_windows {case}: positions differ from the plain ones")
        llr_g = llr[:live].cpu()
        rel = float(((llr_g - llr_w).abs() / llr_w.abs().clamp(min=1e-30))
                    .max())
        require(rel <= TOPK_LLR_RTOL,
                f"fsm_windows {case}: LLR rel err {rel}")
        window_ms = event_ms(lambda: ktopk.fsm_llrs(flat, table, pos, meta,
                                                    mode, rows), CALL_REPS)
        got_bp = bp_decode.decode(llr, live=n_live)
        want_bp = bp_decode.decode(llr[:live].contiguous())
        require(all(torch.equal(g[:live], w)
                    for g, w in zip(got_bp, want_bp)),
                f"bp_decode {case}: the live rows' bits, iterations or "
                "parity differ from a decode of those rows alone")

        lanes = deframe.LaneDeframer(mode, L, device=dev)
        walls = []
        for k in range(4):
            chunks = [torch.from_numpy(x[(k % 2) * (n // 2):][: n // 2]
                                       ).to(dev) for x in softs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lanes.push(chunks)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[case] = {"kernel_ms": kernel_ms, "bound_ms": bound,
                     "bound_by": by, "plain_ms": plain_ms,
                     "symbols": n, "lanes": L,
                     "window_ms": window_ms, "llr_rel_err": rel,
                     "deframe_ms": min(walls[1:])}
        say("uw_detect_vs_plain", kernel="uw_detect", case=case, mode=mode,
            lanes=L, symbols=n, detections=int(counts.sum()),
            meta_equal=True, c_fsm_equal=True, kernel_ms=f"{kernel_ms:.4f}",
            bound_ms=f"{bound:.6f}", bound_by=by,
            share_of_bound=f"{bound / kernel_ms:.5f}",
            plain_ms=f"{plain_ms:.1f}", on_chip=kuw.on_chip(n),
            windows_live=live, windows_positions_equal=True,
            windows_llr_rel_err=f"{rel:.3e}",
            windows_ms=f"{window_ms:.4f}", bp_live_equal=True,
            deframe_push_ms=f"{min(walls[1:]):.3f}",
            deframe_push_ms_all=[f"{w:.3f}" for w in walls],
            launches=kuw.launches - before, card=repr(smi))
    return out


def native_phase(cfg1, cfg2, raw1, raw2, wide, fs_w, wide_out, dev, smi):
    """native: the C UW FSM (`wenet_tpu_torch.native`, csrc/deframe_fsm.c)
    against its numpy version, positions and final buffers exact, on the
    hard bits of the v2 and v1 flight captures (whole, and across the
    Receiver's 2-s pushes with the buffer carried: the soft bits its card
    deframe took, whose payloads a StreamDeframer on them gives too) and
    of each wideband channel (the false lock of WIDE_FALSE_LOCK in both:
    the FSM modes keep one packet fewer than top-k there); each FSM's ms
    per Msymbol; then Receiver v2 and v1 (whose FSM is the card's under
    either) and the wideband vectorized and per-Receiver modes re-timed
    under the C FSM, and under the numpy FSM in the same call, each beside
    NUMPY_FSM_RATES."""
    import torch
    from wenet_tpu_torch import native
    from wenet_tpu_torch.ops import channelizer, deframe
    from wenet_tpu_torch.rx import pipeline

    lib = native.load()
    require(lib is not None, "native: no library")
    out = {"build_s": native.build_seconds,
           "library": os.path.relpath(native.library_path(), ROOT)}
    for mode, cfg, raw in (("v2", cfg2, raw2), ("v1", cfg1, raw1)):
        chunks = []
        decode = deframe.LaneDeframer.decode    # each push's soft chunk

        def record(self, softs, decode=decode):
            chunks.append(softs[0].cpu().numpy().astype(np.float32))
            return decode(self, softs)
        with mock.patch.object(deframe.LaneDeframer, "decode", record):
            got, _, _ = run_receiver(cfg, mode, raw)
        pos, got_c = fsm_vs_plain(mode, mode, chunks, dev)
        require(got_c == got, f"native {mode}: the pushes' payloads differ "
                "from the Receiver's")
        # a quarter of the push as well, so that the buffer is carried
        # across pushes in a capture shorter than two of them
        soft = np.concatenate(chunks)
        step = int(PUSH_SECONDS / 4 * cfg.Rs)
        fsm_vs_plain(f"{mode} quarter pushes", mode,
                     [soft[i:i + step] for i in range(0, len(soft), step)],
                     dev)
        hard = (soft < 0).astype(np.uint8)
        ms = {}
        for name, force in (("c", False), ("numpy", True)):
            walls = []
            for _ in range(FSM_REPS):
                t0 = time.perf_counter()
                deframe.uw_detect_positions(hard, mode, force_numpy=force)
                walls.append(time.perf_counter() - t0)
            ms[name] = float(np.median(walls)) * 1e3 / (len(hard) / 1e6)
        out[f"fsm_ms_per_msymbol_{mode}"] = ms
        say("native", stream=f"{mode}_flight", symbols=len(hard),
            pushes=len(chunks), quarter_pushes=-(-len(soft) // step),
            detections=len(pos), payloads=len(got),
            exact=True, c_ms_per_msymbol=f"{ms['c']:.4f}",
            numpy_ms_per_msymbol=f"{ms['numpy']:.4f}",
            timing=f"host clock, median of {FSM_REPS}", card=repr(smi))

    # the wideband channels' soft streams, as the vectorized mode hands
    # them to deframe_soft
    streams = []
    real_soft = deframe.deframe_soft

    def keep(soft, *a, **k):
        streams.append(np.array(soft, np.float32))
        return real_soft(soft, *a, **k)
    with mock.patch.object(deframe, "deframe_soft", keep):
        vec = channelizer.demod_multichannel(wide, fs_w, WIDE_CHANNELS,
                                             cfg2, device=dev)
    require(vec == wide_out["vectorized"], "native: the vectorized mode's "
            "lists changed between calls")
    lock_c, _ = WIDE_FALSE_LOCK
    step = int(PUSH_SECONDS * cfg2.Rs)
    counts = {}
    for c, soft in enumerate(streams):
        pieces = [soft[i:i + step] for i in range(0, len(soft), step)]
        _, got_c = fsm_vs_plain(f"wideband channel {c}", "v2", pieces, dev)
        with mock.patch.object(deframe, "uw_detect_positions",
                               forced_fsm(True)):
            got_n = deframe.deframe_soft(soft, "v2", device=dev).payloads
        got_w = deframe.deframe_soft(soft, "v2", device=dev).payloads
        require(got_w == got_n == got_c == vec[c],
                f"native: wideband channel {c}: the C and numpy FSMs' "
                "payloads differ")
        counts[c] = (len(got_w), len(got_n), len(wide_out["fused"][c]))
    require(counts[lock_c][:2] == (WIDE_PACKETS - 1,) * 2
            and counts[lock_c][2] == WIDE_PACKETS,
            f"native: channel {lock_c}'s false lock: {counts[lock_c]}")
    say("native", stream="wideband_channels", channels=len(streams),
        symbols=[len(x) for x in streams], exact=True,
        packets_c_numpy_topk=counts, false_lock=WIDE_FALSE_LOCK,
        card=repr(smi))

    # the paths the FSM sits on, re-timed: Receiver (its own seconds), the
    # vectorized mode (demod: from the call to its first deframe; deframe:
    # inside deframe_soft) and the per-Receiver mode (its Receivers'
    # seconds summed); each under the C FSM, then in the same call under
    # the numpy FSM (the port's path before the C FSM)
    marks = {"first": None, "deframe": 0.0}

    def timed(soft, *a, **k):
        t0 = time.perf_counter()
        if marks["first"] is None:
            marks["first"] = t0
        res = real_soft(soft, *a, **k)
        marks["deframe"] += time.perf_counter() - t0
        return res
    made = []

    class Counted(pipeline.Receiver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    rates = {}
    for fsm_name, force in (("c", False), ("numpy", True)):
        with mock.patch.object(deframe, "uw_detect_positions",
                               forced_fsm(force)):
            for mode, cfg, raw in (("v2", cfg2, raw2), ("v1", cfg1, raw1)):
                _, dt, rx = run_receiver(cfg, mode, raw)
                rates[f"receiver_{mode}", fsm_name] = (
                    len(raw) // 2 / dt / 1e6, rx.seconds["demod"] / dt,
                    rx.seconds["deframe"] / dt)
            for name, kw in (("wideband_vectorized", {}),
                             ("wideband_receiver", {"vectorized": False})):
                marks.update(first=None, deframe=0.0)
                made.clear()
                with mock.patch.object(deframe, "deframe_soft", timed), \
                        mock.patch.object(pipeline, "Receiver", Counted):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = channelizer.demod_multichannel(
                        wide, fs_w, WIDE_CHANNELS, cfg2, device=dev, **kw)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                require(got == wide_out["vectorized"],
                        f"native {name} ({fsm_name} FSM): lists differ")
                if made:
                    demod = sum(r.seconds["demod"] for r in made)
                    defr = sum(r.seconds["deframe"] for r in made)
                else:
                    demod, defr = marks["first"] - t0, marks["deframe"]
                rates[name, fsm_name] = (len(wide) / dt / 1e6, demod / dt,
                                         defr / dt)
    keys = ("msps", "demod_share", "deframe_share")
    for name, before in NUMPY_FSM_RATES.items():
        msps, dshare, fshare = rates[name, "c"]
        say("native", path=name, msps=f"{msps:.4f}",
            demod_share=f"{dshare:.3f}", deframe_share=f"{fshare:.3f}",
            numpy_fsm_same_call={k: round(v, 4) for k, v in
                                 zip(keys, rates[name, "numpy"])},
            earlier_numpy_fsm=dict(zip(keys, before)), card=repr(smi))
    out["rates"] = rates
    say("native", fsm_build_s=(f"{out['build_s']:.3f}" if out["build_s"]
                               is not None else "built earlier"),
        library=out["library"], compiler=native.compiler(), card=repr(smi))
    return out


def tool_counts():
    """Launch counts of the six kernels the measurement tools run."""
    from wenet_tpu_torch.kernels import bp_decode, channelize, crc_pack
    from wenet_tpu_torch.kernels import deframe_topk, fsk_demod
    return {"fsk_demod": fsk_demod.launches,
            "deframe_topk": deframe_topk.launches,
            "bp_decode": bp_decode.launches,
            "bp_minsum": bp_decode.minsum_launches,
            "crc_pack": crc_pack.launches, "channelize": channelize.launches}


def zero_tool_counts():
    from wenet_tpu_torch.kernels import bp_decode, channelize, crc_pack
    from wenet_tpu_torch.kernels import deframe_topk, fsk_demod
    fsk_demod.launches = deframe_topk.launches = crc_pack.launches = 0
    bp_decode.launches = bp_decode.minsum_launches = channelize.launches = 0


def plain_topk(soft, k, mode="v2"):
    """deframe_topk through the plain versions on the card: (B, n) soft
    bits -> topk_windows_reference, sd_to_llr, decode_reference and
    crc_pack_reference -> (ok, pos) (B, k)."""
    from wenet_tpu_torch.ops import crc as dcrc
    from wenet_tpu_torch.ops import deframe, ldpc
    sd, pos, _ = deframe.topk_windows_reference(soft, mode, k)
    bits, _, _ = ldpc.decode_reference(ldpc.sd_to_llr(sd))
    rows = dcrc.crc_pack_reference(bits, positions=pos.reshape(-1))
    return rows[:, 258].bool().reshape(soft.shape[0], k), pos


def plain_chain(cfg, sig, var, ebnos, k, noise, mode="v2"):
    """tools/chain_scaling.chain_lanes through the plain versions on the
    card: the plain demod loop, then `plain_topk` -> (ok, pos) (B, k)."""
    import torch
    from wenet_tpu_torch.ops import fsk
    from wenet_tpu_torch.tools import chain_scaling

    ebnos = torch.as_tensor(np.asarray(ebnos, np.float32), device=sig.device)
    B = ebnos.shape[0]
    iq = chain_scaling.noisy_lanes(cfg, sig, var, ebnos, noise)
    _, outs = fsk.demod_lanes_reference(cfg, iq,
                                        cfg.num_frames(sig.shape[0]))
    soft = torch.where(outs.valid[..., None], outs.soft, 1.0).reshape(B, -1)
    return plain_topk(soft, k, mode)


def tools_vs_plain(cfg2, dev, sig, var, ms, chain_b=TOOL_CHAIN_B,
                   minsum_b=TOOL_MINSUM_B, wide_n=TOOL_WIDE_N):
    """The tools phase's kernels against their plain versions at the
    shapes the tools launch them (see tools_phase); ms: minsum_scaling's
    records at minsum_b.  Returns (packets recovered a B of chain_lanes,
    the channelizer's max |diff| / rms an N)."""
    import torch
    from wenet_tpu_torch.ops import channelizer, deframe, fsk, ldpc
    from wenet_tpu_torch.tools import chain_scaling, loss_census
    from wenet_tpu_torch.tools import minsum_scaling, wideband_scaling

    # chain_lanes at B=2 and at each timed B, on one noise tensor
    sig_t = torch.as_tensor(sig, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    z = torch.randn((max(chain_b), len(sig), 2), generator=gen,
                    device=dev)
    noise = torch.complex(z[..., 0], z[..., 1])
    del z
    chain_ok = {}
    for B in (2,) + tuple(chain_b):
        ebnos_b = np.linspace(*chain_scaling.EBNO_RANGE, B).astype(
            np.float32)
        got = chain_scaling.chain_lanes(cfg2, sig_t, ebnos_b, 12,
                                        noise=noise[:B], device=dev, var=var)
        want_c = plain_chain(cfg2, sig_t, var, ebnos_b, 12, noise[:B])
        require(all(torch.equal(a, b) for a, b in zip(got, want_c)),
                f"tools: chain_lanes at B={B} differs from the plain "
                f"versions")
        chain_ok[B] = int(got[0].sum())
    del noise
    csig, cvar, cpk = loss_census.census_signal(cfg2)
    csig_t = torch.as_tensor(csig, device=dev)
    ebnos_c = np.linspace(10.5, 15.0, 2).astype(np.float32)
    z = torch.randn((2, len(csig), 2), generator=gen, device=dev)
    cnoise = torch.complex(z[..., 0], z[..., 1])
    c_kernel = loss_census.run(2, 1, 10.5, 15.0, cfg=cfg2, device=dev,
                               noise=cnoise[None])
    ok_p, pos_p = plain_chain(cfg2, csig_t, cvar, ebnos_c, cpk, cnoise)
    c_plain = loss_census.census(ok_p[None].cpu().numpy(),
                                 pos_p[None].cpu().numpy(), ebnos_c, cpk)
    c_plain["ebno_range"] = [10.5, 15.0]
    require(c_kernel == c_plain, f"tools: census {c_kernel} against the "
            f"plain versions' {c_plain}")
    # both decoders at each timed B, on the tool's LLRs: bits, iterations
    # and parity exact, and the recorded histograms the plain decoder's
    rng = np.random.default_rng(1)
    for B in minsum_b:
        llr = minsum_scaling.llr_batch(B, 7.5, rng, dev)
        for name, op, plain in (
                ("minsum", ldpc.decode_minsum,
                 ldpc.decode_minsum_reference),
                ("sumproduct", ldpc.decode, ldpc.decode_reference)):
            want_d = plain(llr)
            mis = mismatches(op(llr), want_d)
            require(mis[:3] == (0, 0, 0),
                    f"tools: {name} B={B}: {mis[0]} codewords differ in "
                    f"bits, {mis[1]} in iters, {mis[2]} in parity_ok")
            rec = next(r for r in ms if r["decoder"] == name and r["B"] == B)
            hist = minsum_scaling.iter_hist(want_d[1])
            require(rec["iter_hist"] == hist,
                    f"tools: {name} B={B} iter_hist {rec['iter_hist']} "
                    f"against the plain decoder's {hist}")
        del llr, want_d
    # the wideband path at each timed N: the channelizer within
    # CHANNELIZE_TOL of its rms, then the demod and the fused deframe on
    # the kernel's channels against the plain versions on the same ones
    wide_err = {}
    for nch in wide_n:
        wide, _ = wideband_scaling.build_wideband_capture(nch, cfg2)
        x = channelizer._device_input(wide, dev)
        chans = channelizer.channelize_pairs(x, nch)
        want_w = torch.view_as_real(channelizer.channelize_reference(
            torch.view_as_complex(x), nch)).reshape(-1, 2)
        err = float((chans - want_w).abs().max())
        rms = float(want_w.square().sum(1).mean().sqrt())
        require(chans.shape == want_w.shape and err <= CHANNELIZE_TOL * rms,
                f"tools: channelize N={nch}: max |diff| {err} of rms {rms}")
        wide_err[nch] = err / rms
        del want_w
        nf, outs = channelizer.demod_channels(cfg2, chans, nch)
        kk, packed = channelizer.fused_deframe(cfg2, outs, nf)
        F = chans.shape[0] // nch
        _, pouts = fsk.demod_raw_reference(
            cfg2, chans, "c64", nf,
            torch.arange(nch, dtype=torch.int64, device=dev) * F,
            torch.full((nch,), F, dtype=torch.int64, device=dev))
        require(torch.equal(outs.valid, pouts.valid),
                f"tools: wideband N={nch}: demod validity differs from "
                f"the plain loop's")
        psoft = torch.where(pouts.valid[..., None], pouts.soft, 1.0)
        ok_w, pos_w = plain_topk(psoft.reshape(nch, -1), kk)
        _, ok_k, pos_k = deframe.unpack_decode_results(packed.cpu().numpy())
        require(np.array_equal(ok_k, ok_w.cpu().numpy())
                and np.array_equal(pos_k, pos_w.cpu().numpy()),
                f"tools: wideband N={nch}: fused picks differ from the "
                f"plain versions'")
        del x, chans, outs, pouts, psoft
    return chain_ok, wide_err


def tools_phase(cfg1, cfg2, dev, smi) -> dict:
    """tools: the port's measurement tools (wenet_tpu_torch/tools) at the
    flight geometries, with the six kernels' counts zeroed before and read
    after: chain_scaling at TOOL_CHAIN_B, loss_census (B=16, R=4,
    10.5-15 dB), minsum_scaling at TOOL_MINSUM_B for both decoders,
    wideband_scaling at TOOL_WIDE_N (every channel complete),
    pp_breakdown on v2 and v1 over TOOL_PP_SECONDS, stream_tune on a
    TOOL_STREAM_SECS capture over its default grids (every list within
    the packets sent and at least all but one of them; each chunk count's
    ingest list equal to its on-device program's), and the stage splits
    of fused_where, fused_profile and wideband_where.  Then, uncounted,
    every kernel at the shapes the tools launch it: chain_lanes at B=2
    and at each TOOL_CHAIN_B against the plain versions on one noise
    tensor, the census at B=2 likewise, both decoders at each
    TOOL_MINSUM_B on the tool's LLRs (bits, iterations and parity exact;
    the recorded histograms the plain decoder's), at each TOOL_WIDE_N the
    channelizer against its plain version and the demod and fused
    deframe on its channels against theirs, and each pp_breakdown list
    against Receiver.push's.  Returns the counts."""
    import torch
    from wenet_tpu_torch.rx import pipeline
    from wenet_tpu_torch.tools import captures, chain_scaling, fused_profile
    from wenet_tpu_torch.tools import fused_where, loss_census
    from wenet_tpu_torch.tools import minsum_scaling, pp_breakdown
    from wenet_tpu_torch.tools import stream_tune, wideband_scaling
    from wenet_tpu_torch.tools import wideband_where

    def show(tool):
        return lambda rec: say("tools", tool=tool, record=json.dumps(
            rec, separators=(",", ":")), card=repr(smi))

    t_phase = time.perf_counter()
    sig, var = chain_scaling.chain_signal(cfg2)
    raw_s, n_sent = captures.stream_capture(TOOL_STREAM_SECS)
    sent_s = set(captures.stream_payloads(TOOL_STREAM_SECS))
    caps = {mode: pp_breakdown.capture(mode, TOOL_PP_SECONDS, cfg=cfg)
            for mode, cfg in (("v2", cfg2), ("v1", cfg1))}
    host_s = time.perf_counter() - t_phase

    zero_tool_counts()
    t0 = time.perf_counter()
    for B in TOOL_CHAIN_B:
        show("chain_scaling")(chain_scaling.measure(B, cfg2, sig, var,
                                                    device=dev))
    census = loss_census.run(16, 4, 10.5, 15.0, device=dev)
    show("loss_census")(census)
    ms = minsum_scaling.run(TOOL_MINSUM_B, device=dev,
                            emit=show("minsum_scaling"))
    for nch in TOOL_WIDE_N:
        rec = wideband_scaling.measure(nch, device=dev)
        show("wideband_scaling")(rec)
        require(rec["channels_complete"] == nch,
                f"tools: wideband_scaling N={nch}: "
                f"{rec['channels_complete']} channels complete")
    pp_lists = {}
    for mode, cfg in (("v2", cfg2), ("v1", cfg1)):
        raw, n_pkts = caps[mode]
        acc, pushes, pp_lists[mode] = pp_breakdown.breakdown(
            raw, mode, cfg, device=dev)
        show("pp_breakdown")(pp_breakdown.record(
            mode, "cu8", acc, pushes, len(pp_lists[mode]), n_pkts, dev))
    lists = stream_tune.tune(raw_s, n_sent, device=dev,
                             emit=show("stream_tune"))
    fused_where.run(secs=TOOL_STREAM_SECS, device=dev,
                    emit=show("fused_where"))
    fused_profile.run(secs=TOOL_STREAM_SECS, device=dev,
                      emit=show("fused_profile"))
    wideband_where.run(TOOL_WIDE_N[-1], device=dev,
                       emit=show("wideband_where"))
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    counts = tool_counts()
    for name, n in counts.items():
        require(n > 0, f"tools never launched {name}")

    # checks against the plain versions and the Receiver (uncounted)
    want = captures.decodable_packets(len(raw_s) // 2 // cfg2.Ts, n_sent)
    for config, got in lists.items():
        require(set(got) <= sent_s and len(got) >= want - 1,
                f"tools: stream_tune {config}: {len(got)} payloads, "
                f"{len(set(got) - sent_s)} never sent, {want} decodable")
    for config in [c for c in lists if c.endswith("_devres")]:
        ingest = config.replace("_devres", "_ingest")
        require(lists[ingest] == lists[config],
                f"tools: stream_tune {ingest} differs from {config}")
    for mode, cfg in (("v2", cfg2), ("v1", cfg1)):
        raw = caps[mode][0]
        rx = pipeline.Receiver(mode=mode, cfg=cfg, input_format="cu8",
                               device=dev)
        step = pp_breakdown.push_size(cfg, 2.0, "cu8")
        ref = [p for i in range(0, len(raw), step)
               for p in rx.push(raw[i:i + step])]
        require(pp_lists[mode] == ref,
                f"tools: pp_breakdown {mode}: {len(pp_lists[mode])} payloads "
                f"against the Receiver's {len(ref)}")
    chain_ok, wide_err = tools_vs_plain(cfg2, dev, sig, var, ms)
    wall = time.perf_counter() - t_phase
    say("tools", checks="passed", captures_s=f"{host_s:.3f}",
        drive_s=f"{drive_s:.3f}", wall_s=f"{wall:.3f}",
        loss_pct=census["loss_pct"],
        miss_by_packet_index=census["miss_by_packet_index"],
        miss_interior=census["miss_interior"],
        exhausted_picks=census["exhausted_picks"],
        chain_packets_by_b=chain_ok,
        channelize_rel_err={n: f"{e:.3e}" for n, e in wide_err.items()},
        checks_s=f"{wall - drive_s - host_s:.3f}", launches=counts,
        card=repr(smi))
    return counts


def deploy_phase(tmp, smi):
    """deploy: wenet_tpu_torch/deploy/start_rx.sh, as an operator starts
    it (HEADLESS=1, IMAGE_DIR and LOG_DIR in tmp), with a fake rtl_sdr on
    PATH that records its argv and writes a cu8 capture of one SSDV image
    at each flight rate of DEPLOY_SETTINGS: exit 0, rtl_sdr asked for the
    script's rate and the tuning formula's frequency, and the router's
    record of the image (its .bin: the SSDV payloads as received; its
    .jpg: their decode) equal to what a Receiver on the card gives on the
    same bytes in this process, with fsk_demod, bp_decode and crc_pack
    launched (counts zeroed before, read after).  The settings' scripts
    run at once, beside this process's Receivers.  The capture carries
    SSDV packets only: the router broadcasts telemetry on the LAN."""
    import glob
    import shutil
    from wenet_tpu_torch import ssdv
    from wenet_tpu_torch.core import packets as wp
    from wenet_tpu_torch.ops import fsk

    rng = np.random.default_rng(SEED + 13)
    jpg = synthetic_jpeg(*DEPLOY_IMAGE, rng)
    pkts = ssdv.encode(jpg, "VK5QI", 9, 6)
    want_jpg = ssdv.decode(pkts)
    script = os.path.join(ROOT, "wenet_tpu_torch", "deploy", "start_rx.sh")
    fake = os.path.join(tmp, "deploy_bin")
    os.makedirs(fake, exist_ok=True)
    with open(os.path.join(fake, "rtl_sdr"), "w") as fh:
        fh.write('#!/bin/sh\nprintf "%s\\n" "$@" > "$FAKE_RTL_ARGV"\n'
                 'exec cat "$FAKE_RTL_CAPTURE"\n')
    os.chmod(os.path.join(fake, "rtl_sdr"), 0o755)
    # the script's python3 is this interpreter
    with open(os.path.join(fake, "python3"), "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(fake, "python3"), 0o755)
    # both settings' scripts run at once, each in a thread of its own,
    # while this process runs its Receivers on the same bytes
    runs = []
    for mode, env_mode in DEPLOY_SETTINGS:
        baud = int(env_mode.get("BAUD_RATE", 115177))
        over = int(env_mode.get("OVERSAMPLING", 8))
        cfg = fsk.FSKConfig(Fs=baud * over, Rs=baud)
        raw = make_capture(cfg, mode, pkts, EBNO_DB, rng)
        cap = os.path.join(tmp, f"deploy_{mode}.cu8")
        raw.tofile(cap)
        img, logs = (os.path.join(tmp, f"deploy_{mode}_{d}")
                     for d in ("img", "logs"))
        argv_path = os.path.join(tmp, f"deploy_{mode}.argv")
        # the script's own defaults but for env_mode and the directories
        env = {k: v for k, v in os.environ.items() if k not in DEPLOY_UNSET}
        env.update(env_mode, HEADLESS="1", IMAGE_DIR=img, LOG_DIR=logs,
                   PATH=fake + os.pathsep + os.environ.get("PATH", ""),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   FAKE_RTL_ARGV=argv_path, FAKE_RTL_CAPTURE=cap)
        run = {"mode": mode, "baud": baud, "over": over, "cfg": cfg,
               "raw": raw, "img": img, "logs": logs, "argv": argv_path,
               "env": env}

        def launch(run=run):
            t0 = time.perf_counter()
            run["proc"] = subprocess.run(
                ["bash", script], cwd=tmp, env=run["env"],
                capture_output=True, text=True, timeout=600,
                stdin=subprocess.DEVNULL)
            run["wall"] = time.perf_counter() - t0
        run["thread"] = threading.Thread(target=launch)
        run["thread"].start()
        runs.append(run)
    for run in runs:
        mode, cfg = run["mode"], run["cfg"]
        zero_receive_counts()
        got, dt_rx, _ = run_receiver(cfg, mode, run["raw"])
        counts = receive_counts()
        require(all(counts.values()), f"deploy {mode}: launches {counts}")
        require(got == pkts, f"deploy {mode}: the Receiver gave {len(got)} "
                f"of {len(pkts)} packets")
        run.update(got=got, dt_rx=dt_rx, counts=counts)
    for run in runs:
        run["thread"].join()
    for run in runs:
        mode, baud, over, proc = (run[k] for k in ("mode", "baud", "over",
                                                   "proc"))
        img, logs, got = run["img"], run["logs"], run["got"]
        require(proc.returncode == 0,
                f"deploy {mode}: start_rx.sh exit {proc.returncode}: "
                f"{proc.stderr[-3000:]}")
        with open(run["argv"]) as fh:
            argv = fh.read().split()
        freq = int(DEPLOY_RXFREQ - baud * (over / 4.0 - 0.25))
        require(argv == ["-d", "0", "-s", str(baud * over), "-f", str(freq),
                         "-"], f"deploy {mode}: rtl_sdr argv {argv}")
        line = proc.stderr.strip().splitlines()[-1]
        require(f"crc_ok={len(pkts)} images=1" in line
                and f"device={run['env'].get('RX_DEVICE', 'cuda')}" in line,
                f"deploy {mode}: {line}")
        bins = glob.glob(os.path.join(img, "*_VK5QI_9.bin"))
        jpgs = glob.glob(os.path.join(img, "*_VK5QI_9.jpg"))
        require(len(bins) == len(jpgs) == 1, f"deploy {mode}: images "
                f"{sorted(os.listdir(img))}")
        with open(bins[0], "rb") as fh:
            require(fh.read() == b"".join(
                p for p in got if wp.decode_packet_type(p)
                == wp.PacketType.SSDV),
                f"deploy {mode}: the router's packets differ from the "
                "Receiver's")
        with open(jpgs[0], "rb") as fh:
            require(fh.read() == want_jpg, f"deploy {mode}: image differs")
        require(os.path.isdir(logs) and not os.listdir(logs),
                f"deploy {mode}: logs {os.listdir(logs)}")
        decode_s = line.split("wall=")[1].split("s")[0]
        say("deploy", mode=mode, baud=baud, oversampling=over,
            sdr_rate=baud * over, freq=freq, packets=f"{len(got)}/"
            f"{len(pkts)}", image_equal=True, samples=len(run["raw"]) // 2,
            process_wall_s=f"{run['wall']:.2f}", decode_s=decode_s,
            concurrent_processes=len(runs),
            receiver_wall_s=f"{run['dt_rx']:.3f}", launches=run["counts"],
            stderr=repr(line), card=repr(smi))
    shutil.rmtree(fake)


def synthetic_jpeg(width, height, rng):
    """A baseline 4:2:0 JPEG made by the port's own writer from random
    low-order coefficients (no Pillow on the card)."""
    from wenet_tpu_torch.ssdv import codec
    from wenet_tpu_torch.ssdv import jpeg as J
    lum, chroma = codec.quant_tables(6)
    comps = [J.Component(1, 2, 2, 0), J.Component(2, 1, 1, 1),
             J.Component(3, 1, 1, 1)]
    n_mcus = (width // 16) * (height // 16)
    mcus = np.zeros((n_mcus, 6, 64), np.int32)
    mcus[:, :, 0] = rng.integers(-40, 40, (n_mcus, 6))
    mcus[:, :, 1:10] = rng.integers(-6, 7, (n_mcus, 6, 9))
    return J.write_jpeg(J.JpegImage(width, height, comps,
                                    {0: lum, 1: chroma}, mcus))


def flight_capture(cfg, tmp, rng):
    """The flight side in-process: FLIGHT_FIXES SimulatedGPS fixes and
    FLIGHT_TEXTS texts through PacketTX, one SSDV image queued with
    queue_image_file, all through an IQRadio into a c64 file (FLIGHT_IDLES
    idle packets before, one after).  -> (path, the payloads sent in
    order, the SSDV packets, the JPEG ssdv.decode makes of them)."""
    from wenet_tpu_torch import ssdv
    from wenet_tpu_torch.tx import IQRadio, PacketTX
    from wenet_tpu_torch.tx.gps import SimulatedGPS

    jpg = synthetic_jpeg(*FLIGHT_IMAGE, rng)
    pkts = ssdv.encode(jpg, "VK5QI", 3, 6)
    ssdv_path = os.path.join(tmp, "flight.ssdv")
    with open(ssdv_path, "wb") as fh:
        fh.write(b"".join(pkts))
    path = os.path.join(tmp, "flight.c64")
    fout = open(path, "wb")
    radio = IQRadio(lambda iq: fout.write(iq.tobytes()), cfg=cfg, mode="v2")
    tx = PacketTX(radio, callsign="VK5QI")
    for _ in range(FLIGHT_IDLES):
        radio.transmit_packet(tx.idle_message)
    gps = SimulatedGPS(realtime=False)
    frames = []
    for i in range(FLIGHT_FIXES):
        tx.transmit_gps_telemetry(gps.step())
        if i < FLIGHT_TEXTS:
            tx.transmit_text_message(f"flight message {i}")
    require(tx.queue_image_file(ssdv_path), "flight: queue_image_file")
    while not (tx.telemetry_queue_empty() and tx.image_queue_empty()):
        q = tx.telemetry_queue if tx.telemetry_queue.qsize() else tx.ssdv_queue
        frames.append(q.get_nowait())
        radio.transmit_packet(frames[-1])
    radio.transmit_packet(tx.idle_message)
    radio.shutdown()
    fout.close()
    return path, [tx_payload(f) for f in frames], pkts, ssdv.decode(pkts)


def flight_phase(cfg, tmp, smi):
    """flight: the flight capture (flight_capture) decoded by `python -m
    wenet_tpu_torch rx --format c64` on the card: every GPS record is back
    in the router's gps log as the decoder reads the packet sent, every
    text in the text log, and the image reassembled byte-equal to
    ssdv.decode of the packets sent.  The CLI runs in a process of its
    own, whose launch counts this one cannot read, so the capture is
    also pushed through a Receiver here, counts zeroed before and read
    after, with the same payloads.  `wenet_tpu_torch.cli.flight` and
    `wenet_tpu_torch.tx.camera` import, and `python -m wenet_tpu_torch
    flight --help` (run beside the rx process) exits 0, with or without
    Pillow on the machine."""
    import glob
    import importlib
    from wenet_tpu_torch.core import packets as wp

    t0 = time.perf_counter()
    path, sent, pkts, want_jpg = flight_capture(
        cfg, tmp, np.random.default_rng(SEED + 11))
    build_s = time.perf_counter() - t0
    zero_receive_counts()
    iq = np.fromfile(path, np.complex64)
    got, dt, _ = run_receiver(cfg, "v2", iq, input_format="c64")
    counts = receive_counts()
    require(all(counts.values()), f"flight: launches {counts}")
    require([p for p in got if wp.decode_packet_type(p)
             != wp.PacketType.IDLE] == sent,
            f"flight: the Receiver gave {len(got)} of {len(sent)} payloads")
    logs, img_dir = os.path.join(tmp, "flight_logs"), \
        os.path.join(tmp, "flight_img")
    helped = {}
    help_thread = threading.Thread(target=lambda: helped.update(
        zip(("rc", "err", "s"), run_module("flight", "--help",
                                           timeout=120))))
    help_thread.start()
    rc, line, err, dt_cli = run_cli(path, "--mode", "v2", "--log-dir", logs,
                                    "--image-dir", img_dir, fmt="c64")
    help_thread.join()
    require(rc == 0, f"flight: rx exit {rc}: {err}")

    def log(kind):
        out = []
        for p in glob.glob(os.path.join(logs, f"*_{kind}.log")):
            with open(p) as fh:
                out += [json.loads(ln) for ln in fh]
        return out
    gps_sent = [json.loads(json.dumps(wp.gps_telemetry_decoder(p)))
                for p in sent
                if wp.decode_packet_type(p) == wp.PacketType.GPS_TELEMETRY]
    text_sent = [json.loads(json.dumps(wp.decode_text_message(p)))
                 for p in sent
                 if wp.decode_packet_type(p) == wp.PacketType.TEXT_MESSAGE]
    require(len(gps_sent) == FLIGHT_FIXES and log("gps") == gps_sent,
            f"flight: {len(log('gps'))} of {len(gps_sent)} GPS records")
    require(log("text") == text_sent, "flight: text records differ")
    jpgs = glob.glob(os.path.join(img_dir, "*_VK5QI_3.jpg"))
    require(len(jpgs) == 1, f"flight: images {jpgs}")
    with open(jpgs[0], "rb") as fh:
        require(fh.read() == want_jpg, "flight: image differs from "
                "ssdv.decode of the packets sent")
    for name in ("wenet_tpu_torch.cli.flight", "wenet_tpu_torch.tx.camera"):
        importlib.import_module(name)
    help_rc, help_err, help_s = helped["rc"], helped["err"], helped["s"]
    require(help_rc == 0, f"flight --help exit {help_rc}: {help_err}")
    try:
        import PIL  # noqa: F401
        pillow = True
    except ImportError:
        pillow = False
    say("flight", fixes=FLIGHT_FIXES, texts=FLIGHT_TEXTS,
        ssdv_packets=len(pkts), payloads=f"{len(got)}/{len(sent)}",
        gps_records=f"{len(log('gps'))}/{FLIGHT_FIXES}", image_equal=True,
        capture_bytes=os.path.getsize(path), build_s=f"{build_s:.3f}",
        receiver_wall_s=f"{dt:.3f}", cli_wall_s=f"{dt_cli:.2f}",
        cli_stderr=repr(line), help_wall_s=f"{help_s:.2f}", pillow=pillow,
        launches=counts, card=repr(smi))
    return path, sent, want_jpg


def apps_phase(cfg, path, sent, want_jpg, tmp, smi):
    """apps: the card's Receiver (with the eye probe) on the flight capture
    feeds a headless PacketRouter whose UDPEmitter points at free ports;
    a WenetWebServer on the image port and telemetry_console.listen on
    the telemetry port listen.  The console prints one line per telemetry
    packet, the SSE stream carries the GPS, TEXT and MODEM_STATS events,
    /latest.jpg serves the decoded image, and a ModemStatsModel takes the
    receiver's stats records through FSKDemodStats.to_wire (eye diagram
    included)."""
    import http.client
    import threading
    from wenet_tpu_torch.core import packets as wp
    from wenet_tpu_torch.rx import stats as rxstats
    from wenet_tpu_torch.rx import telemetry_console, web
    from wenet_tpu_torch.rx.gui import ModemStatsModel
    from wenet_tpu_torch.rx.pipeline import Receiver
    from wenet_tpu_torch.rx.router import PacketRouter, UDPEmitter
    import torch

    n_tel = sum(wp.decode_packet_type(p) != wp.PacketType.SSDV for p in sent)
    img_port, tel_port = free_ports(2)
    srv = web.WenetWebServer(port=0, udp_port=img_port,
                             image_dir=os.path.join(tmp, "apps_img"))
    lines, events = [], []
    console = threading.Thread(
        target=telemetry_console.listen, daemon=True,
        kwargs=dict(port=tel_port, max_packets=n_tel,
                    print_fn=lines.append))
    console.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("GET", "/events")
    stream = conn.getresponse()

    def read_events():
        try:
            while True:
                ln = stream.fp.readline()
                if not ln:
                    return
                if ln.startswith(b"data:"):
                    events.append(json.loads(ln[5:]))
        except (OSError, ValueError):
            return
    reader = threading.Thread(target=read_events, daemon=True)
    reader.start()
    time.sleep(0.5)                  # the listeners bind
    try:
        router = PacketRouter(
            image_dir=os.path.join(tmp, "apps_rx"), headless=True,
            emitter=UDPEmitter(image_port=img_port, telemetry_port=tel_port))
        acc = rxstats.FSKDemodStats(averaging_time=1.0, peak_hold=True,
                                    sample_rate=cfg.Fs)
        model = ModemStatsModel()
        zero_receive_counts()
        rx = Receiver(mode="v2", cfg=cfg, device="cuda", with_eye=True)
        iq = np.fromfile(path, np.complex64)
        step = int(cfg.Fs * 0.25)
        got = []

        def route(payloads):
            got.extend(payloads)
            for p in payloads:
                router.handle_packet(p)
            rec = rxstats.receiver_stats_record(rx)
            if rec:
                acc.update(rec)
                wire = acc.to_wire()
                model.update(wire | rec)
                rxstats.send_modem_stats(wire, udp_port=img_port)
        t0 = time.perf_counter()
        for i in range(0, len(iq), step):
            route(rx.push(iq[i:i + step]))
        route(rx.flush())
        router.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = receive_counts()
        require(all(counts.values()), f"apps: launches {counts}")
        require([p for p in got if wp.decode_packet_type(p)
                  != wp.PacketType.IDLE] == sent, "apps: payloads differ")
        console.join(timeout=10)
        deadline = time.time() + 10
        kinds = set()
        while time.time() < deadline:
            kinds = {e.get("type") for e in events}
            if {"GPS", "TEXT", "MODEM_STATS", "IMAGE"} <= kinds:
                break
            time.sleep(0.05)
        require(not console.is_alive() and len(lines) == n_tel,
                f"apps: console printed {len(lines)} of {n_tel} lines")
        want_lines = [wp.packet_to_string(p) for p in sent
                      if wp.decode_packet_type(p) != wp.PacketType.SSDV]
        require(sorted(ln.split(" \t", 1)[1] for ln in lines)
                == sorted(want_lines), "apps: console lines differ")
        require({"GPS", "TEXT", "MODEM_STATS", "IMAGE"} <= kinds,
                f"apps: SSE events {sorted(map(str, kinds))}")
        n_gps = sum(e.get("type") == "GPS" for e in events)
        n_text = sum(e.get("type") == "TEXT" for e in events)
        require(n_gps == FLIGHT_FIXES and n_text == FLIGHT_TEXTS,
                f"apps: SSE GPS {n_gps}, TEXT {n_text}")
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        c.request("GET", "/latest.jpg")
        r = c.getresponse()
        body = r.read()
        c.close()
        require(r.status == 200 and body == want_jpg,
                f"apps: /latest.jpg status {r.status}, {len(body)} bytes")
        snap = model.snapshot()
        require(snap["frames"] > 0 and snap["eye_lines"] == 8
                and snap["EbNodB"] is not None,
                f"apps: modem stats model {snap}")
    finally:
        conn.close()
        srv.close()
    say("apps", console_lines=f"{len(lines)}/{n_tel}",
        sse_events=len(events), sse_gps=n_gps, sse_text=n_text,
        latest_jpg_bytes=len(body), modem_stats=snap,
        receiver_wall_s=f"{dt:.3f}", launches=counts, card=repr(smi))


def pipelined_phase(cfg1, cfg2, dev, smi):
    """pipelined: on v2 and v1 captures of TOOL_PP_SECONDS (pp_breakdown's),
    `rx.pipeline.stream_step_lanes` on one lane of one push under
    torch.cuda.set_sync_debug_mode("error"), with and without the eye
    probe (its packed vector equal to a call outside the mode); one push's
    pageable host-to-device copy timed; pp_breakdown's per-push phases;
    then Receiver pushes, pipelined and serial, with the demod, BP and CRC
    counts zeroed before and read after: equal payload lists, equal to
    pp_breakdown's, and both timed."""
    import torch
    from wenet_tpu_torch.kernels import bp_decode, crc_pack, fsk_demod
    from wenet_tpu_torch.ops import fsk
    from wenet_tpu_torch.rx import pipeline
    from wenet_tpu_torch.tools import pp_breakdown

    for mode, cfg in (("v2", cfg2), ("v1", cfg1)):
        raw, n_pkts = pp_breakdown.capture(mode, TOOL_PP_SECONDS, cfg=cfg)
        step = pp_breakdown.push_size(cfg, PP_PUSH_SECONDS, "cu8")
        push = raw[:step].reshape(-1, 2)
        data = torch.from_numpy(push).to(dev)
        n, nf = data.shape[0], cfg.num_frames(data.shape[0])
        starts = torch.zeros(1, dtype=torch.int64, device=dev)
        n_valid = torch.full((1,), n, dtype=torch.int64, device=dev)
        for with_eye in (False, True):
            state = fsk.lane_state(fsk.demod_init(cfg, dev), 1)
            want = pipeline.stream_step_lanes(cfg, data, state, starts,
                                              n_valid, "cu8", nf, with_eye)[1]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = pipeline.stream_step_lanes(cfg, data, state, starts,
                                                 n_valid, "cu8", nf,
                                                 with_eye)[1]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            require(torch.equal(got, want),
                    f"pipelined {mode}: stream_step_lanes differs between "
                    f"calls")
        h2d = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(push).to(dev)
            h2d.append((time.perf_counter() - t0) * 1e3)
        acc, pushes, pp_list = pp_breakdown.breakdown(raw, mode, cfg,
                                                      device=dev)
        rec = pp_breakdown.record(mode, "cu8", acc, pushes, len(pp_list),
                                  n_pkts, dev)

        def run(pipelined):
            rx = pipeline.Receiver(mode, cfg, pipelined=pipelined,
                                   input_format="cu8", device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [p for i in range(0, len(raw), step)
                   for p in rx.push(raw[i:i + step])] + rx.flush()
            return time.perf_counter() - t0, got
        run(True)
        fsk_demod.launches = bp_decode.launches = crc_pack.launches = 0
        dt_pp, got_pp = run(True)
        dt_serial, got_serial = run(False)
        counts = {"fsk_demod": fsk_demod.launches,
                  "bp_decode": bp_decode.launches,
                  "crc_pack": crc_pack.launches}
        for name, count in counts.items():
            require(count > 0, f"pipelined {mode} never launched {name}")
        require(got_pp == got_serial == pp_list,
                f"pipelined {mode}: {len(got_pp)} payloads pipelined, "
                f"{len(got_serial)} serial, {len(pp_list)} in pp_breakdown")
        require(len(got_pp) >= n_pkts - 2,
                f"pipelined {mode}: {len(got_pp)} of {n_pkts} packets")
        ms = rec["per_push_ms"]
        say("pipelined", mode=mode, sync_debug="error", stream_step_syncs=0,
            packets=f"{len(got_pp)}/{n_pkts}", pushes=pushes,
            dispatch_ms=ms["dispatch"], exec_wait_ms=ms["exec_wait"],
            retire_ms=ms["retire"], fetch_ms=ms["fetch"], uw_ms=ms["uw"],
            decode_ms=ms["decode"],
            pp_speedup_bound=rec["pp_speedup_bound"],
            push_h2d_ms=f"{sorted(h2d)[2]:.3f}", push_bytes=push.nbytes,
            pipelined_s=f"{dt_pp:.4f}", serial_s=f"{dt_serial:.4f}",
            pp_speedup=f"{dt_serial / dt_pp:.3f}",
            msps_pipelined=f"{len(raw) / 2 / dt_pp / 1e6:.4f}",
            msps_serial=f"{len(raw) / 2 / dt_serial / 1e6:.4f}",
            pipelined_equal=True, launches=counts, card=repr(smi))


def port_bench_phase(cfg2, dev, smi) -> dict:
    """port_bench: `python -m wenet_tpu_torch.bench` in a process of its
    own with PORT_BENCH_ENV, its launch counts starting at 0 there and read
    at its end (its `kernel_launches`): exit 0, every gate held, no stage
    error, each of the six kernels launched.  Then `chain_lanes` at B =
    PORT_BENCH_STREAMS on the bench's chain signal against `plain_chain`
    on one round's noise, exactly.  Returns the bench's launch counts."""
    import torch
    from wenet_tpu_torch import bench
    from wenet_tpu_torch.tools import chain_scaling

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **PORT_BENCH_ENV)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "wenet_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"port_bench exit {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    gates = {k: v for k, v in line.items() if k.endswith("_gate")}
    require(gates and all(v is True for v in gates.values()),
            f"port_bench gates {gates}")
    require(bench.failures(line) == [], f"port_bench: {bench.failures(line)}")
    launches = line["kernel_launches"]
    for name in ("fsk_demod", "deframe_topk", "bp_decode", "bp_minsum",
                 "bp_onehot", "crc_pack", "channelize"):
        require(launches.get(name, 0) > 0,
                f"port_bench never launched {name}: {launches}")
    say("port_bench", rc=proc.returncode, wall_s=f"{wall:.3f}",
        env=json.dumps(PORT_BENCH_ENV, separators=(",", ":")),
        line=json.dumps(line, separators=(",", ":")), card=repr(smi))

    t0 = time.perf_counter()
    sig, var = bench.chain_signal(cfg2)
    sig_t = torch.as_tensor(sig, device=dev)
    B = PORT_BENCH_STREAMS
    ebnos = np.linspace(*bench.CHAIN_EBNO, B).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    z = torch.randn((B, len(sig), 2), generator=gen, device=dev)
    noise = torch.complex(z[..., 0], z[..., 1])
    del z
    got = chain_scaling.chain_lanes(cfg2, sig_t, ebnos, bench.CHAIN_PACKETS,
                                    noise=noise, device=dev, var=var)
    want = plain_chain(cfg2, sig_t, var, ebnos, bench.CHAIN_PACKETS, noise)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"port_bench: chain_lanes at B={B} differs from the plain "
            f"versions")
    say("port_bench", check="chain_lanes_vs_plain", streams=B,
        packets=f"{int(got[0].sum())}/{B * bench.CHAIN_PACKETS}",
        equal=True, check_s=f"{time.perf_counter() - t0:.3f}",
        card=repr(smi))
    return launches


CORPUS_ROW = re.compile(r"^\s*(\S+) pkts=\s*(\d+) decoded=\s*(\d+) "
                        r"jpeg_equal=\s*(True|False)")


def corpus_phase(tmp, smi):
    """corpus: CORPUS_IMAGES synthetic 800 x 608 JPEGs (synthetic_jpeg)
    through `wenet_tpu_torch.tools.corpus_e2e --images` in v2, with the
    Receiver and with --fused CORPUS_FUSED, each run with its kernels'
    counts zeroed before and read after: exit 0, every packet sent
    decoded, every reassembled JPEG equal to ssdv.decode of the packets
    sent."""
    from wenet_tpu_torch.kernels import bp_decode, crc_pack, deframe_topk
    from wenet_tpu_torch.kernels import fsk_demod
    from wenet_tpu_torch.tools import corpus_e2e

    folder = os.path.join(tmp, "corpus")
    os.makedirs(folder)
    rng = np.random.default_rng(SEED + 800)
    for i in range(1, CORPUS_IMAGES + 1):
        with open(os.path.join(folder, f"{i}.jpg"), "wb") as fh:
            fh.write(synthetic_jpeg(800, 608, rng))
    for label, extra in (("receiver", []),
                         ("fused", ["--fused", str(CORPUS_FUSED)])):
        fsk_demod.launches = bp_decode.launches = crc_pack.launches = 0
        deframe_topk.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = corpus_e2e.main(["--images", os.path.join(folder, "*.jpg"),
                                  "--mode", "v2", *extra])
        wall = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        rows = [m.groups() for m in map(CORPUS_ROW.match, lines) if m]
        counts = {"fsk_demod": fsk_demod.launches,
                  "deframe_topk": deframe_topk.launches,
                  "bp_decode": bp_decode.launches,
                  "crc_pack": crc_pack.launches}
        require(rc == 0, f"corpus {label}: exit {rc}: {lines}")
        require(len(rows) == CORPUS_IMAGES
                and all(r[1] == r[2] and r[3] == "True" for r in rows),
                f"corpus {label}: rows {rows}")
        for name, count in counts.items():
            if label == "fused" or name != "deframe_topk":
                require(count > 0, f"corpus {label} never launched {name}")
        say("corpus", decoder=label, rows=[
            f"{r[0]}:{r[2]}/{r[1]}:jpeg_equal={r[3]}" for r in rows],
            summary=repr(lines[-1]), wall_s=f"{wall:.3f}", launches=counts,
            card=repr(smi))


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from wenet_tpu_torch import kernels, native
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.kernels import bp_decode, bp_onehot, fsk_demod
    from wenet_tpu_torch.kernels import channelize as kchan
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.kernels import uw_detect as kuw
    from wenet_tpu_torch.ops import channel, channelizer
    from wenet_tpu_torch.ops import crc as dcrc
    from wenet_tpu_torch.ops import deframe, fsk, ldpc, ldpc_onehot
    from wenet_tpu_torch.parallel import sweep
    from wenet_tpu_torch.rx import pipeline

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    # 2. build: one nvcc per source, all at once
    t0 = time.perf_counter()
    names = ("bp_decode", "bp_onehot", "fsk_demod", "crc_pack",
             "deframe_topk", "channelize", "uw_detect")
    kernels.build(*names)
    build_s = time.perf_counter() - t0
    # the host runtime's C UW FSM, built with the host C compiler
    native.load()
    say("build", kernels=",".join(names), seconds=f"{build_s:.2f}",
        nvcc=kernels.nvcc_path(), fsm_library=os.path.basename(
            native.library_path()), fsm_build_s=(
            f"{native.build_seconds:.3f}" if native.build_seconds
            is not None else "built earlier"), cc=native.compiler())
    for name, log in kernels.build_logs.items():
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say("ptxas", kernel=name, info=repr("; ".join(regs)))
    expansion = libdevice_expansion(kernels.nvcc_path(), kernels.NVCC_FLAGS,
                                    kernels.BUILD_DIR)
    sms, per_sm = bp_decode.card_shape(dev)
    say("bp_launch", sms=sms, blocks_per_sm=per_sm,
        libdevice_sass_instructions=expansion,
        shapes={b: bp_decode.launch_shape(b, sms, per_sm)
                for b in (1, 16, 40, 70, 128, 2048)},
        minsum_shapes={b: bp_decode.launch_shape(b, sms, per_sm, True)
                       for b in (1, 70, 2048)})
    for n_t, mode_t, c_t in ((22128, "v2", 16), (14448, "v1", 16),
                             (39888, "v2", 8), (150_000, "v1", 2)):
        nlive_t, ntiles_t, scratch_t, smem_t = ktopk.geometry(n_t, mode_t,
                                                              c_t)
        lib_t = ktopk._lib()
        require(lib_t.deframe_topk_scratch_bytes(c_t, nlive_t, ntiles_t)
                == scratch_t
                and lib_t.deframe_topk_pick_smem_bytes(nlive_t, ntiles_t)
                == smem_t, "deframe_topk scratch accounting")
    for n_ch, t_ch in ((1, 12), (4, 12), (6, 12), (8, 16), (16, 12),
                       (100, 12), (256, 12), (1024, 12), (2600, 4), REACH,
                       (6456, 1)):
        for fmt_c, (code, _) in kchan.FORMATS.items():
            for nsel in (1, 3, n_ch):
                tile, tw_smem, fl = kchan.plan(n_ch, t_ch, nsel, fmt_c)
                require(kchan._lib().channelize_smem_bytes(
                    n_ch, t_ch, tile, nsel, code, int(tw_smem), fl)
                        == kchan.smem_bytes(n_ch, t_ch, tile, nsel, fmt_c,
                                            tw_smem, fl),
                        "channelize smem accounting")
    region = ldpc_onehot.kernel_tables(dev).shape[1]
    clusters = bp_onehot.card_clusters(dev, region)
    onehot_shapes = {b: tuple(bp_onehot.launch_shape(b, clusters, region))
                     for b in (1, 7, 16, 32, 70, 128, STAGE_BATCH)}
    require(bp_onehot._lib().bp_onehot_smem_bytes(region)
            == bp_onehot.smem_bytes(region), "bp_onehot smem accounting")
    require(onehot_shapes[128][1] >= 100,
            f"bp_onehot runs B=128 on {onehot_shapes[128][1]} SMs")
    say("onehot_launch", clusters_on_card=clusters,
        cluster_size=bp_onehot.CLUSTER, threads=bp_onehot.THREADS,
        table_region_bytes=2 * region,
        shapes_cluster_blocks_smem=onehot_shapes)

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # 3. each kernel vs its plain version on the card, B = 16 to 128
    # (name, op, plain, timed calls of the plain version, min-sum, table
    # bytes)
    decoders = [
        ("bp_decode", ldpc.decode, ldpc.decode_reference, 10, False,
         nbytes(bp_decode._tables(dev))),
        ("bp_minsum", ldpc.decode_minsum, ldpc.decode_minsum_reference, 10,
         True, nbytes(bp_decode._tables(dev))),
        # the same work as bp_decode's: its tables, not this kernel's lists
        ("bp_onehot", ldpc_onehot.decode_onehot,
         ldpc_onehot.decode_onehot_reference, 3, False,
         nbytes(bp_decode._tables(dev))),
    ]
    rng = np.random.default_rng(SEED)
    max_err = {name: 0 for name, *_ in decoders}
    times = {}

    def measure(name, op, plain, reps, minsum, table_bytes, llr, got):
        """Times and bounds of one decoder on llr; got = its outputs."""
        B = llr.shape[0]
        it_total = int(got[1].sum())
        bound, by = bp_bound(B, it_total, table_bytes, minsum)
        bound_x, by_x = bp_bound(B, it_total, table_bytes, minsum,
                                 expansion["logf"], expansion["tanhf"])
        tk = graph_ms(lambda: op(llr))
        return {"ms": tk, "call_ms": event_ms(lambda: op(llr), 20),
                "plain_ms": event_ms(lambda: plain(llr), reps),
                "bound_ms": bound, "bound_by": by,
                "bound_libdevice_ms": bound_x, "bound_libdevice_by": by_x,
                "share": bound / tk, "mean_iters": it_total / B}

    def show(phase, name, B, snr, m, **kv):
        say(phase, kernel=name, batch=B, snr_db=snr, **kv,
            mean_iters=f"{m['mean_iters']:.3f}",
            kernel_ms=f"{m['ms']:.4f}", call_ms=f"{m['call_ms']:.4f}",
            plain_ms=f"{m['plain_ms']:.4f}",
            bound_ms=f"{m['bound_ms']:.6f}", bound_by=m["bound_by"],
            share_of_bound=f"{m['share']:.4f}",
            bound_libdevice_ms=f"{m['bound_libdevice_ms']:.6f}",
            bound_libdevice_by=m["bound_libdevice_by"],
            card=repr(smi))

    for B, snr in BP_CASES:
        # the 128-codeword cases draw from the generator of the captures
        # below, as they always have; the others from their own
        llr = noisy_llrs(B, snr, rng if B == MAIN_CASE[0]
                         else np.random.default_rng(SEED + B), dev)
        for name, op, plain, reps, minsum, table_bytes in decoders:
            got = op(llr)
            bit_mis, it_mis, ok_mis, err = mismatches(got, plain(llr))
            require(bit_mis == 0 and it_mis == 0 and ok_mis == 0,
                    f"{name} B={B} {snr} dB: {bit_mis} codewords differ in "
                    f"bits, {it_mis} in iters, {ok_mis} in parity_ok")
            if name == "bp_onehot":     # the same sum-product as bp_decode
                sp = mismatches(got, ldpc.decode_reference(llr))
                require(sp[:3] == (0, 0, 0),
                        f"bp_onehot B={B} {snr} dB differs from "
                        f"decode_reference")
            max_err[name] = max(max_err[name], err)
            m = measure(name, op, plain, reps, minsum, table_bytes, llr, got)
            times[name, B, snr] = m
            show("bp_vs_plain", name, B, snr, m,
                 converged=int(got[2].sum()), bit_mismatch=bit_mis,
                 iters_mismatch=it_mis, parity_mismatch=ok_mis)
    # the gather probes' counterpart: X[:, IDX], (8, 256) f32 by (512,)
    # i32; bound: bytes in and out once; library: torch.index_select
    rows, cols, n_idx = PROBE_SHAPE
    xg = torch.randn(rows, cols, device=dev)
    idx = torch.randint(0, cols, (n_idx,), device=dev, dtype=torch.int32)
    require(torch.equal(torch.index_select(xg, 1, idx), xg[:, idx.long()]),
            "gather probe: index_select")
    probe_bytes = 4 * (rows * cols + n_idx + rows * n_idx)
    say("gather_probe", shape=PROBE_SHAPE, bytes=probe_bytes,
        bound_ms=f"{probe_bytes / HBM_BYTES_PER_S * 1e3:.6f}", bound_by="bytes",
        library="torch.index_select",
        library_ms=f"{graph_ms(lambda: torch.index_select(xg, 1, idx)):.6f}",
        card=repr(smi))
    llr7 = noisy_llrs(7, 3.0, np.random.default_rng(SEED + 7),
                      dev)                          # a ragged batch tile
    got7 = ldpc_onehot.decode_onehot(llr7)
    mis7 = mismatches(got7, ldpc_onehot.decode_onehot_reference(llr7))
    require(mis7[:3] == (0, 0, 0), f"bp_onehot B=7: mismatches {mis7[:3]}")
    require(mismatches(got7, ldpc.decode_reference(llr7))[:3] == (0, 0, 0),
            "bp_onehot B=7 differs from decode_reference")
    say("bp_vs_plain", kernel="bp_onehot", snr_db=3.0, batch=7,
        converged=int(got7[2].sum()), bit_mismatch=mis7[0],
        iters_mismatch=mis7[1], parity_mismatch=mis7[2])

    # 4. the demod frame-loop kernel vs its plain loop, v2 flight geometry,
    # cu8: 600 frames on one lane, 16 overlapping lanes of 120 frames
    cfg2 = fsk.V2_CONFIG
    for cfg_m in (fsk.V1_CONFIG, cfg2):
        for fmt in fsk_demod.FORMATS:
            gm = fsk_demod.geometry(cfg_m, fmt, 1, 1, 1 << 20)
            require(fsk_demod.smem_bytes(gm) == fsk_demod.smem_layout_bytes(gm),
                    f"fsk_demod smem accounting ({fmt})")
    raw_d = make_capture(cfg2, "v2", [text_message(f"demod {i}", i)
                                      for i in range(8)], EBNO_DB,
                         np.random.default_rng(SEED + 600))
    data_d = torch.from_numpy(raw_d.reshape(-1, 2)).to(dev)
    demod_times = {}
    for lanes, frames in DEMOD_CASES:
        starts = torch.arange(lanes, dtype=torch.int64,
                              device=dev) * DEMOD_LANE_STRIDE
        n_valid = torch.full((lanes,), frames * cfg2.N, dtype=torch.int64,
                             device=dev)
        args = (cfg2, data_d, "cu8", frames + 2, starts, n_valid)
        fsk_demod.launches = fsk_demod.spec_launches = 0
        spec0 = fsk_demod.spec_stats()
        got = fsk.demod_raw(*args, with_eye=True)
        torch.cuda.synchronize()
        require(fsk_demod.launches == 1, "demod_vs_plain: no kernel launch")
        require(fsk_demod.spec_launches == 0,
                f"demod_vs_plain L={lanes}: the frame-parallel path ran")
        spec = {k: v - spec0[k] for k, v in fsk_demod.spec_stats().items()}
        want = fsk.demod_raw_reference(*args, with_eye=True)
        cmp = demod_compare(got, want)
        require(cmp["valid"] == cmp["nin"] == cmp["f_est"] == cmp["bits"] == 0
                and cmp["rel_err"] <= DEMOD_SOFT_TOL and cmp["eye"] == 0
                and cmp["eye_rel_err"] <= DEMOD_SOFT_TOL,
                f"demod_vs_plain L={lanes}: {cmp}")
        ms = event_ms(lambda: fsk.demod_raw(*args), 5)
        plain_ms = event_ms(lambda: fsk.demod_raw_reference(*args), 1)
        bound, by, bound_sm = demod_bound(cfg2, want[1],
                                          lanes * frames * cfg2.N, 2)
        demod_times[lanes] = dict(cmp, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by,
                                  bound_one_sm_ms=bound_sm)
        say("demod_vs_plain", kernel="fsk_demod", lanes=lanes,
            frames=cmp["frames"], valid_mismatch=cmp["valid"],
            nin_mismatch=cmp["nin"], f_est_mismatch=cmp["f_est"],
            bit_mismatch=cmp["bits"], max_abs_err=f"{cmp['max_abs_err']:.3e}",
            rel_err=f"{cmp['rel_err']:.3e}", tol=DEMOD_SOFT_TOL,
            eye_mismatch=cmp["eye"], eye_rel_err=f"{cmp['eye_rel_err']:.3e}",
            kernel_ms=f"{ms:.4f}",
            kernel_ms_per_frame=f"{ms / (cmp['frames'] / lanes):.5f}",
            plain_ms=f"{plain_ms:.2f}",
            plain_ms_per_frame=f"{plain_ms / (cmp['frames'] / lanes):.4f}",
            bound_ms=f"{bound:.6f}", bound_by=by,
            share_of_bound=f"{bound / ms:.5f}",
            bound_one_sm_ms=f"{bound_sm:.6f}",
            share_of_one_sm_bound=f"{bound_sm / ms:.5f}",
            smem_bytes=fsk_demod.smem_bytes(fsk_demod.geometry(
                cfg2, "cu8", lanes, frames, data_d.shape[0])),
            frame_parallel=fsk_demod.frame_parallel(
                cfg2, "cu8", lanes, frames + 2, dev), spec_stats=spec,
            card=repr(smi))

    # the same at the main path's push shapes: the frame-parallel path at one
    # lane, the lane path at the wideband receiver's eight
    # (clean traffic, so that the guesses hold after acquisition)
    for mode, lanes, frames in DEMOD_PUSH_CASES:
        cfg_p = fsk.V1_CONFIG if mode == "v1" else cfg2
        span = (frames + 2) * cfg_p.N + (lanes - 1) * DEMOD_LANE_STRIDE
        n_pk = span // cfg_p.Ts // 5000 + 2
        raw_p = make_capture(cfg_p, mode, [text_message(f"push {i}", i)
                                           for i in range(n_pk)], EBNO_DB,
                             np.random.default_rng(SEED + 610 + lanes))
        data_p = torch.from_numpy(raw_p.reshape(-1, 2)).to(dev)
        starts = torch.arange(lanes, dtype=torch.int64,
                              device=dev) * DEMOD_LANE_STRIDE
        n_valid = torch.full((lanes,), frames * cfg_p.N, dtype=torch.int64,
                             device=dev)
        args = (cfg_p, data_p, "cu8", frames + 2, starts, n_valid)
        window = fsk_demod.frame_parallel(cfg_p, "cu8", lanes, frames + 2,
                                          dev)
        spec_path = lanes <= fsk_demod.SPEC_MAX_LANES
        require((window > 0) == spec_path,
                f"demod_vs_plain {mode} L={lanes} x {frames}: window "
                f"{window} where the shape rule expects "
                f"{'the frame-parallel' if spec_path else 'the lane'} path")
        fsk_demod.launches = fsk_demod.spec_launches = 0
        spec0 = fsk_demod.spec_stats()
        got = fsk.demod_raw(*args, with_eye=True)
        torch.cuda.synchronize()
        spec = {k: v - spec0[k] for k, v in fsk_demod.spec_stats().items()}
        n_launch = (fsk_demod.launches, fsk_demod.spec_launches)
        require(n_launch == (1, int(spec_path)),
                f"demod_vs_plain {mode} L={lanes}: "
                f"{n_launch} lane and frame-parallel launches")
        require((spec["spec_frames"] > 0) == spec_path,
                f"demod_vs_plain {mode} L={lanes}: frames kept on the "
                f"frame-parallel path: {spec}")
        t0 = time.perf_counter()
        want = fsk.demod_raw_reference(*args, with_eye=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = demod_compare(got, want)
        require(cmp["valid"] == cmp["nin"] == cmp["f_est"] == cmp["bits"] == 0
                and cmp["rel_err"] <= DEMOD_SOFT_TOL and cmp["eye"] == 0
                and cmp["eye_rel_err"] <= DEMOD_SOFT_TOL,
                f"demod_vs_plain {mode} L={lanes} x {frames}: {cmp}")
        ms = event_ms(lambda: fsk.demod_raw(*args), 5)
        bound, by, bound_sm = demod_bound(cfg_p, want[1],
                                          lanes * frames * cfg_p.N, 2)
        demod_times[(mode, lanes, frames)] = dict(
            cmp, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            bound_one_sm_ms=bound_sm, spec_stats=spec)
        say("demod_vs_plain", kernel="fsk_demod", case="push", mode=mode,
            lanes=lanes, frames=cmp["frames"], valid_mismatch=cmp["valid"],
            nin_mismatch=cmp["nin"], f_est_mismatch=cmp["f_est"],
            bit_mismatch=cmp["bits"], max_abs_err=f"{cmp['max_abs_err']:.3e}",
            rel_err=f"{cmp['rel_err']:.3e}", tol=DEMOD_SOFT_TOL,
            eye_mismatch=cmp["eye"], eye_rel_err=f"{cmp['eye_rel_err']:.3e}",
            kernel_ms=f"{ms:.4f}",
            kernel_ms_per_frame=f"{ms / (cmp['frames'] / lanes):.5f}",
            plain_ms=f"{plain_ms:.2f}", plain_timing="host clock, one call",
            bound_ms=f"{bound:.6f}", bound_by=by,
            share_of_bound=f"{bound / ms:.5f}",
            bound_one_sm_ms=f"{bound_sm:.6f}",
            share_of_one_sm_bound=f"{bound_sm / ms:.5f}",
            frame_parallel=window, spec_stats=spec,
            lane_launches=n_launch[0], frame_parallel_launches=n_launch[1],
            card=repr(smi))

    # 5. main path, v2 at flight rate (the counted run)
    sent2 = [text_message(f"smoke {i}", i)
             for i in range(V2_PACKETS)]
    raw2 = make_capture(cfg2, "v2", sent2, EBNO_DB, rng)
    want2 = [framing.pad_payload(p) for p in sent2]
    batches = []                  # the decode batch of each push
    decode = bp_decode.decode
    bp_decode.decode = lambda llr, *a, **k: (batches.append(llr.shape[0]),
                                             decode(llr, *a, **k))[1]
    bp_decode.launches = fsk_demod.launches = kcrc.launches = 0
    fsk_demod.spec_launches = kuw.launches = ktopk.window_launches = 0
    try:
        got2, dt2, rx2 = run_receiver(cfg2, "v2", raw2)
    finally:
        bp_decode.decode = decode
    main_launches = {"bp_decode": bp_decode.launches,
                     "fsk_demod": fsk_demod.launches,
                     "fsk_demod_spec": fsk_demod.spec_launches,
                     "uw_detect": kuw.launches,
                     "fsm_windows": ktopk.window_launches}
    require(kcrc.launches == len(batches),
            f"v2 main path: {kcrc.launches} crc_pack launches for "
            f"{len(batches)} decode batches")
    pushes2 = n_pushes(cfg2, raw2)
    require(kuw.launches == ktopk.window_launches == len(batches)
            == pushes2 and rx2.waits == 2 * pushes2,
            f"v2 main path: {kuw.launches} uw_detect, "
            f"{ktopk.window_launches} fsm_windows launches, "
            f"{len(batches)} decode batches and {rx2.waits} waits for "
            f"{pushes2} pushes (one each a push, two waits)")
    n2 = len(raw2) // 2
    require(got2 == want2, f"v2: {len(got2)}/{len(want2)} payloads match")
    require(main_launches["bp_decode"] > 0,
            "v2 main path never launched bp_decode")
    require(main_launches["fsk_demod"] > 0,
            "v2 main path never launched fsk_demod")
    sec2 = rx2.seconds
    say("v2_stream", packets=f"{len(got2)}/{len(sent2)}", samples=n2,
        wall_s=f"{dt2:.3f}", msps=f"{n2 / dt2 / 1e6:.4f}",
        realtime_msps=f"{cfg2.Fs / 1e6:.3f}",
        demod_share=f"{sec2['demod'] / dt2:.3f}",
        deframe_share=f"{sec2['deframe'] / dt2:.3f}",
        bp_launches=main_launches["bp_decode"],
        demod_launches=main_launches["fsk_demod"],
        demod_frame_parallel_launches=main_launches["fsk_demod_spec"],
        crc_launches=kcrc.launches, pushes=pushes2,
        uw_launches=main_launches["uw_detect"],
        window_launches=main_launches["fsm_windows"], waits=rx2.waits,
        frames=rx2.stats.frames,
        decode_batches=batches, card=repr(smi))

    # 6. main path, v1 at flight rate; pipelined == serial
    cfg1 = fsk.V1_CONFIG
    sent1 = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
             for _ in range(V1_PACKETS)]
    raw1 = make_capture(cfg1, "v1", sent1, EBNO_DB, rng)
    before = bp_decode.launches
    fsk_demod.launches = kuw.launches = ktopk.window_launches = 0
    got1, dt1, rx1 = run_receiver(cfg1, "v1", raw1)
    require(fsk_demod.launches > 0, "v1 path never launched fsk_demod")
    pushes1 = n_pushes(cfg1, raw1)
    require(kuw.launches == ktopk.window_launches == pushes1
            and rx1.waits == 2 * pushes1,
            f"v1 main path: {kuw.launches} uw_detect and "
            f"{ktopk.window_launches} fsm_windows launches, {rx1.waits} "
            f"waits for {pushes1} pushes (one each a push, two waits)")
    main_launches["uw_detect"] += kuw.launches
    main_launches["fsm_windows"] += ktopk.window_launches
    got1p, dt1p, _ = run_receiver(cfg1, "v1", raw1, pipelined=True)
    n1 = len(raw1) // 2
    require(got1 == sent1, f"v1: {len(got1)}/{len(sent1)} payloads match")
    require(got1p == got1, "v1 pipelined differs from serial")
    require(bp_decode.launches > before, "v1 path never launched bp_decode")
    say("v1_stream", packets=f"{len(got1)}/{len(sent1)}", samples=n1,
        pushes=pushes1, uw_launches=pushes1, window_launches=pushes1,
        waits=rx1.waits,
        wall_s=f"{dt1:.3f}", msps=f"{n1 / dt1 / 1e6:.4f}",
        pipelined_wall_s=f"{dt1p:.3f}", pipelined_equal=True,
        realtime_msps=f"{cfg1.Fs / 1e6:.3f}",
        demod_share=f"{rx1.seconds['demod'] / dt1:.3f}",
        deframe_share=f"{rx1.seconds['deframe'] / dt1:.3f}", card=repr(smi))

    # 6b. the v2 receiver with the eye probe on, as the CLI builds it
    # unless --no-udp: the same payloads, and a stats record whose eye
    # diagram is finite, of the reference's shape, normalised to 1
    fsk_demod.launches = 0
    got2e, dt2e, rx2e = run_receiver(cfg2, "v2", raw2, with_eye=True)
    require(fsk_demod.launches > 0, "v2 eye path never launched fsk_demod")
    require(got2e == got2, "v2 with the eye probe: payloads differ")
    rec = pipeline.receiver_stats_record(rx2e)
    eye = np.array(rec.get("eye_diagram", []))
    require(eye.shape == (8, 2 * cfg2.P) and np.isfinite(eye).all()
            and eye.max() == 1.0, f"v2 eye diagram: shape {eye.shape}")
    say("v2_stream_eye", packets=f"{len(got2e)}/{len(sent2)}",
        wall_s=f"{dt2e:.3f}", msps=f"{n2 / dt2e / 1e6:.4f}",
        demod_share=f"{rx2e.seconds['demod'] / dt2e:.3f}",
        eye_shape=eye.shape, high_sample=rx2e.last_eye[1],
        demod_launches=fsk_demod.launches, card=repr(smi))

    # 7. negative probe far below the cliff
    raw_neg = make_capture(cfg2, "v2", sent2[:8], -6.0, rng)
    got_neg, dt_neg, rx_neg = run_receiver(cfg2, "v2", raw_neg)
    require(got_neg == [], f"negative probe decoded {len(got_neg)} payloads")
    say("negative", ebno_db=-6.0, payloads=len(got_neg),
        detections=rx_neg.stats.detections, wall_s=f"{dt_neg:.3f}")

    # 8. the fused paths: decode_iq_fused (C=16, cu8) on the v2 and v1
    # captures, decode_iq_fused_overlap (4 slabs x 4 chunks) and
    # FusedReceiver (defaults: 4-s slabs, 8 chunks, depth 2) fed 2-s pushes
    # of the v2 capture three times over (more than two slabs)
    def fused_phase(phase, fn, n_samples, cfg, want):
        """Two calls of a fused path: the first pays the path's first-use
        costs (cuDNN, pinned memory, streams), the second is the steady
        state; the launch counts are those of the second."""
        walls = []
        for _ in range(2):
            fsk_demod.launches = bp_decode.launches = 0
            ktopk.launches = kcrc.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            require(got == want, f"{phase}: {len(got)}/{len(want)} payloads")
        counts = {"fsk_demod": fsk_demod.launches,
                  "deframe_topk": ktopk.launches,
                  "bp_decode": bp_decode.launches, "crc_pack": kcrc.launches}
        for name, count in counts.items():
            require(count > 0, f"{phase} never launched {name}")
        dt = walls[1]
        say(phase, packets=f"{len(got)}/{len(want)}", samples=n_samples,
            first_wall_s=f"{walls[0]:.3f}", wall_s=f"{dt:.3f}",
            msps=f"{n_samples / dt / 1e6:.4f}",
            realtime_msps=f"{cfg.Fs / 1e6:.3f}",
            launches=counts, card=repr(smi))

    fused_phase("fused_v2", lambda: pipeline.decode_iq_fused(
        raw2, "v2", n_chunks=FUSED_CHUNKS, device=dev), n2, cfg2, got2)
    fused_phase("fused_v1", lambda: pipeline.decode_iq_fused(
        raw1, "v1", n_chunks=FUSED_CHUNKS, device=dev), n1, cfg1, sent1)
    fused_phase("fused_overlap", lambda: pipeline.decode_iq_fused_overlap(
        raw2, "v2", n_slabs=OVERLAP_SLABS, chunks_per_slab=OVERLAP_CHUNKS,
        device=dev), n2, cfg2, got2)
    # where a fused step's time goes (v2, C=16, cu8): each stage timed on
    # the host clock with a synchronize after it, then the device's busy
    # share of one step and of a Receiver run from torch.profiler
    syms_pp, chunk_len, starts, skips = pipeline._fused_geometry(
        cfg2, "v2", n2, FUSED_CHUNKS, 8)
    k = pipeline._k_default(chunk_len, cfg2, syms_pp)
    fstep = pipeline._FusedStep(cfg2, "v2", "cu8", chunk_len, starts, k, 10,
                                dev)
    data2 = torch.from_numpy(raw2.reshape(-1, 2)).to(dev)
    skips_t = fstep.lanes(skips)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    fstep(data2, skips_t)                                   # warm
    (_, outs_f), t_demod = timed(lambda: fsk.demod_raw(
        cfg2, data2, "cu8", fstep.nf, fstep.starts, fstep.n_valid))
    soft_f = torch.where(outs_f.valid[..., None], outs_f.soft,
                         1.0).reshape(FUSED_CHUNKS, -1)
    (_, ok_f, _, _), t_topk = timed(lambda: deframe.deframe_topk(
        soft_f, "v2", k))
    llr_f = ldpc.sd_to_llr(torch.randn(FUSED_CHUNKS * k, 2580, device=dev))
    (bits_f, _, _), t_dec = timed(lambda: ldpc.decode(llr_f))
    _, t_crc = timed(lambda: dcrc.packet_crc_ok(bits_f))
    _, t_step = timed(lambda: fstep(data2, skips_t))
    wall_f, busy_f, nk_f = device_busy(lambda: fstep(data2, skips_t))
    wall_r, busy_r, nk_r = device_busy(lambda: run_receiver(cfg2, "v2",
                                                            raw2))

    def share(busy, wall):
        return "not measured" if busy is None else f"{busy / wall / 1e3:.4f}"
    require(busy_f is None or nk_f < 50,
            f"fused step: {nk_f} kernels (the CRC or pick loops on the host)")
    say("fused_breakdown", chunks=FUSED_CHUNKS, frames_per_lane=fstep.nf,
        picks_per_chunk=k, step_ms=f"{t_step:.3f}",
        demod_ms=f"{t_demod:.3f}", deframe_topk_ms=f"{t_topk:.3f}",
        of_which_decode_ms=f"{t_dec:.3f}", of_which_crc_ms=f"{t_crc:.3f}",
        profiled_step_wall_ms=f"{wall_f * 1e3:.3f}",
        step_kernels=nk_f if busy_f is not None else "not measured",
        step_device_busy_share=share(busy_f, wall_f),
        step_device_ms=("not measured" if busy_f is None
                        else f"{busy_f:.4f}"),
        receiver_wall_s=f"{wall_r:.3f}", receiver_kernels=nk_r,
        receiver_device_busy_share=share(busy_r, wall_r), card=repr(smi))

    # 8b. the CRC kernel against its plain version, bit-exact, in both row
    # layouts and the flags alone: at B = 128 and 176 on decoded noisy
    # codewords, and at the shapes the paths give it (the Receiver's push
    # batches here, the wideband fused C*k below)
    max_err.update(crc_pack=0, deframe_topk=0.0, channelize=0.0)
    crc_times = {}

    def crc_vs_plain(label, bits_b, timed_kw):
        """The kernel against crc_pack_reference on bits_b (both layouts,
        the flags alone); times in the layout of timed_kw."""
        B = bits_b.shape[0]
        for kw in ({"positions": torch.arange(B, dtype=torch.int32,
                                              device=dev) * 2617 - 5},
                   {"iters": torch.arange(B, dtype=torch.int32,
                                          device=dev) % 12}, timed_kw):
            got = dcrc.crc_pack(bits_b, **kw)
            want = dcrc.crc_pack_reference(bits_b, **kw)
            err = int((got.int() - want.int()).abs().max())
            max_err["crc_pack"] = max(max_err["crc_pack"], err)
            require(torch.equal(got, want), f"crc_pack {label} B={B} "
                    f"{list(kw)}: max |diff| {err}")
        ok_b = dcrc.packet_crc_ok(bits_b)
        require(torch.equal(ok_b, dcrc.packet_crc_ok_reference(bits_b)),
                f"crc_pack {label} B={B}: flags differ")
        bound, by = crc_bound(B)
        m = {"ms": graph_ms(lambda: dcrc.crc_pack(bits_b, **timed_kw)),
             "call_ms": event_ms(lambda: dcrc.crc_pack(bits_b, **timed_kw),
                                 CALL_REPS),
             "plain_ms": event_ms(lambda: dcrc.crc_pack_reference(
                 bits_b, **timed_kw), 3),
             "bound_ms": bound, "bound_by": by, "batch": B}
        crc_times[label] = m
        say("crc_vs_plain", kernel="crc_pack", case=label, batch=B,
            layout=list(timed_kw)[0], crc_ok=int(ok_b.sum()), mismatches=0,
            kernel_ms=f"{m['ms']:.4f}", call_ms=f"{m['call_ms']:.4f}",
            plain_ms=f"{m['plain_ms']:.3f}", bound_ms=f"{bound:.6f}",
            bound_by=by, share_of_bound=f"{bound / m['ms']:.5f}",
            card=repr(smi))

    for B in CRC_BATCHES:
        llr_b = noisy_llrs(B, 3.0, np.random.default_rng(SEED + 900 + B), dev)
        bits_b, _, _ = ldpc.decode(llr_b)
        crc_vs_plain(B, bits_b, {"positions": torch.arange(
            B, dtype=torch.int32, device=dev) * 2617 - 5})
    for B in sorted(set(batches)):         # decode_windows' (B, 260) rows
        llr_b = noisy_llrs(B, 3.0, np.random.default_rng(SEED + 950 + B), dev)
        bits_b, it_b, _ = ldpc.decode(llr_b)
        crc_vs_plain(f"receiver_{B}", bits_b, {"iters": it_b})

    # 8c. the acquisition kernel against its plain version on the fused
    # steps' soft bits (v2 and v1, C = 16): positions, exhausted flags and
    # the descrambled or stripped windows exact, LLRs within rtol 1e-5;
    # the decodes of both LLRs' give the same rows and iterations
    def fused_soft(cfg, mode, raw):
        n = len(raw) // 2
        sp, cl, st, sk = pipeline._fused_geometry(cfg, mode, n,
                                                  FUSED_CHUNKS, 8)
        step = pipeline._FusedStep(cfg, mode, "cu8", cl, st,
                                   pipeline._k_default(cl, cfg, sp), 10, dev)
        _, o = fsk.demod_raw(cfg, torch.from_numpy(raw.reshape(-1, 2)).to(
            dev), "cu8", step.nf, step.starts, step.n_valid)
        keep = o.valid & (step._frame[None] >= step.lanes(sk)[:, None])
        soft = torch.where(keep[..., None], o.soft, 1.0)
        return soft.reshape(FUSED_CHUNKS, -1).contiguous(), step.k

    topk_times = {}

    def topk_vs_plain(label, mode_t, soft_t, k_t):
        """The kernel against topk_windows_reference on soft_t (C, n):
        positions, exhausted flags and windows exact, LLRs within
        TOPK_LLR_RTOL, both LLRs' decodes equal.  Returns the kernel's
        (bits, positions) for the CRC check."""
        C = soft_t.shape[0]
        llr_g, pos_g, exh_g, sd_g = ktopk.llrs(soft_t, mode_t, k_t,
                                               with_sd=True)
        sd_w, pos_w, exh_w = deframe.topk_windows_reference(soft_t, mode_t,
                                                            k_t)
        llr_w = ldpc.sd_to_llr(sd_w)
        require(torch.equal(pos_g, pos_w) and torch.equal(exh_g, exh_w),
                f"deframe_topk {label}: positions differ")
        require(torch.equal(sd_g, sd_w), f"deframe_topk {label}: windows")
        live = ~exh_w.reshape(-1)
        rel = float(((llr_g - llr_w).abs() / llr_w.abs().clamp(min=1e-30))
                    [live].max()) if bool(live.any()) else 0.0
        err = float((llr_g - llr_w)[live].abs().max()) if bool(
            live.any()) else 0.0
        require(rel <= TOPK_LLR_RTOL and bool(llr_g[~live].isnan().all()),
                f"deframe_topk {label}: LLR rel err {rel}")
        max_err["deframe_topk"] = max(max_err["deframe_topk"], err)
        bits_g, it_g, _ = ldpc.decode(llr_g)
        bits_w, it_w, _ = ldpc.decode(llr_w)
        rows_g = dcrc.crc_pack(bits_g, positions=pos_g.reshape(-1))
        rows_w = dcrc.crc_pack_reference(bits_w, positions=pos_w.reshape(-1))
        iter_mis = int((it_g != it_w)[live].sum())
        require(torch.equal(rows_g, rows_w) and iter_mis == 0,
                f"deframe_topk {label}: decoded rows or {iter_mis} "
                f"iteration counts differ")
        nlive = ktopk.geometry(soft_t.shape[1], mode_t)[0]
        nuw = ktopk.mode_params(mode_t)[1]
        bound, by = topk_bound(C, soft_t.shape[1], k_t, nlive, nuw)
        m = {"ms": graph_ms(lambda: ktopk.llrs(soft_t, mode_t, k_t)),
             "call_ms": event_ms(lambda: ktopk.llrs(soft_t, mode_t, k_t),
                                 CALL_REPS),
             "plain_ms": event_ms(lambda: ldpc.sd_to_llr(
                 deframe.topk_windows_reference(soft_t, mode_t, k_t)[0]), 3),
             "bound_ms": bound, "bound_by": by, "llr_rel_err": rel,
             "picks": k_t, "symbols": soft_t.shape[1], "streams": C}
        topk_times[label] = m
        say("deframe_topk_vs_plain", kernel="deframe_topk", case=label,
            mode=mode_t, streams=C, symbols=soft_t.shape[1], picks=k_t,
            exhausted=int(exh_w.sum()), crc_ok=int(rows_w[:, 258].sum()),
            position_mismatch=0, llr_rel_err=f"{rel:.3e}",
            iters_mismatch=iter_mis, kernel_ms=f"{m['ms']:.4f}",
            call_ms=f"{m['call_ms']:.4f}",
            plain_ms=f"{m['plain_ms']:.3f}", bound_ms=f"{bound:.6f}",
            bound_by=by, share_of_bound=f"{bound / m['ms']:.5f}",
            scratch_bytes=ktopk.geometry(soft_t.shape[1], mode_t, C)[2],
            pick_smem_bytes=ktopk.geometry(soft_t.shape[1], mode_t)[3],
            card=repr(smi))
        return bits_g, pos_g

    topk_vs_plain("v2", "v2", soft_f.contiguous(), k)
    topk_vs_plain("v1", "v1", *fused_soft(cfg1, "v1", raw1))
    uw_times = uw_detect_phase(dev, smi)

    raw_t = np.tile(raw2, RX_TILES)

    def fused_receiver():
        rx = pipeline.FusedReceiver("v2", device=dev)
        step = 2 * int(2.0 * cfg2.Fs)
        out = []
        for i in range(0, len(raw_t), step):
            out += rx.push(raw_t[i:i + step])
        return out + rx.flush()
    want_t = pipeline.decode_iq_fused(raw_t, "v2", n_chunks=FUSED_CHUNKS,
                                      device=dev)
    require(want_t == got2 * RX_TILES,
            f"decode_iq_fused of the tiled capture: {len(want_t)} payloads")
    fused_phase("fused_receiver", fused_receiver, len(raw_t) // 2, cfg2,
                want_t)

    # 8d. wideband: 8 channels of the v2 flight geometry in a 7.68 MHz
    # capture, 12 packets a channel at 30 dB.  The channelizer kernel
    # against its plain version (all channels, and a selection in its
    # order); at the fused mode's own shapes, the demod kernel on the
    # channelizer's c64 lanes against its plain loop, the acquisition
    # kernel on the demod's soft bits (8 streams, kk picks) and the CRC
    # kernel on their decodes (8 kk codewords); then demod_multichannel in
    # its three modes, each called twice (the counts and the time are the
    # second call's): every channel recovers at least 11 of its 12 packets,
    # the fused mode all 12, the vectorized and per-Receiver modes the
    # same lists, which differ from the fused mode's only by the packet
    # lost to the false UW lock (WIDE_FALSE_LOCK); and the fused call's
    # stages timed with CUDA events and its kernels with torch.profiler
    cfgw = cfg2
    fs_w = cfgw.Fs * WIDE_CHANNELS
    t0 = time.perf_counter()
    wide, sent_w = channel.wideband_capture(cfgw, WIDE_CHANNELS,
                                            WIDE_PACKETS, WIDE_EBNO_DB,
                                            SEED + 800)
    synth_s = time.perf_counter() - t0
    n_w = len(wide)
    pairs_w = torch.from_numpy(wide.view(np.float32).reshape(-1, 2)).to(dev)
    # the capture as an SDR's cu8 bytes, and those bytes' float pairs
    raw_w = fsk.iq_to_cu8(wide * np.float32(WIDE_CU8_SCALE))
    raw_wt = torch.from_numpy(raw_w).to(dev)
    iq_q = fsk.iq_from_cu8(raw_w)
    pairs_q = torch.from_numpy(iq_q.view(np.float32).reshape(-1, 2)).to(dev)
    chan_times = {}
    # unit Gaussian pairs, as many as the capture: the reach case's input
    gauss_w = torch.from_numpy(np.random.default_rng(SEED + 900).normal(
        size=(n_w, 2)).astype(np.float32)).to(dev)
    # (label, channels, the kernel's input, its format, the plain
    # version's pairs, N, taps a phase)
    for label, sel, x_c, fmt_c, plain_x, n_ch, t_ch in (
            ("all", None, pairs_w, "c64", pairs_w, WIDE_CHANNELS, 12),
            ("select", WIDE_SELECT, pairs_w, "c64", pairs_w, WIDE_CHANNELS,
             12),
            ("cu8", None, raw_wt, "cu8", pairs_q, WIDE_CHANNELS, 12),
            ("runtime_n", None, pairs_w, "c64", pairs_w, RUNTIME_N, 12),
            ("wide_n", WIDE_N_SELECT, pairs_w, "c64", pairs_w, WIDE_N, 12),
            ("taps", None, pairs_w, "c64", pairs_w, WIDE_CHANNELS,
             RUNTIME_TAPS),
            ("reach", (REACH[0] - 1, 2, 0), gauss_w, "c64", gauss_w,
             *REACH)):
        def call():
            return channelizer.channelize_pairs(x_c, n_ch, t_ch,
                                                channels=sel,
                                                input_format=fmt_c)
        got = call()
        want = torch.view_as_real(channelizer.channelize_reference(
            torch.view_as_complex(plain_x), n_ch, t_ch, channels=sel)
        ).reshape(-1, 2)
        err = float((got - want).abs().max())
        rms = float(want.square().sum(1).mean().sqrt())
        require(got.shape == want.shape and err <= CHANNELIZE_TOL * rms,
                f"channelize {label}: max |diff| {err} of rms {rms}")
        max_err["channelize"] = max(max_err["channelize"], err)
        extra = {}
        if fmt_c == "cu8":         # the conversion is exact: the same bits
            same = torch.equal(got, channelizer.channelize_pairs(
                pairs_q, n_ch, channels=sel))
            require(same, "channelize cu8: differs from the float-pair "
                    "route on the same samples")
            extra["bitwise_equal_to_c64_route"] = same
        nsel = n_ch if sel is None else len(sel)
        bound, by = channelize_bound(n_w, n_ch, t_ch, nsel,
                                     2 if fmt_c == "cu8" else 8)
        tile_c, tw_smem_c, fl_c = kchan.plan(n_ch, t_ch, nsel, fmt_c)
        m = {"ms": graph_ms(call), "call_ms": event_ms(call, 20),
             "plain_ms": event_ms(lambda: channelizer.channelize_reference(
                 torch.view_as_complex(plain_x), n_ch, t_ch, channels=sel),
                 3),
             "bound_ms": bound, "bound_by": by, "rel_err": err / rms}
        m["in_flight"] = fl_c
        chan_times[label] = m
        say("channelize_vs_plain", kernel="channelize", channels=label,
            input_format=fmt_c, n_channels=n_ch, taps=t_ch, selected=nsel,
            samples=n_w, max_abs_err=f"{err:.3e}",
            rel_err=f"{err / rms:.3e}", tol=CHANNELIZE_TOL,
            kernel_ms=f"{m['ms']:.4f}", call_ms=f"{m['call_ms']:.4f}",
            plain_ms=f"{m['plain_ms']:.3f}", bound_ms=f"{bound:.6f}",
            bound_by=by, share_of_bound=f"{bound / m['ms']:.5f}",
            tile_frames=tile_c, twiddles_in_smem=tw_smem_c,
            in_flight=fl_c,
            templated=kchan.templated(n_ch, t_ch, tile_c, tw_smem_c, fl_c),
            blocks_tiles=kchan.geometry(
                n_w // n_ch, tile_c, kchan._sms(0),
                kchan.smem_bytes(n_ch, t_ch, tile_c, nsel, fmt_c,
                                 tw_smem_c, fl_c)),
            card=repr(smi), **extra)

    require(chan_times["reach"]["in_flight"] == 0,
            "channelize reach: the plan keeps a tile in flight")

    # the fused mode's front end, as demod_multichannel runs it
    F_w = n_w // WIDE_CHANNELS
    nf_w = cfgw.num_frames(F_w)
    kk_w = int(np.ceil(nf_w * cfgw.Nbits / framing.V2_SYMBOLS_PER_PACKET)) + 2
    lanes_w = (cfgw, channelizer.channelize_pairs(pairs_w, WIDE_CHANNELS),
               "c64", nf_w,
               torch.arange(WIDE_CHANNELS, dtype=torch.int64, device=dev)
               * F_w, torch.full((WIDE_CHANNELS,), F_w, dtype=torch.int64,
                                 device=dev))
    fsk_demod.launches = 0
    got_d = fsk.demod_raw(*lanes_w)
    torch.cuda.synchronize()
    require(fsk_demod.launches == 1, "wide demod_vs_plain: no kernel launch")
    t0 = time.perf_counter()
    want_d = fsk.demod_raw_reference(*lanes_w)
    torch.cuda.synchronize()
    plain_ms_d = (time.perf_counter() - t0) * 1e3
    cmp = demod_compare(got_d, want_d)
    require(cmp["valid"] == cmp["nin"] == cmp["f_est"] == cmp["bits"] == 0
            and cmp["rel_err"] <= DEMOD_SOFT_TOL,
            f"demod_vs_plain wideband c64 lanes: {cmp}")
    ms_d = event_ms(lambda: fsk.demod_raw(*lanes_w), 3)
    bound, by, bound_sm = demod_bound(cfgw, want_d[1],
                                      WIDE_CHANNELS * F_w, 8)
    demod_times["wide"] = dict(cmp, ms=ms_d, plain_ms=plain_ms_d,
                               bound_ms=bound, bound_by=by,
                               bound_one_sm_ms=bound_sm)
    say("demod_vs_plain", kernel="fsk_demod", case="wideband_c64",
        lanes=WIDE_CHANNELS, frames=cmp["frames"],
        valid_mismatch=cmp["valid"], nin_mismatch=cmp["nin"],
        f_est_mismatch=cmp["f_est"], bit_mismatch=cmp["bits"],
        max_abs_err=f"{cmp['max_abs_err']:.3e}",
        rel_err=f"{cmp['rel_err']:.3e}", tol=DEMOD_SOFT_TOL,
        kernel_ms=f"{ms_d:.4f}",
        kernel_ms_per_frame=f"{ms_d / nf_w:.5f}",
        plain_ms=f"{plain_ms_d:.2f}", plain_timing="host clock, one call",
        bound_ms=f"{bound:.6f}", bound_by=by,
        share_of_bound=f"{bound / ms_d:.5f}",
        bound_one_sm_ms=f"{bound_sm:.6f}",
        share_of_one_sm_bound=f"{bound_sm / ms_d:.5f}", card=repr(smi))
    outs_w = got_d[1]
    soft_w = torch.where(outs_w.valid[..., None], outs_w.soft,
                         1.0).reshape(WIDE_CHANNELS, -1).contiguous()
    bits_w, pos_w = topk_vs_plain("wideband", "v2", soft_w, kk_w)
    crc_vs_plain("wideband", bits_w, {"positions": pos_w.reshape(-1)})

    wide_counts, wide_out, wide_walls = {}, {}, {}
    for mode_w, kw in (("fused", {"fused": True}), ("vectorized", {}),
                       ("receiver", {"vectorized": False})):
        walls = []
        for _ in range(2):
            for mod in (kchan, fsk_demod, ktopk, bp_decode, kcrc):
                mod.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_w = channelizer.demod_multichannel(
                wide, fs_w, WIDE_CHANNELS, cfgw, device=dev, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wide_counts[mode_w] = {
            "channelize": kchan.launches, "fsk_demod": fsk_demod.launches,
            "deframe_topk": ktopk.launches, "bp_decode": bp_decode.launches,
            "crc_pack": kcrc.launches}
        wide_out[mode_w], wide_walls[mode_w] = out_w, walls
        need = ("channelize", "fsk_demod", "bp_decode", "crc_pack") + (
            ("deframe_topk",) if mode_w == "fused" else ())
        for name in need:
            require(wide_counts[mode_w][name] > 0,
                    f"wideband {mode_w} never launched {name}")
        got_n = {c: len(v) for c, v in out_w.items()}
        for c in range(WIDE_CHANNELS):
            require(len(out_w[c]) >= WIDE_PACKETS - 1
                    and all(p in sent_w[c] for p in out_w[c])
                    and out_w[c] == sorted(out_w[c], key=sent_w[c].index),
                    f"wideband {mode_w}: channel {c} gave {len(out_w[c])} "
                    f"packets, {got_n}")
        msps = n_w / walls[1] / 1e6
        say("wideband", mode=mode_w, channels=WIDE_CHANNELS,
            band_mhz=fs_w / 1e6, samples=n_w,
            packets=f"{sum(got_n.values())}/{WIDE_CHANNELS * WIDE_PACKETS}",
            channels_complete=sum(v >= WIDE_PACKETS - 1
                                  for v in got_n.values()),
            first_wall_s=f"{walls[0]:.3f}", wall_s=f"{walls[1]:.4f}",
            band_msps=f"{msps:.4f}",
            x_realtime=f"{msps * 1e6 / fs_w:.3f}",
            launches=wide_counts[mode_w], synth_s=f"{synth_s:.2f}",
            card=repr(smi))
    # the vectorized and per-Receiver modes run the reference's UW FSM and
    # must agree exactly; the fused mode's top-k acquisition differs from
    # it where the FSM locks on a false UW hit in the idle bits and its
    # window swallows the packet after it: such packets are counted
    require(wide_out["vectorized"] == wide_out["receiver"],
            "wideband: the vectorized and per-Receiver lists differ")
    require(wide_out["fused"] == sent_w,
            f"wideband fused: {sum(map(len, wide_out['fused'].values()))} "
            f"of {WIDE_CHANNELS * WIDE_PACKETS} packets in order")
    lock_c, lock_p = WIDE_FALSE_LOCK
    require(wide_out["vectorized"] == {
        c: [p for p in sent_w[c] if (c, sent_w[c].index(p)) != (lock_c, lock_p)]
        for c in range(WIDE_CHANNELS)},
        "wideband vectorized: the lists differ from the fused mode's by "
        f"more than packet {lock_p} of channel {lock_c}")
    fsm_only = sum(len(set(wide_out["vectorized"][c])
                       - set(wide_out["fused"][c]))
                   for c in range(WIDE_CHANNELS))
    topk_only = sum(len(set(wide_out["fused"][c])
                        - set(wide_out["vectorized"][c]))
                    for c in range(WIDE_CHANNELS))
    say("wideband_modes", fused_equals_vectorized=(
        wide_out["fused"] == wide_out["vectorized"]),
        vectorized_equals_receiver=True, only_fused=topk_only,
        only_vectorized=fsm_only, false_lock=WIDE_FALSE_LOCK)

    # the raw-cu8 route: the capture's cu8 bytes straight to the
    # channelizer kernel, fused and vectorized (the CLI's default), each
    # held to the float-pair route on iq_from_cu8 of the same bytes
    wide_cu8 = {}
    for mode_w, kw in (("fused", {"fused": True}), ("vectorized", {})):
        want_q = channelizer.demod_multichannel(
            iq_q, fs_w, WIDE_CHANNELS, cfgw, device=dev, **kw)
        walls = []
        for _ in range(2):
            for mod in (kchan, fsk_demod, ktopk, bp_decode, kcrc):
                mod.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_q = channelizer.demod_multichannel(
                raw_w, fs_w, WIDE_CHANNELS, cfgw, device=dev,
                input_format="cu8", **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = {"channelize": kchan.launches,
                  "fsk_demod": fsk_demod.launches,
                  "deframe_topk": ktopk.launches,
                  "bp_decode": bp_decode.launches, "crc_pack": kcrc.launches}
        require(counts["channelize"] == 1 and counts["fsk_demod"] == 1,
                f"wideband cu8 {mode_w}: launches {counts}")
        require(out_q == want_q, f"wideband cu8 {mode_w}: the lists differ "
                "from the float-pair route on the same samples")
        wide_cu8[mode_w] = out_q
        npk = sum(map(len, out_q.values()))
        msps = n_w / walls[1] / 1e6
        say("wideband_cu8", mode=mode_w, channels=WIDE_CHANNELS,
            scale=WIDE_CU8_SCALE, samples=n_w, bytes=raw_w.nbytes,
            packets=f"{npk}/{WIDE_CHANNELS * WIDE_PACKETS}",
            equals_c64_route=True,
            equals_unquantised=(out_q == wide_out[mode_w]),
            first_wall_s=f"{walls[0]:.3f}", wall_s=f"{walls[1]:.4f}",
            band_msps=f"{msps:.4f}", x_realtime=f"{msps * 1e6 / fs_w:.3f}",
            launches=counts, card=repr(smi))
    require(wide_cu8["fused"] == sent_w,
            f"wideband cu8 fused: {sum(map(len, wide_cu8['fused'].values()))}"
            f" of {WIDE_CHANNELS * WIDE_PACKETS} packets in order")

    # where the fused call's time goes, for both routes: its stages as
    # demod_multichannel runs them, each closed by a CUDA event (device
    # time between the marks, launch gaps included), then one call under
    # torch.profiler (each kernel's device time, the device's busy share)
    def wide_stages(src, fmt_s):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        x_s = channelizer._device_input(src, dev, fmt_s)
        ev[1].record()
        chans = channelizer.channelize_pairs(x_s, WIDE_CHANNELS,
                                             input_format=fmt_s)
        ev[2].record()
        _, o = fsk.demod_raw(cfgw, chans, "c64", nf_w, *lanes_w[4:])
        ev[3].record()
        sw = torch.where(o.valid[..., None], o.soft, 1.0).reshape(
            WIDE_CHANNELS, -1)
        llr, pos, _ = ktopk.llrs(sw.contiguous(), "v2", kk_w)
        ev[4].record()
        bits, _, _ = ldpc.decode(llr)
        ev[5].record()
        dcrc.crc_pack(bits, positions=pos.reshape(-1)).cpu()
        ev[6].record()
        ev[6].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return wall, [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
    for src, fmt_s in ((wide, "c64"), (raw_w, "cu8")):
        wide_stages(src, fmt_s)
        stage_wall, stage_ms = wide_stages(src, fmt_s)
        per_kernel = {}
        wall_wf, busy_wf, nk_wf = device_busy(
            lambda: channelizer.demod_multichannel(
                src, fs_w, WIDE_CHANNELS, cfgw, fused=True, device=dev,
                input_format=fmt_s), per_kernel)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        say("wideband_breakdown", mode="fused", input_format=fmt_s,
            h2d_bytes=src.nbytes, stages_wall_ms=f"{stage_wall:.3f}",
            h2d_ms=f"{stage_ms[0]:.3f}", channelize_ms=f"{stage_ms[1]:.3f}",
            demod_ms=f"{stage_ms[2]:.3f}",
            deframe_topk_ms=f"{stage_ms[3]:.3f}",
            decode_ms=f"{stage_ms[4]:.3f}",
            crc_and_d2h_ms=f"{stage_ms[5]:.3f}",
            profiled_wall_ms=f"{wall_wf * 1e3:.3f}",
            kernels=nk_wf if busy_wf is not None else "not measured",
            device_busy_share=share(busy_wf, wall_wf),
            kernel_device_ms={n[:40]: round(t, 4) for n, t in top},
            card=repr(smi))
    for name in ("channelize", "deframe_topk", "crc_pack"):
        main_launches[name] = wide_counts["fused"][name]

    # 8e. the host runtime: the C UW FSM against its numpy version on the
    # flight captures and the wideband channels, and the paths it sits on
    # re-timed
    native_phase(cfg1, cfg2, raw1, raw2, wide, fs_w, wide_out, dev, smi)

    # 8f. the measurement tools at the flight geometries (their own counts)
    tool_launches = tools_phase(cfg1, cfg2, dev, smi)

    with tempfile.TemporaryDirectory() as tmp:
        # 9. CLI on the v2 capture: streaming, --parallel, --slabs
        path = os.path.join(tmp, "smoke_v2.cu8")
        raw2.tofile(path)
        rc, line, err, dt_cli = run_cli(path, "--mode", "v2", "--image-dir",
                                        os.path.join(tmp, "img"))
        require(rc == 0, f"CLI exit {rc}: {err}")
        require(f"crc_ok={V2_PACKETS} " in line, f"CLI: {line}")
        say("cli", rc=rc, wall_s=f"{dt_cli:.2f}", stderr=repr(line))
        for phase, flag in (("cli_parallel", ("--parallel", "16")),
                            ("cli_slabs", ("--slabs", "4"))):
            rc, line, err, dt_cli = run_cli(path, "--mode", "v2", *flag,
                                            "--image-dir",
                                            os.path.join(tmp, phase))
            require(rc == 0, f"{phase} exit {rc}: {err}")
            require(f"crc_ok={V2_PACKETS} " in line, f"{phase}: {line}")
            say(phase, rc=rc, wall_s=f"{dt_cli:.2f}", stderr=repr(line),
                card=repr(smi))

        # 9b. the CLI's wideband mode on the 8-channel capture (c64), then
        # with --channel-select: exit 0, every packet routed
        path_w = os.path.join(tmp, "wide.c64")
        wide.tofile(path_w)
        for phase, flag, chans in (
                ("cli_wideband", (), range(WIDE_CHANNELS)),
                ("cli_wideband_select", ("--channel-select", ",".join(
                    str(c) for c in WIDE_SELECT)), WIDE_SELECT)):
            total = sum(len(wide_out["vectorized"][c]) for c in chans)
            rc, line, err, dt_cli = run_cli(
                path_w, "--channels", str(WIDE_CHANNELS), *flag,
                "--image-dir", os.path.join(tmp, phase), fmt="c64")
            require(rc == 0, f"{phase} exit {rc}: {err}")
            require(line.startswith(f"wideband: {WIDE_CHANNELS} channels, "
                                    f"{total} packets"), f"{phase}: {line}")
            say(phase, rc=rc, wall_s=f"{dt_cli:.2f}", stderr=repr(line),
                card=repr(smi))
        # the same capture as cu8 bytes (--format cu8: the raw route):
        # the vectorized mode's count on those bytes, and the c64 run's
        path_q = os.path.join(tmp, "wide.cu8")
        raw_w.tofile(path_q)
        total = sum(map(len, wide_cu8["vectorized"].values()))
        total_c64 = sum(map(len, wide_out["vectorized"].values()))
        rc, line, err, dt_cli = run_cli(
            path_q, "--channels", str(WIDE_CHANNELS), "--image-dir",
            os.path.join(tmp, "cli_wideband_cu8"), fmt="cu8")
        require(rc == 0, f"cli_wideband_cu8 exit {rc}: {err}")
        require(line.startswith(f"wideband: {WIDE_CHANNELS} channels, "
                                f"{total} packets"),
                f"cli_wideband_cu8: {line}")
        say("cli_wideband_cu8", rc=rc, wall_s=f"{dt_cli:.2f}",
            stderr=repr(line), same_count_as_c64=(total == total_c64),
            card=repr(smi))

        # 10. the decoder-throughput stage of bench.py: B = 2048 at 7.5 dB,
        # each decoder timed, then held against its plain version
        r2 = np.random.default_rng(1)
        ib = np.unpackbits(r2.integers(0, 256, (STAGE_BATCH, 258),
                                       dtype=np.uint8), axis=1)
        cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
        esn0 = 10 ** (STAGE_EBNO_DB / 10) * 0.8
        sd = (1 - 2.0 * cw) + r2.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
        llr = ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32,
                                             device=dev))
        stage = {}
        for name, op, plain, reps, minsum, table_bytes in decoders:
            if name == "bp_onehot":        # as bench.py calls decode_pallas
                op = lambda x: ldpc_onehot.decode_onehot(
                    x, batch_tile=STAGE_BATCH_TILE)
            bp_decode.launches = bp_decode.minsum_launches = 0
            bp_onehot.launches = 0
            got = op(llr)
            counts = {"bp_decode": bp_decode.launches,
                      "bp_minsum": bp_decode.minsum_launches,
                      "bp_onehot": bp_onehot.launches}
            require(counts[name] == 1 and sum(counts.values()) == 1,
                    f"ldpc_stage {name}: launches {counts}")
            if name == "bp_onehot":
                main_launches[name] = counts[name]
                sp = mismatches(got, ldpc.decode_reference(llr))
                require(sp[:3] == (0, 0, 0),
                        f"ldpc_stage bp_onehot differs from decode_reference")
            mis = mismatches(got, plain(llr))
            require(mis[:3] == (0, 0, 0),
                    f"ldpc_stage {name}: mismatches {mis[:3]}")
            require(int(got[2].sum()) >= STAGE_BATCH - 2,
                    f"ldpc_stage {name}: {int(got[2].sum())} converged")
            m = measure(name, op, plain, 1, minsum, table_bytes, llr, got)
            stage[name] = m
            show("ldpc_stage", name, STAGE_BATCH, STAGE_EBNO_DB, m,
                 converged=int(got[2].sum()), mismatches=sum(mis[:3]),
                 codewords_per_s=f"{STAGE_BATCH / m['ms'] * 1e3:.0f}",
                 plain_codewords_per_s=(
                     f"{STAGE_BATCH / m['plain_ms'] * 1e3:.0f}"))

        # 11. LDPC BER sweeps, both algorithms (the counted min-sum run)
        for algo, count in (("sum-product", "bp_decode"),
                            ("min-sum", "bp_minsum")):
            bp_decode.launches = bp_decode.minsum_launches = 0
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(SEED)
            r = sweep.ldpc_ber_sweep(SWEEP_EBNO_DB, STAGE_BATCH, gen,
                                     device=dev, algo=algo)
            dt = time.perf_counter() - t0
            n = (bp_decode.launches if count == "bp_decode"
                 else bp_decode.minsum_launches)
            require(n == len(SWEEP_EBNO_DB), f"ber_sweep {algo}: {n} launches")
            if count == "bp_minsum":
                main_launches[count] = n
            fer, ber = r["fer"], r["ber"]
            require(fer[0] >= 0.9 and fer[-1] <= 0.01,
                    f"ber_sweep {algo}: fer {fer.tolist()}")
            require(np.all(np.isfinite(ber)) and np.all(ber <= fer),
                    f"ber_sweep {algo}: ber {ber.tolist()} fer {fer.tolist()}")
            say("ber_sweep", algo=algo, ebno_db=list(SWEEP_EBNO_DB),
                codewords=r["n_codewords"],
                fer=[round(float(x), 5) for x in fer],
                ber=[f"{x:.3e}" for x in ber],
                mean_iters=[round(float(x), 3) for x in r["mean_iters"]],
                launches=n, wall_s=f"{dt:.3f}")

        # 12. full-chain PER at the v2 flight geometry
        walls = []
        for _ in range(2):               # first call, then steady state
            bp_decode.launches = fsk_demod.launches = 0
            t0 = time.perf_counter()
            r = sweep.chain_per_sweep(cfg2, [4.0, 20.0], 8, device=dev)
            walls.append(time.perf_counter() - t0)
            require(r["per"].tolist() == [1.0, 0.0], f"chain_per: {r['per']}")
        require(bp_decode.launches == 2, "chain_per: bp_decode launches")
        require(fsk_demod.launches == 2, "chain_per: fsk_demod launches")
        say("chain_per", ebno_db=[4.0, 20.0], trials=r["trials"],
            per=r["per"].tolist(), mean_iters=r["mean_iters"].tolist(),
            launches=bp_decode.launches, demod_launches=fsk_demod.launches,
            first_wall_s=f"{walls[0]:.3f}", wall_s=f"{walls[1]:.3f}",
            card=repr(smi))

        # 13. coarse acquisition: v2 packets with the capture tuned 300 kHz
        # off (tones at 492 and 588 kHz, outside the estimator band)
        sent_a = [text_message(f"acq {i}", i) for i in range(ACQ_PACKETS)]
        raw_a = make_capture(cfg2, "v2", sent_a, EBNO_DB,
                             np.random.default_rng(SEED + 300),
                             shift_hz=ACQ_SHIFT_HZ)
        step = cfg2.Rs // 2
        grid = np.arange(-(cfg2.Fs // 2) + 2 * step,
                         cfg2.Fs // 2 - 2 * step, step, dtype=np.float32)
        probe = fsk.iq_from_cu8(raw_a[: 2 * int(0.1 * cfg2.Fs)])
        walls = []
        for _ in range(2):               # first call, then steady state
            fsk_demod.launches = 0
            t0 = time.perf_counter()
            best, scores = sweep.acquisition_search(cfg2, probe, grid,
                                                    device=dev)
            walls.append(time.perf_counter() - t0)
        dt = walls[1]
        acq_launches = fsk_demod.launches
        require(acq_launches == 1, f"acquire: {acq_launches} fsk_demod "
                "launches")
        require(ACQ_LOCK_HZ[0] <= best <= ACQ_LOCK_HZ[1],
                f"acquire picked {best} Hz, scores {scores.tolist()}")
        require(scores.max() >= 32 - 8, f"acquire: scores {scores.tolist()}")
        path = os.path.join(tmp, "smoke_acq.cu8")
        raw_a.tofile(path)
        plain_rc, plain_line, _, _ = run_cli(
            path, "--mode", "v2", "--image-dir", os.path.join(tmp, "img0"))
        rc, line, err, dt_cli = run_cli(
            path, "--mode", "v2", "--acquire", "0.1", "--image-dir",
            os.path.join(tmp, "img1"))
        require(rc == 0, f"CLI --acquire exit {rc}: {err}")
        require(f"crc_ok={ACQ_PACKETS} " in line, f"CLI --acquire: {err}")
        require(plain_rc == 0 and "crc_ok=0 " in plain_line,
                f"CLI without --acquire: {plain_line}")
        acq_msg = [ln for ln in err.splitlines() if "acquired" in ln]
        say("acquire", shift_hz=ACQ_SHIFT_HZ, grid_hz=f"{grid[0]:.0f}.."
            f"{grid[-1]:.0f}/{step}", best_hz=best,
            best_score=float(scores.max()), first_search_s=f"{walls[0]:.3f}",
            search_s=f"{dt:.3f}",
            lanes=len(grid), demod_launches=acq_launches,
            cli=repr(acq_msg[0] if acq_msg else ""), cli_stderr=repr(line),
            without_acquire=repr(plain_line.split(" images")[0]),
            cli_wall_s=f"{dt_cli:.2f}")

        # 14. the modem tools (each with its launch counts zeroed before
        # and read after) and the transmit side
        probe_m = probe_phase(cfg2, raw_d, dev, smi)
        selftest_phase(smi)
        tx_rx_phase(tmp, (("v2", cfg2), ("v1", cfg1)), smi)
        ber_phase(cfg2, smi)
        bench_phase(smi)

        # 15. the ground-station apps, the link emulator and the flight
        # side, fed by the card's receiver (counts zeroed before, read
        # after, in each phase)
        link_phase(cfg2, smi)
        flight = flight_phase(cfg2, tmp, smi)
        apps_phase(cfg2, *flight, tmp, smi)
        # the port's deploy script, as a station runs it, at both flight
        # rates
        deploy_phase(tmp, smi)

        # 16. the scale-out layer: ranks in processes of their own, each
        # with its own launch counts; then the golden flight-rate tables
        mesh_phase(cfg2, raw2, tmp, smi)
        golden_phase(smi)

        # 17. the pipelined Receiver, the port's benchmark and the image
        # corpus, each with its own launch counts
        pipelined_phase(cfg1, cfg2, dev, smi)
        bench_launches = port_bench_phase(cfg2, dev, smi)
        corpus_phase(tmp, smi)
    main_launches["fsk_demod_probe"] = probe_m["launches"]

    sources = {
        "bp_decode": ("wenet_tpu_torch/csrc/bp_decode.cu",
                      "wenet_tpu/ops/ldpc_pallas2.py:114"),
        "bp_minsum": ("wenet_tpu_torch/csrc/bp_decode.cu",
                      "wenet_tpu/ops/ldpc.py:189"),
        "bp_onehot": ("wenet_tpu_torch/csrc/bp_onehot.cu",
                      "wenet_tpu/ops/ldpc_pallas.py:86"),
    }
    out = []
    lanes1, frames1 = DEMOD_CASES[0]
    d1, d16 = demod_times[lanes1], demod_times[DEMOD_CASES[1][0]]
    dw = demod_times["wide"]
    for name, (source, replaces) in sources.items():
        m = times[(name, *MAIN_CASE)]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": main_launches[name],
                    "max_abs_err": max_err[name], "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": m["bound_by"], "library_ms": None,
                    "call_ms": m["call_ms"],
                    "batch": MAIN_CASE[0], "snr_db": MAIN_CASE[1]})
    # the demod loop was an XLA scan, not a Pallas kernel: `replaces` names
    # the scan (demod_stream); no single PyTorch call computes it
    # (library_ms null)
    out.append({"name": "fsk_demod", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/fsk_demod.cu",
                "replaces": "wenet_tpu/ops/fsk.py:505",
                "launches": main_launches["fsk_demod"],
                "max_abs_err": max(d1["max_abs_err"], d16["max_abs_err"],
                                   dw["max_abs_err"]),
                "ms": d1["ms"], "plain_ms": d1["plain_ms"],
                "bound_ms": d1["bound_ms"], "bound_by": d1["bound_by"],
                "library_ms": None, "lanes": lanes1,
                "frames": d1["frames"],
                "ms_per_frame": d1["ms"] / d1["frames"],
                "bound_one_sm_ms": d1["bound_one_sm_ms"],
                "eye_rel_err": max(d1["eye_rel_err"], d16["eye_rel_err"]),
                "lanes16_ms": d16["ms"], "lanes16_plain_ms": d16["plain_ms"],
                "lanes16_bound_ms": d16["bound_ms"],
                "lanes16_bound_one_sm_ms": d16["bound_one_sm_ms"],
                "lanes16_ms_per_frame": d16["ms"] / (d16["frames"] / 16),
                "wideband_c64_lanes": WIDE_CHANNELS,
                "wideband_c64_ms": dw["ms"],
                "wideband_c64_plain_ms": dw["plain_ms"],
                "wideband_c64_bound_ms": dw["bound_ms"],
                "wideband_c64_max_abs_err": dw["max_abs_err"],
                "spec_launches": main_launches["fsk_demod_spec"],
                "push_cases": [
                    {"mode": mode, "lanes": lanes, "frames": frames,
                     **{k: demod_times[(mode, lanes, frames)][k]
                        for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "bound_one_sm_ms", "max_abs_err",
                                  "spec_stats")}}
                    for mode, lanes, frames in DEMOD_PUSH_CASES]})
    # the PROBE variant of the same kernel, as probe_demod runs it: it
    # replaces the per-frame trace scan of wenet_tpu/utils/probe.py
    out.append({"name": "fsk_demod_probe", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/fsk_demod.cu",
                "replaces": "wenet_tpu/utils/probe.py:22",
                "launches": main_launches["fsk_demod_probe"],
                "max_abs_err": probe_m["max_abs_err"], "ms": probe_m["ms"],
                "plain_ms": probe_m["plain_ms"],
                "bound_ms": probe_m["bound_ms"],
                "bound_by": probe_m["bound_by"], "library_ms": None,
                "lanes": 1, "frames": probe_m["frames"],
                "ms_per_frame": probe_m["ms"] / probe_m["frames"],
                "flight_kernel_ms": probe_m["flight_ms"],
                "trace_rel_err": probe_m["trace_rel_err"],
                "bound_one_sm_ms": probe_m["bound_one_sm_ms"]})
    c176, c128 = crc_times[CRC_BATCHES[1]], crc_times[CRC_BATCHES[0]]
    out.append({"name": "crc_pack", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/crc_pack.cu",
                "replaces": "wenet_tpu/ops/crc.py:25",
                "launches": main_launches["crc_pack"],
                "max_abs_err": max_err["crc_pack"], "ms": c176["ms"],
                "plain_ms": c176["plain_ms"], "bound_ms": c176["bound_ms"],
                "bound_by": c176["bound_by"], "library_ms": None,
                "call_ms": c176["call_ms"], "batch": CRC_BATCHES[1],
                "batch128_ms": c128["ms"], "batch128_plain_ms":
                c128["plain_ms"], "batch128_bound_ms": c128["bound_ms"],
                "other_cases": {str(lb): {key: m[key] for key in (
                    "batch", "ms", "plain_ms", "bound_ms")}
                    for lb, m in crc_times.items()
                    if lb not in CRC_BATCHES}})
    t2, t1, tw = (topk_times[lb] for lb in ("v2", "v1", "wideband"))
    out.append({"name": "deframe_topk", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/deframe_topk.cu",
                "replaces": "wenet_tpu/ops/deframe.py:217",
                "launches": main_launches["deframe_topk"],
                "max_abs_err": max_err["deframe_topk"], "ms": t2["ms"],
                "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
                "bound_by": t2["bound_by"], "library_ms": None,
                "streams": FUSED_CHUNKS, "picks": t2["picks"],
                "symbols": t2["symbols"], "call_ms": t2["call_ms"],
                "llr_rel_err": max(m["llr_rel_err"]
                                   for m in topk_times.values()),
                "v1_ms": t1["ms"], "v1_plain_ms": t1["plain_ms"],
                "v1_bound_ms": t1["bound_ms"],
                "wideband_streams": tw["streams"],
                "wideband_symbols": tw["symbols"],
                "wideband_picks": tw["picks"], "wideband_ms": tw["ms"],
                "wideband_plain_ms": tw["plain_ms"],
                "wideband_bound_ms": tw["bound_ms"]})
    uf, u1, u8 = (uw_times[c] for c in ("v2_flight", "v1_flight",
                                         "v2_wideband"))
    # the JAX package runs this FSM on the host (`replaces` null; its
    # counterpart there is wenet_tpu/native/deframe_fsm.c)
    out.append({"name": "uw_detect", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/uw_detect.cu",
                "replaces": None,
                "host_counterpart": "wenet_tpu/native/deframe_fsm.c",
                "launches": main_launches["uw_detect"], "max_abs_err": 0,
                "ms": uf["kernel_ms"], "plain_ms": uf["plain_ms"],
                "bound_ms": uf["bound_ms"], "bound_by": uf["bound_by"],
                "library_ms": None, "lanes": uf["lanes"],
                "symbols": uf["symbols"],
                "v1_ms": u1["kernel_ms"], "v1_plain_ms": u1["plain_ms"],
                "v1_bound_ms": u1["bound_ms"], "v1_symbols": u1["symbols"],
                "wideband_lanes": u8["lanes"], "wideband_ms": u8["kernel_ms"],
                "wideband_plain_ms": u8["plain_ms"],
                "wideband_bound_ms": u8["bound_ms"],
                "window_launches": main_launches["fsm_windows"],
                "window_ms": uf["window_ms"],
                "window_llr_rel_err": max(m["llr_rel_err"]
                                          for m in uw_times.values()),
                "deframe_push_ms": {c: m["deframe_ms"]
                                    for c, m in uw_times.items()}})
    ca, cs, cq, cr, cw, ct, cn = (chan_times[lb] for lb in (
        "all", "select", "cu8", "runtime_n", "wide_n", "taps", "reach"))
    out.append({"name": "channelize", "route": "cuda",
                "source": "wenet_tpu_torch/csrc/channelize.cu",
                "replaces": "wenet_tpu/ops/channelizer.py:37",
                "launches": main_launches["channelize"],
                "max_abs_err": max_err["channelize"], "ms": ca["ms"],
                "plain_ms": ca["plain_ms"], "bound_ms": ca["bound_ms"],
                "bound_by": ca["bound_by"], "library_ms": None,
                "n_channels": WIDE_CHANNELS, "samples": n_w,
                "call_ms": ca["call_ms"],
                "rel_err": max(m["rel_err"] for m in chan_times.values()),
                "select_ms": cs["ms"], "select_plain_ms": cs["plain_ms"],
                "select_bound_ms": cs["bound_ms"],
                "cu8_ms": cq["ms"], "cu8_call_ms": cq["call_ms"],
                "cu8_plain_ms": cq["plain_ms"],
                "cu8_bound_ms": cq["bound_ms"],
                "cu8_bitwise_equal_to_c64": True,
                "runtime_n": RUNTIME_N, "runtime_n_ms": cr["ms"],
                "runtime_n_plain_ms": cr["plain_ms"],
                "runtime_n_bound_ms": cr["bound_ms"],
                "wide_n": WIDE_N, "wide_n_selected": len(WIDE_N_SELECT),
                "wide_n_ms": cw["ms"], "wide_n_plain_ms": cw["plain_ms"],
                "wide_n_bound_ms": cw["bound_ms"],
                "runtime_taps": RUNTIME_TAPS, "runtime_taps_ms": ct["ms"],
                "runtime_taps_plain_ms": ct["plain_ms"],
                "runtime_taps_bound_ms": ct["bound_ms"],
                "reach_n": REACH[0], "reach_taps": REACH[1],
                "reach_selected": 3, "reach_in_flight": cn["in_flight"],
                "reach_ms": cn["ms"], "reach_plain_ms": cn["plain_ms"],
                "reach_bound_ms": cn["bound_ms"],
                "reach_rel_err": cn["rel_err"]})
    for entry in out:   # the tools' and the port bench's own runs
        entry["tools_launches"] = tool_launches.get(entry["name"], 0)
        entry["bench_launches"] = bench_launches.get(entry["name"], 0)
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
