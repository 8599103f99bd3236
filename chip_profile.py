"""Phase clocks of a hand-written kernel on one NVIDIA GPU.

    python3 chip_profile.py [--batch 70] [--snr 2.5] [--seed 5]
    python3 chip_profile.py --kernel fsk_demod [--source FILE] [--mode v1]
        [--set DEMOD_WARPS=N]
    python3 chip_profile.py --kernel fsk_demod --digest FILE[:WRAPPER] ...
    python3 chip_profile.py --kernel fsk_demod --lanes 1,8,16,64,132
        [--frames 16,64,256,4000] [--traffic slips|clean|flight|noise_lane]
        [--mode v1]
    python3 chip_profile.py --kernel deframe_topk [--source FILE]
    python3 chip_profile.py --kernel channelize [--source FILE]

bp_onehot (the default): builds wenet_tpu_torch/csrc/bp_onehot.cu a second
time with -DBP_ONEHOT_PHASES, which makes thread 0 of each of the first 64
blocks keep clock64 at the end of every phase of its first 16 iterations,
decodes one batch of random codewords at the given SNR (10 iterations at
most), checks the outputs against ops.ldpc.decode_reference, and prints for
each phase the median over iterations 1..8 of the slowest block's SM
cycles.

fsk_demod: builds the demod frame-loop kernel (csrc/fsk_demod.cu, or
--source, e.g. an earlier revision of it) a second time with
-DFSK_DEMOD_PHASES, which makes thread 0 of lane 0 keep clock64 at the end
of each phase of its first 64 frames; a source without those clocks (the
first revision, whose frame loop marks its phases "// 1." to "// 8.") gets
them inserted at its phase marks.  It demodulates one lane of a v2 (or
--mode v1) flight-geometry cu8 capture (random bits at 12 dB), checks
valid, nin and f_est against ops.fsk.demod_raw_reference, and prints the
median over frames 1..63 of each phase's SM cycles and of the whole
frame's.  A source that names its stamps ("// stamp k: name" lines: the
warp-specialised kernel, whose groups stamp their own hand-offs) gets each
stamp's median cycles after the frame's stamp 0 instead; --set NAME=VALUE
rebuilds it with a #define changed (DEMOD_WARPS: the demod warps).

fsk_demod --digest: builds each given demod source as it ships (no
clocks), runs every one on the same inputs (v2 and v1 cu8 at L=1 over a
2-s push of frames, 16 lanes, the channelizer's 8 c64 lanes, the
two-block and M=4 geometries, a push carried into a second launch, the
PROBE variant; the first ten slip 0.4 % fast and slow, nin moving every
few frames; then a 2-s push of the benchmark generator's v2 traffic after
a first push, one of it drifting 60 ppm fast then slow, and a noise push)
and prints, per case and source, the SHA-1 of the raw bytes of every
output and the kernel's CUDA-event time, and whether every source's
digests are equal.
A source given as SOURCE:WRAPPER is called through that copy of
kernels/fsk_demod.py (an earlier revision's, whose C interface it
matches); a wrapper with the frame-parallel path runs every case on both
sides of its shape rule (`[lane]`, `[frames]`; the traces take the lane
path only) and prints the path's work counters (`spec_stats`).

fsk_demod --lanes L,...: the CUDA-event time of both demod paths at those
lane counts and --frames frames a lane, their outputs compared: what the
shape rule is set from.  --traffic: random bits at 10 dB slipping 0.4 %
(slips, nin moving every few frames) or not (clean), at 15 dB (flight,
the flight traffic's level), or that with the last lane noise alone
(noise_lane: a channel with no signal, left to the lane path).

deframe_topk: builds the top-k acquisition kernel (csrc/deframe_topk.cu,
or --source, e.g. its first revision) a second time with
-DDEFRAME_TOPK_PHASES, which makes thread 0 of each block keep clock64 at
the end of each phase; the first revision (one block a stream, no clocks
of its own) gets them inserted at its phase marks and is called through
its own argument struct.  It acquires k = 11 picks on 16 streams of
22,128 symbols (the fused v2 step's shape: packet trains at 0.5 noise),
checks positions, exhausted flags and windows against
ops.deframe.topk_windows_reference, and prints the slowest block's SM
cycles of each phase: hard bits, scores, each pick round's argmax and
blanking, each window's gather and sd_to_llr (the new kernel's windows run
in parallel, one block a pick: their slowest block), beside the CUDA-event
time of a call of the phase build.

channelize: builds the channelizer kernel (csrc/channelize.cu, or
--source, e.g. its first revision) a second time with
-DCHANNELIZE_PHASES.  The persistent kernel's thread 0 sums, over its
block's tiles, the SM cycles of issuing the next tile's copies, waiting
for the current tile (the copy wait and the barrier), the FIR and the
DFT with its stores; the first revision (a block a tile of 128 frames, no
clocks of its own) gets clocks inserted after its staging loop (copy-in),
its FIR and its DFT and stores, and is called through its own argument
struct.  It channelizes 3.16 M random samples into 8 channels (the
smoke's wideband shape; the new kernel on float pairs and on cu8 bytes),
checks the output against ops.channelizer.channelize_reference (within
1e-5 of its rms), and prints the slowest block's cycles of each phase,
the median block's, and the CUDA-event time of a call of the phase build.

Each prints the card's name, power limit and SM clock.  Without a CUDA
device it fails at once.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("edge", "check", "edge_to_var", "cluster_sync_1", "var",
          "cluster_sync_2")
DEMOD_PHASES = ("window", "dft", "peak_pick", "downconvert", "integrate",
                "timing", "decisions", "ebno_state")
DEMOD_FRAMES = 64             # the frames whose clocks the kernel keeps
DEMOD_PRELUDE = r"""
#ifdef FSK_DEMOD_PHASES
__device__ long long fsk_demod_phases[64 * 16];
extern "C" int fsk_demod_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, fsk_demod_phases,
                                     sizeof(fsk_demod_phases));
}
#define PHASE(k)                                                       \
    if (threadIdx.x == 0 && blockIdx.x == 0 && f < 64)                 \
    fsk_demod_phases[f * 16 + (k)] = clock64()
#else
#define PHASE(k)
#endif
"""


TOPK_PRELUDE = r"""
#ifdef DEFRAME_TOPK_PHASES
__device__ long long deframe_topk_phases[3 * 1024 * 64];
extern "C" int deframe_topk_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, deframe_topk_phases,
                                     sizeof(deframe_topk_phases));
}
#define PHASE(kind, blk, slot)                                         \
    if (threadIdx.x == 0 && (blk) < 1024 && (slot) < 64)               \
    deframe_topk_phases[((kind) * 1024 + (blk)) * 64 + (slot)] = clock64()
#else
#define PHASE(kind, blk, slot)
#endif
"""
# the first revision's phase marks: (line, clock inserted before it or after)
TOPK_MARKS = (
    ("    // 1. hard bits, 32 to a word\n", "    PHASE(1, c, 0);\n", True),
    ("    // 2. exact correlation scores", "    PHASE(1, c, 1);\n", True),
    ("    const int reach = g.nuw + g.syms;\n", "    PHASE(1, c, 2);\n", True),
    ("        const int s = pick_s, dead = pick_dead;\n",
     "        PHASE(1, c, 3 + 4 * r);\n", True),
    ("        // 4. the window, descrambled or stripped, and its LLRs\n",
     "        PHASE(1, c, 4 + 4 * r);\n", True),
    ("        block_sum2(sabs, unused, red_f);\n",
     "        PHASE(1, c, 5 + 4 * r);\n", True),
    ("        __syncthreads();            // blanking done before the next "
     "scan\n", "        PHASE(1, c, 6 + 4 * r);\n", False),
)
TOPK_SHAPE = (16, 22128, 11)  # the fused v2 step: streams, symbols, picks


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def instrument_demod(src: str) -> str:
    """Phase clocks for a demod source that has none: PHASE(k - 1) before
    the frame loop's "// k." marks (k = 1..8) and PHASE(8) at the end of
    the loop body."""
    import re
    src = src.replace("#include <stdint.h>\n",
                      "#include <stdint.h>\n" + DEMOD_PRELUDE, 1)
    body = src.index("fsk_demod_kernel(")
    head, tail = src[:body], src[body:]
    for k in range(1, 9):
        m = re.search(rf"^( *)// {k}\. ", tail, re.M)
        if m is None:
            raise RuntimeError(f"no phase mark {k} in the demod source")
        tail = (tail[:m.start()] + f"{m.group(1)}PHASE({k - 1});\n"
                + tail[m.start():])
    end = "        __syncthreads();\n    }\n\n    // frames past"
    if end not in tail:
        raise RuntimeError("no end of the frame loop in the demod source")
    tail = tail.replace(end, "        __syncthreads();\n        PHASE(8);\n"
                        "    }\n\n    // frames past", 1)
    return head + tail


def profile_demod(args) -> int:
    import ctypes as C
    import hashlib
    import torch
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.kernels import fsk_demod
    from wenet_tpu_torch.ops import channel, fsk
    from wenet_tpu_torch.utils import compat

    path = args.source or os.path.join(kernels.CSRC, "fsk_demod.cu")
    with open(path) as fh:
        src = fh.read()
    first_revision = "FSK_DEMOD_PHASES" not in src    # no clocks of its own
    if first_revision:
        src = instrument_demod(src)
    import re
    names = {int(k): v for k, v in
             re.findall(r"^// stamp (\d+): (\w+)", src, re.M)}
    for setting in args.set or ():
        name, value = setting.split("=")
        src, n = re.subn(rf"^#define {name} \S+", f"#define {name} {value}",
                         src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"the source has no #define {name} to set")
    tag = hashlib.sha1(src.encode()).hexdigest()[:12]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernels.BUILD_DIR, f"fsk_demod_phases_{tag}.cu")
    out = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    "-DFSK_DEMOD_PHASES", "-o", out, cu], check=True,
                   capture_output=True)
    lib = C.CDLL(out)
    lib.fsk_demod_launch.restype = C.c_int
    lib.fsk_demod_launch.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p]
    lib.fsk_demod_read_phases.restype = C.c_int
    lib.fsk_demod_read_phases.argtypes = [C.c_void_p]

    dev = torch.device("cuda")
    cfg = fsk.V1_CONFIG if args.mode == "v1" else fsk.V2_CONFIG
    nf = DEMOD_FRAMES
    rng = np.random.default_rng(args.seed)
    bits = rng.integers(0, 2, cfg.Nbits * (nf + 4)).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    raw = fsk.iq_to_cu8(channel.add_awgn(sig, 12.0, cfg.Fs, cfg.Rs,
                                         rng=rng)).reshape(-1, 2)
    data = torch.from_numpy(raw).to(dev)
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    n_valid = torch.full((1,), data.shape[0], dtype=torch.int64, device=dev)
    state = fsk.lane_state(fsk.demod_init(cfg, dev), 1)
    final = [torch.empty_like(t) for t in state]
    outs = fsk.FrameOut(
        soft=torch.empty((1, nf, cfg.Nbits), device=dev),
        bits=torch.empty((1, nf, cfg.Nbits), dtype=torch.uint8, device=dev),
        valid=torch.empty((1, nf), dtype=torch.bool, device=dev),
        f_est=torch.empty((1, nf, cfg.M), device=dev),
        ebno_db=torch.empty((1, nf), device=dev),
        norm_rx_timing=torch.empty((1, nf), device=dev),
        ppm=torch.empty((1, nf), device=dev),
        nin=torch.empty((1, nf), dtype=torch.int32, device=dev))
    consts = fsk._constants(cfg, dev)
    if not first_revision:
        tables = fsk_demod._tables(cfg, dev)
        ptr_type = fsk_demod.Ptrs
    else:                 # the first revision: the full DFT matrix
        tables = (consts["hann"], compat._dft_matrix(cfg.Ndft, cfg.Ndft // 2,
                                                     dev),
                  consts["spin_re"], consts["spin_im"])
        names = ("data", "starts", "n_valid", "hann", "dft", "spin_re",
                 "spin_im", *fsk_demod._STATE_IN, *fsk_demod._STATE_OUT,
                 *fsk_demod._FRAME_OUT)
        ptr_type = type("Ptrs1", (C.Structure,),
                        {"_fields_": [(f, C.c_void_p) for f in names]})
    ptrs = ptr_type(*(t.data_ptr() for t in (
        data, starts, n_valid, *tables, *state, *final, *outs)))
    geom = fsk_demod.geometry(cfg, "cu8", 1, nf, data.shape[0])
    for _ in range(3):                    # the last run's clocks are kept
        rc = lib.fsk_demod_launch(C.addressof(geom), C.addressof(ptrs),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
    torch.cuda.synchronize()
    _, want = fsk.demod_raw_reference(cfg, data, "cu8", nf, starts, n_valid)
    v = want.valid
    if not (torch.equal(outs.valid, v) and torch.equal(outs.nin[v], want.nin[v])
            and torch.equal(outs.f_est[v], want.f_est[v])):
        raise RuntimeError("the phase build differs from the plain loop")
    clocks = np.zeros(64 * 16, np.int64)
    rc = lib.fsk_demod_read_phases(clocks.ctypes.data_as(C.c_void_p))
    if rc:
        raise RuntimeError(f"reading the phase clocks: cudaError_t {rc}")
    frames = min(nf, 64)
    stamps = clocks.reshape(64, 16)[:frames]
    # frames 1..62: the estimator's stamps of frame f time its work on
    # frame f+1, which the last frame has none of
    kept = [k for k in range(16) if stamps[1:-1, k].all()]
    rec = {"kernel": "fsk_demod", "source": os.path.relpath(path, ROOT),
           "geometry": args.mode, "lanes": 1, "frames": frames}
    if args.set:
        rec["set"] = args.set
    if not names:
        span = np.diff(stamps[:, :9], axis=1)[1:]        # frames 1.., 8
        rec["sm_cycles"] = {p: float(np.median(span[:, k]))
                            for k, p in enumerate(DEMOD_PHASES)}
    rec["frame_sm_cycles"] = float(np.median(np.diff(stamps[:, 0])[1:]))
    # every stamp the source keeps, as cycles after the frame's stamp 0
    rec["stamps"] = {names.get(k, k): float(np.median(stamps[1:-1, k]
                                                      - stamps[1:-1, 0]))
                     for k in kept}
    rec["card"] = smi_line()
    print(json.dumps(rec))
    return 0


def _demod_capture(cfg, n, seed, fmt, kind="slips"):
    """(n, 2) raw pairs.  slips: random bits at 10 dB, resampled 0.4 %
    fast in the first half and 0.4 % slow in the second, so nin takes all
    three values every few frames; ppm60: random bits at 10 dB, 60 ppm
    fast in the first half and 60 ppm slow in the second (a slip every
    couple of hundred frames); clean: the bits at 10 dB alone; noise:
    complex noise alone (nin random); flight: the bits at 15 dB alone."""
    from wenet_tpu_torch.ops import channel, fsk
    rng = np.random.default_rng(seed)
    if kind == "noise":
        iq = (rng.normal(0, 0.3, n) + 1j * rng.normal(0, 0.3, n)).astype(
            np.complex64)
    else:
        bits = rng.integers(0, 2, (n // cfg.N + 4) * cfg.Nbits).astype(
            np.uint8)
        sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
        h = len(sig) // 2
        r = {"slips": 0.004, "ppm60": 60e-6, "clean": 0.0,
             "flight": 0.0}[kind]
        sig = np.concatenate([channel.resample_linear(sig[:h], 1 + r),
                              channel.resample_linear(sig[h:], 1 - r)])[:n]
        db = 15.0 if kind == "flight" else 10.0
        iq = channel.add_awgn(sig, db, cfg.Fs, cfg.Rs, rng=rng) * 0.4
    if fmt == "cu8":
        return fsk.iq_to_cu8(iq).reshape(-1, 2)
    if fmt == "cs16":
        return np.stack([np.round(iq.real * 820), np.round(iq.imag * 820)],
                        axis=1).astype(np.int16)
    return np.ascontiguousarray(iq.astype(np.complex64).view(np.float32)
                                .reshape(-1, 2))


def _generator_push(cfg, seconds, seed):
    """(n, 2) cu8 pairs of the benchmark generator's v2 traffic (15 dB,
    back-to-back frames)."""
    import torch
    from benchmark import traffic
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "v2_flight.json")) as fh:
        dep = traffic.Deployment.from_file(json.load(fh))
    rec = traffic.make_recording(dep, seconds, 15.0, seed, 0, 0, 0,
                                 torch.device("cuda"))
    return rec.raw.reshape(-1, 2)


def _wrapper_module(path):
    """The demod wrapper: the package's, or a saved copy of another
    revision's, loaded as a module of the package so that its relative
    imports resolve."""
    import hashlib
    import importlib.util
    from wenet_tpu_torch.kernels import fsk_demod
    if path is None:
        return fsk_demod
    with open(path, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    name = f"wenet_tpu_torch.kernels._fsk_demod_{tag}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def digest_demod(args) -> int:
    """Every output of each demod source on the same inputs, as SHA-1
    digests, and the kernel's time on each.  A source given as
    SOURCE:WRAPPER runs through that copy of the wrapper (an earlier
    revision's); a wrapper with two paths runs every case on both sides
    of its shape rule (`lane`: the lane path alone, `frames`: the
    frame-parallel path first), with its work counters."""
    import ctypes as C
    import hashlib
    import torch
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.ops import fsk

    dev = torch.device("cuda")
    two_blocks = fsk.FSKConfig(Fs=48000, Rs=9600, Nsym=51)
    m4 = fsk.FSKConfig(Fs=96000, Rs=9600, M=4)
    # name: cfg, fmt, lanes, frames a lane, eye, probe, pushes, input
    cases = {
        "v2_cu8_L1": (fsk.V2_CONFIG, "cu8", 1, 4000, True, False, 1, "slips"),
        "v1_cu8_L1": (fsk.V1_CONFIG, "cu8", 1, 4800, True, False, 1, "slips"),
        "v2_cu8_L16": (fsk.V2_CONFIG, "cu8", 16, 120, True, False, 1,
                       "slips"),
        "v1_cs16_L16": (fsk.V1_CONFIG, "cs16", 16, 120, False, False, 1,
                        "slips"),
        "v2_c64_8lanes": (fsk.V2_CONFIG, "c64", 8, 822, True, False, 1,
                          "slips"),
        "two_blocks_c64": (two_blocks, "c64", 1, 600, True, False, 1,
                           "slips"),
        "m4_cu8_L3": (m4, "cu8", 3, 300, True, False, 1, "slips"),
        "v2_cu8_carried": (fsk.V2_CONFIG, "cu8", 1, 2000, True, False, 2,
                           "slips"),
        "v2_c64_probe": (fsk.V2_CONFIG, "c64", 1, 600, True, True, 1,
                         "slips"),
        "two_blocks_probe": (two_blocks, "c64", 2, 300, False, True, 1,
                             "slips"),
        # a 2-s push of the generator's traffic after a first one (the
        # second keeps nin = N throughout), a push drifting 60 ppm, noise
        "v2_generator_push": (fsk.V2_CONFIG, "cu8", 1, 8000, True, False, 2,
                              "generator"),
        "v2_ppm60_push": (fsk.V2_CONFIG, "cu8", 1, 4000, True, False, 1,
                          "generator_ppm60"),
        "v2_noise_push": (fsk.V2_CONFIG, "cu8", 1, 4000, True, False, 1,
                          "noise"),
    }
    inputs = {}
    for i, (name, (cfg, fmt, L, nf, _, _, pushes, kind)) in enumerate(
            cases.items()):
        span = nf * cfg.N                      # a lane's samples
        n = span // 2 * (L + 1) if L > 1 else span + 3 * cfg.N
        if kind.startswith("generator"):
            raw = _generator_push(cfg, n / cfg.Fs + 0.1, 100 + i)[:n]
            if kind == "generator_ppm60":       # an SDR 60 ppm fast, then slow
                from wenet_tpu_torch.ops import channel
                iq = fsk.iq_from_cu8(raw.reshape(-1))
                h = len(iq) // 2
                raw = fsk.iq_to_cu8(np.concatenate([
                    channel.resample_linear(iq[:h], 1 + 60e-6),
                    channel.resample_linear(iq[h:], 1 - 60e-6)])).reshape(
                        -1, 2)
        else:
            raw = _demod_capture(cfg, n, 100 + i, fmt, kind)
        data = torch.from_numpy(np.ascontiguousarray(raw)).to(dev)
        starts = torch.arange(L, dtype=torch.int64, device=dev) * (span // 2)
        if L > 1:
            starts[0] -= 3 * cfg.N + 5         # before sample 0
        n_valid = (span - 7 * torch.arange(L, dtype=torch.int64,
                                           device=dev))
        if L > 1:
            n_valid[-1] += cfg.N               # past the buffer's end
        inputs[name] = (data, starts, n_valid)

    def run(demod, name):
        cfg, fmt, L, nf, eye, probe, pushes, _ = cases[name]
        data, starts, n_valid = inputs[name]
        if pushes == 1:
            return [demod(cfg, data, fmt, nf + 3, starts, n_valid,
                          with_eye=eye, with_probe=probe)]
        # a push and the next one, the state carried; as Receiver splits
        out = demod(cfg, data, fmt, nf // 2, starts,
                    torch.full_like(n_valid, nf // 2 * cfg.N),
                    with_eye=eye)
        return [out, demod(cfg, data, fmt, nf // 2 + 3, starts, n_valid,
                           out[0], with_eye=eye)]

    def digests(res):
        out = {}
        for k, r in enumerate(res):
            for part in r:
                for field, t in zip(part._fields, part):
                    b = t.contiguous().cpu().numpy().tobytes()
                    out[f"{k}.{type(part).__name__}.{field}"] = \
                        hashlib.sha1(b).hexdigest()[:16]
        return out

    per_run = {}
    for entry in args.digest:
        path, _, wrapper = entry.partition(":")
        with open(path) as fh:
            src = fh.read()
        tag = hashlib.sha1(src.encode()).hexdigest()[:12]
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        cu = os.path.join(kernels.BUILD_DIR, f"fsk_demod_digest_{tag}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = cu[:-3] + ".so"
        built = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                                "-o", so, cu], capture_output=True, text=True)
        ptxas = [ln for ln in (built.stdout + built.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        if built.returncode:
            raise RuntimeError(f"nvcc failed on {path}:\n"
                               + built.stdout + built.stderr)
        lib = C.CDLL(so)
        mod = _wrapper_module(wrapper or None)
        if hasattr(mod, "bind"):
            mod.bind(lib)
        else:
            lib.fsk_demod_launch.restype = C.c_int
            lib.fsk_demod_launch.argtypes = [C.POINTER(mod.Geom),
                                             C.POINTER(mod.Ptrs), C.c_void_p]
        mod._lib = lambda lib=lib: lib
        sides = ({"lane": False, "frames": True} if hasattr(mod, "_demod")
                 else {"": None})
        for side, spec in sides.items():
            rec = {}
            for name in cases:
                if cases[name][5] and spec:
                    continue                  # the traces: the lane path
                if spec is None:
                    demod = mod.demod
                else:
                    def demod(*a, spec=spec, **k):
                        return mod._demod(*a, spec=spec, **k)
                before = (mod.spec_stats() if hasattr(mod, "spec_stats")
                          else None)
                res = run(demod, name)
                torch.cuda.synchronize()
                stats = None
                if before is not None:
                    after = mod.spec_stats()
                    stats = {k: after[k] - before[k] for k in after}
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                times = []
                for _ in range(5):
                    ev[0].record()
                    run(demod, name)
                    ev[1].record()
                    torch.cuda.synchronize()
                    times.append(ev[0].elapsed_time(ev[1]))
                nins = torch.cat([r[1].nin[r[1].valid] for r in res])
                rec[name] = {"ms": float(np.median(times)),
                             "valid_frames": int(nins.numel()),
                             "nin_values": sorted(set(nins.tolist())),
                             "spec_stats": stats,
                             "digests": digests(res)}
            label = os.path.relpath(path, ROOT) + (f"[{side}]" if side
                                                   else "")
            per_run[label] = rec
            print(json.dumps({"source": label, "ptxas": ptxas,
                              **{n: {k: v for k, v in r.items()
                                     if k != "digests"}
                                 for n, r in rec.items()},
                              "card": smi_line()}))
    first = {}
    for rec in per_run.values():
        for n, r in rec.items():
            first.setdefault(n, r["digests"])
    differ = {s: [f"{n}:{k}" for n, r in rec.items()
                  for k, v in r["digests"].items()
                  if first[n].get(k) != v]
              for s, rec in per_run.items()}
    print(json.dumps({"digests": first, "equal": not any(differ.values()),
                      "differ": differ}))
    return 0 if not any(differ.values()) else 1


def scale_demod(args) -> int:
    """The CUDA-event time of the demod on each path (the lane path alone,
    the frame-parallel path first) at L lanes of F frames, the lanes'
    starts 977 samples apart in one cu8 capture of --traffic: what the
    shape rule is set from."""
    import torch
    from wenet_tpu_torch.kernels import fsk_demod
    from wenet_tpu_torch.ops import fsk
    dev = torch.device("cuda")
    cfg = fsk.V1_CONFIG if args.mode == "v1" else fsk.V2_CONFIG
    kind = {"noise_lane": "flight"}.get(args.traffic, args.traffic)
    rows = []
    for nf in (int(v) for v in args.frames.split(",")):
        span = nf * cfg.N
        raw = _demod_capture(cfg, span * 2, 7, "cu8", kind)
        if args.traffic == "noise_lane":
            raw = np.concatenate([raw, _demod_capture(cfg, span, 8, "cu8",
                                                      "noise")])
        data = torch.from_numpy(raw).to(dev)
        for L in (int(v) for v in args.lanes.split(",")):
            starts = (torch.arange(L, dtype=torch.int64, device=dev) * 977
                      % max(span, 1))
            if args.traffic == "noise_lane":
                starts[-1] = 2 * span
            n_valid = torch.full((L,), span, dtype=torch.int64, device=dev)
            row = {"lanes": L, "frames": nf,
                   "rule": fsk_demod.frame_parallel(cfg, "cu8", L, nf + 3,
                                                    dev) > 0}
            outs = {}
            for side, spec in (("lane", False), ("frames", True)):
                if spec and not fsk_demod._spec_fits(cfg, "cu8", L, dev):
                    continue
                before = fsk_demod.spec_stats()
                outs[side] = fsk_demod._demod(cfg, data, "cu8", nf + 3,
                                              starts, n_valid, spec=spec)
                torch.cuda.synchronize()
                after = fsk_demod.spec_stats()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                times = []
                for _ in range(5):
                    ev[0].record()
                    fsk_demod._demod(cfg, data, "cu8", nf + 3, starts,
                                     n_valid, spec=spec)
                    ev[1].record()
                    torch.cuda.synchronize()
                    times.append(ev[0].elapsed_time(ev[1]))
                row[f"{side}_ms"] = float(np.median(times))
                if spec:
                    row["spec_stats"] = {k: after[k] - before[k]
                                         for k in after}
            if len(outs) == 2:
                row["equal"] = all(
                    torch.equal(a, b) for pa, pb in zip(outs["lane"],
                                                        outs["frames"])
                    for a, b in zip(pa, pb))
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"mode": args.mode, "traffic": args.traffic,
                      "card": smi_line(),
                      "equal": all(r.get("equal", True) for r in rows)}))
    return 0 if all(r.get("equal", True) for r in rows) else 1


def instrument_topk(src: str) -> str:
    """Phase clocks for the first revision of the acquisition kernel (one
    block a stream): TOPK_PRELUDE after its defines, and a clock at each
    of TOPK_MARKS (kernel 1, block = the stream)."""
    src = src.replace("#define FULL 0xFFFFFFFFu\n",
                      "#define FULL 0xFFFFFFFFu\n" + TOPK_PRELUDE, 1)
    for line, clock, before in TOPK_MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"no single mark {line.strip()!r} in the "
                               "acquisition source")
        src = src.replace(line, clock + line if before else line + clock)
    return src


def topk_soft(rng, C, n):
    """(C, n) float32 soft bits: v2 packet trains (random payloads, random
    gaps) at noise 0.5."""
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import ldpc
    rows = []
    for _ in range(C):
        bits = [rng.integers(0, 2, int(rng.integers(100, 2000)))]
        while sum(map(len, bits)) < n:
            p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
            bits.append(framing.frame_to_bits(framing.frame_packet(
                p, ldpc.encode_bytes, mode="v2"), "v2"))
            bits.append(rng.integers(0, 2, int(rng.integers(50, 600))))
        b = np.concatenate(bits)[:n].astype(np.float32)
        rows.append(1.0 - 2.0 * b + rng.normal(0, 0.5, n))
    return np.stack(rows).astype(np.float32)


def profile_topk(args) -> int:
    import ctypes as C
    import hashlib
    import torch
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import deframe

    path = args.source or os.path.join(kernels.CSRC, "deframe_topk.cu")
    with open(path) as fh:
        src = fh.read()
    first_revision = "DEFRAME_TOPK_PHASES" not in src
    if first_revision:
        src = instrument_topk(src)
    tag = hashlib.sha1(src.encode()).hexdigest()[:12]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernels.BUILD_DIR, f"deframe_topk_phases_{tag}.cu")
    out = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    "-DDEFRAME_TOPK_PHASES", "-o", out, cu], check=True,
                   capture_output=True)
    lib = C.CDLL(out)
    lib.deframe_topk_launch.restype = C.c_int
    lib.deframe_topk_launch.argtypes = [C.c_void_p, C.c_void_p]
    lib.deframe_topk_read_phases.restype = C.c_int
    lib.deframe_topk_read_phases.argtypes = [C.c_void_p]

    dev = torch.device("cuda")
    nC, n, k = TOPK_SHAPE
    soft = torch.from_numpy(topk_soft(np.random.default_rng(args.seed), nC,
                                      n)).to(dev)
    uw, nuw, syms = ktopk.mode_params("v2")
    llr = torch.empty((nC * k, 2580), device=dev)
    sd = torch.empty_like(llr)
    pos = torch.empty((nC, k), dtype=torch.int32, device=dev)
    exh = torch.empty((nC, k), dtype=torch.bool, device=dev)
    code = ktopk._code(dev)
    nlive = max(n - syms - nuw + 1, 0)
    if first_revision:           # its TopkArgs: words and scores on chip
        fields = ([(f, C.c_void_p) for f in (
            "soft", "code", "llr", "sd_out", "pos", "exhausted", "g_words",
            "g_scores")] + [("n", C.c_longlong), ("uw", C.c_ulonglong)]
            + [(f, C.c_int) for f in ("C", "k", "nuw", "syms", "v2", "nlive",
                                      "nwords")])
        argt = type("Args1", (C.Structure,), {"_fields_": fields})
        a = argt(soft.data_ptr(), code.data_ptr(), llr.data_ptr(),
                 sd.data_ptr(), pos.data_ptr(), exh.data_ptr(), None, None,
                 n, uw, nC, k, nuw, syms, 1, nlive, -(-n // 32) + 2)
        keep = None
    else:
        lib.deframe_topk_init.restype = C.c_int
        if lib.deframe_topk_init():
            raise RuntimeError("deframe_topk_init failed")
        _, ntiles, scratch_bytes, _ = ktopk.geometry(n, "v2", nC)
        keep = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
        a = ktopk.Args(soft.data_ptr(), code.data_ptr(), llr.data_ptr(),
                       sd.data_ptr(), pos.data_ptr(), exh.data_ptr(),
                       keep.data_ptr(), scratch_bytes, n, uw, nC, k, nuw,
                       syms, 1, nlive, ntiles)

    def launch():
        rc = lib.deframe_topk_launch(C.addressof(a),
                                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    clocks = np.zeros(3 * 1024 * 64, np.int64)
    rc = lib.deframe_topk_read_phases(clocks.ctypes.data_as(C.c_void_p))
    if rc:
        raise RuntimeError(f"reading the phase clocks: cudaError_t {rc}")
    sd_w, pos_w, exh_w = deframe.topk_windows_reference(soft, "v2", k)
    if not (torch.equal(pos, pos_w) and torch.equal(exh, exh_w)
            and torch.equal(sd, sd_w)):
        raise RuntimeError("the phase build differs from the plain version")
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(20):
        launch()
    t1.record()
    t1.synchronize()
    st = clocks.reshape(3, 1024, 64)

    def slowest(kind, blocks, hi, lo):
        d = st[kind, :blocks, hi] - st[kind, :blocks, lo]
        ok = (st[kind, :blocks, hi] != 0) & (st[kind, :blocks, lo] != 0)
        return float(d[ok].max()) if ok.any() else None

    rounds = []
    if first_revision:
        for r in range(k):
            prev = 2 if r == 0 else 6 + 4 * (r - 1)
            rounds.append({"argmax": slowest(1, nC, 3 + 4 * r, prev),
                           "blank": slowest(1, nC, 4 + 4 * r, 3 + 4 * r),
                           "gather": slowest(1, nC, 5 + 4 * r, 4 + 4 * r),
                           "sd_to_llr": slowest(1, nC, 6 + 4 * r,
                                                5 + 4 * r)})
        phases = {"hard_bits": slowest(1, nC, 1, 0),
                  "scores": slowest(1, nC, 2, 1),
                  "block_total": slowest(1, nC, 2 + 4 * k, 0)}
    else:
        blocks = min(-(-nlive // 1024) * nC, 1024)
        for r in range(k):
            prev = 1 if r == 0 else 3 + 2 * (r - 1)
            rounds.append({"argmax": slowest(1, nC, 2 + 2 * r, prev),
                           "blank": slowest(1, nC, 3 + 2 * r, 2 + 2 * r)})
        rows = min(nC * k, 1024)
        phases = {"hard_bits": slowest(0, blocks, 1, 0),
                  "scores": slowest(0, blocks, 2, 1),
                  "tile_copy": slowest(1, nC, 1, 0),
                  "window_gather": slowest(2, rows, 1, 0),
                  "window_sd_to_llr": slowest(2, rows, 2, 1)}
    print(json.dumps({
        "kernel": "deframe_topk", "source": os.path.relpath(path, ROOT),
        "first_revision": first_revision, "streams": nC, "symbols": n,
        "picks": k, "exhausted": int(exh_w.sum()),
        "call_ms_phase_build": t0.elapsed_time(t1) / 20,
        "sm_cycles": phases, "rounds_sm_cycles": rounds,
        "card": smi_line()}))
    del keep
    return 0


CHAN_SHAPE = (8, 3_160_000)   # the smoke's wideband call: N, samples
CHAN_PRELUDE = r"""
#ifdef CHANNELIZE_PHASES
__device__ long long channelize_phases[4096 * 4];
extern "C" int channelize_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, channelize_phases,
                                     sizeof(channelize_phases));
}
#endif
"""
# the first revision's phase marks: (line, clock inserted after it)
CHAN_MARKS = (
    ("    const long long m0 = (long long)blockIdx.x * tile;\n",
     "    const long long t0_ = clock64();\n"),
    ("hps[i] = g.hp[i];\n    __syncthreads();\n",
     "    const long long t1_ = clock64();\n"),
    ("        ys[p * row + ml] = make_float2(re, im);\n    }\n"
     "    __syncthreads();\n", "    const long long t2_ = clock64();\n"),
    ("        g.out[(long long)ci * g.F + m0 + ml] = make_float2(re, im);\n"
     "    }\n",
     "    __syncthreads();\n"
     "    if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
     "        long long* o_ = channelize_phases + blockIdx.x * 4;\n"
     "        o_[0] = t1_ - t0_;\n"
     "        o_[1] = t2_ - t1_;\n"
     "        o_[2] = clock64() - t2_;\n"
     "    }\n"),
)


def instrument_channelize(src: str) -> str:
    """Phase clocks for the first revision of the channelizer (a block a
    tile): CHAN_PRELUDE after its THREADS define, and thread 0's clocks
    after its staging loop, its FIR and its DFT (CHAN_MARKS)."""
    src = src.replace("#define THREADS 256\n",
                      "#define THREADS 256\n" + CHAN_PRELUDE, 1)
    for line, clock in CHAN_MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"no single mark {line.strip()!r} in the "
                               "channelizer source")
        src = src.replace(line, line + clock)
    return src


def profile_channelize(args) -> int:
    import ctypes as C
    import hashlib
    import torch
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer, fsk

    path = args.source or os.path.join(kernels.CSRC, "channelize.cu")
    with open(path) as fh:
        src = fh.read()
    first_revision = "CHANNELIZE_PHASES" not in src
    if first_revision:
        src = instrument_channelize(src)
    tag = hashlib.sha1(src.encode()).hexdigest()[:12]
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(kernels.BUILD_DIR, f"channelize_phases_{tag}.cu")
    out_so = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    "-DCHANNELIZE_PHASES", "-o", out_so, cu], check=True,
                   capture_output=True)
    lib = C.CDLL(out_so)
    lib.channelize_launch.restype = C.c_int
    lib.channelize_launch.argtypes = [C.c_void_p, C.c_void_p]
    lib.channelize_read_phases.restype = C.c_int
    lib.channelize_read_phases.argtypes = [C.c_void_p]

    dev = torch.device("cuda")
    N, n = CHAN_SHAPE
    F = n // N
    raw = np.random.default_rng(args.seed).integers(0, 256, 2 * n,
                                                    dtype=np.uint8)
    raw_t = torch.from_numpy(raw).to(dev)
    pairs = torch.from_numpy(fsk.iq_from_cu8(raw).view(np.float32)
                             .reshape(-1, 2)).to(dev)
    sel = tuple(range(N))
    out = torch.empty((N * F, 2), device=dev)
    want = torch.view_as_real(channelizer.channelize_reference(
        torch.view_as_complex(pairs), N)).reshape(-1, 2)
    rms = float(want.square().mean().sqrt())
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    if first_revision:         # its ChanArgs: a block a tile of 128 frames
        fields = ([(f, C.c_void_p) for f in ("x", "hp", "tw", "out")]
                  + [("F", C.c_longlong)]
                  + [(f, C.c_int) for f in ("N", "T", "nsel", "tile")])
        argt = type("Args1", (C.Structure,), {"_fields_": fields})
        ang = (-2.0 * np.pi / N) * np.outer((-np.arange(N)) % N,
                                            np.arange(N))
        tw = torch.from_numpy(np.stack([np.cos(ang).astype(np.float32),
                                        np.sin(ang).astype(np.float32)],
                                       -1)).to(dev)   # a row a channel
        hp = kch._tables(N, 12, sel, dev)[0]
        cases = {"c64": argt(pairs.data_ptr(), hp.data_ptr(), tw.data_ptr(),
                             out.data_ptr(), F, N, 12, N, 128)}
        blocks = -(-F // 128)
    else:
        lib.channelize_init.restype = C.c_int
        if lib.channelize_init():
            raise RuntimeError("channelize_init failed")
        cases = {fmt: kch.launch_args(x, out, N, 12, sel, fmt)
                 for fmt, x in (("c64", pairs), ("cu8", raw_t))}
        blocks, per = cases["c64"].blocks, cases["c64"].tiles_per_block
    for fmt, a in cases.items():
        def launch():
            rc = lib.channelize_launch(C.addressof(a), stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        clocks = np.zeros(4096 * 4 if first_revision else 1024 * 10,
                          np.int64)
        rc = lib.channelize_read_phases(clocks.ctypes.data_as(C.c_void_p))
        if rc:
            raise RuntimeError(f"reading the phase clocks: cudaError_t {rc}")
        err = float((out - want).abs().max())
        if not err <= 1e-5 * rms:
            raise RuntimeError(f"the phase build differs from the plain "
                               f"version: {err} of rms {rms}")
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(20):
            launch()
        t1.record()
        t1.synchronize()
        if first_revision:
            names = ("copy_in", "fir", "dft_store")
            st = clocks.reshape(4096, 4)[:min(blocks, 4096), :3]
        else:
            names = ("copy", "wait", "fir", "dft_store")
            st = clocks.reshape(1024, 10)[:min(blocks, 1024)]
        span = st[:, 5] if not first_revision else st.sum(axis=1)
        slow, med = int(span.argmax()), int(np.argsort(span)[len(span) // 2])
        runs[fmt] = {
            "blocks": blocks,
            "tiles_per_block": None if first_revision else per,
            "slowest_block_sm_cycles": {k: int(st[slow, i])
                                        for i, k in enumerate(names)},
            "slowest_block_span": int(span[slow]),
            "median_block_sm_cycles": {k: int(st[med, i])
                                       for i, k in enumerate(names)},
            "median_block_span": int(span[med]),
            "call_ms_phase_build": t0.elapsed_time(t1) / 20,
            "rel_err": err / rms}
        if not first_revision:      # the last run's blocks on one clock
            runs[fmt].update({
                "max_prologue_sm_cycles": int(st[:, 6].max()),
                "kernel_span_us": float(st[:, 8].max() - st[:, 7].min())
                / 1e3,
                "block_start_skew_us": float(st[:, 7].max() - st[:, 7].min())
                / 1e3,
                "longest_block_us": float((st[:, 8] - st[:, 7]).max()) / 1e3})
    print(json.dumps({
        "kernel": "channelize", "source": os.path.relpath(path, ROOT),
        "first_revision": first_revision, "n_channels": N, "samples": n,
        "runs": runs, "card": smi_line()}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=["bp_onehot", "fsk_demod",
                                         "deframe_topk", "channelize"],
                    default="bp_onehot")
    ap.add_argument("--batch", type=int, default=70)
    ap.add_argument("--snr", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--mode", choices=["v2", "v1"], default="v2",
                    help="fsk_demod: the flight geometry to profile")
    ap.add_argument("--set", action="append", metavar="NAME=VALUE",
                    help="fsk_demod: rebuild with this #define changed "
                    "(e.g. DEMOD_WARPS=6, the demod warps)")
    ap.add_argument("--digest", nargs="+", default=None,
                    help="fsk_demod: compare these sources' outputs "
                    "(SOURCE:WRAPPER: through that copy of the wrapper)")
    ap.add_argument("--lanes", default=None,
                    help="fsk_demod: time both demod paths at these lane "
                    "counts (e.g. 1,8,16,64,132)")
    ap.add_argument("--frames", default="16,64,256,4000",
                    help="fsk_demod --lanes: frames a lane")
    ap.add_argument("--traffic", default="slips",
                    choices=["slips", "clean", "flight", "noise_lane"],
                    help="fsk_demod --lanes: the lanes' capture")
    ap.add_argument("--source", default=None,
                    help="fsk_demod, deframe_topk, channelize: the "
                    "kernel source to profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    if args.kernel == "fsk_demod":
        if args.lanes:
            return scale_demod(args)
        return digest_demod(args) if args.digest else profile_demod(args)
    if args.kernel == "deframe_topk":
        return profile_topk(args)
    if args.kernel == "channelize":
        return profile_channelize(args)
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.kernels import bp_onehot
    from wenet_tpu_torch.ops import ldpc, ldpc_onehot

    src = os.path.join(kernels.CSRC, "bp_onehot.cu")
    out = os.path.join(kernels.BUILD_DIR, "libbp_onehot_phases.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    "-DBP_ONEHOT_PHASES", "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bp_onehot_launch.restype = I
    lib.bp_onehot_launch.argtypes = [P, P, I, P, P, P, I, I, I, P]
    lib.bp_onehot_read_phases.restype = I
    lib.bp_onehot_read_phases.argtypes = [P]

    dev = torch.device("cuda")
    B = args.batch
    rng = np.random.default_rng(args.seed)
    ib = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8), axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (args.snr / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    llr = ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32, device=dev))
    tab = ldpc_onehot.kernel_tables(dev)
    region = tab.shape[1]
    shape = bp_onehot.launch_shape(B, bp_onehot.card_clusters(dev, region),
                                   region)
    got = (torch.empty((B, 2580), dtype=torch.uint8, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.bool, device=dev))
    for _ in range(3):                      # the last run's clocks are kept
        rc = lib.bp_onehot_launch(
            llr.data_ptr(), tab.data_ptr(), region, *(t.data_ptr() for t in got),
            B, 10, shape.blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
    torch.cuda.synchronize()
    for a, b in zip(got, ldpc.decode_reference(llr)):
        if not torch.equal(a, b):
            raise RuntimeError("the phase build differs from decode_reference")
    clocks = np.zeros(64 * 16 * 8, np.int64)
    rc = lib.bp_onehot_read_phases(clocks.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"reading the phase clocks: cudaError_t {rc}")
    clocks = clocks.reshape(64, 16, 8)[:min(shape.blocks, 64)]
    iters = int(got[1].max())
    if iters < 10:
        raise RuntimeError(f"only {iters} iterations: lower --snr")
    span = np.diff(clocks[:, 1:9, :7], axis=2)           # blocks, iters, 6
    smi = smi_line()
    print(json.dumps({
        "batch": B, "snr_db": args.snr, "blocks": shape.blocks,
        "sm_cycles": {p: float(np.median(span[:, :, k].max(axis=0)))
                      for k, p in enumerate(PHASES)},
        "iteration_sm_cycles": float(np.median(
            clocks[0, 2:9, 0] - clocks[0, 1:8, 0])),
        "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
