"""Phase clocks of a hand-written kernel on one NVIDIA GPU.

    python3 chip_profile.py [--batch 70] [--snr 2.5] [--seed 5]
    python3 chip_profile.py --kernel fsk_demod [--source FILE]
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
them inserted at its phase marks.  It demodulates one lane of a v2
flight-geometry cu8 capture (random bits at 12 dB), checks valid, nin and
f_est against ops.fsk.demod_raw_reference, and prints the median over
frames 1..63 of each phase's SM cycles and of the whole frame's.

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
    cfg = fsk.V2_CONFIG
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
    span = np.diff(stamps[:, :9], axis=1)[1:]            # frames 1.., 8
    kept = [k for k in range(16) if stamps[1:, k].all()]
    print(json.dumps({
        "kernel": "fsk_demod", "source": os.path.relpath(path, ROOT),
        "geometry": "v2", "lanes": 1, "frames": frames,
        "sm_cycles": {p: float(np.median(span[:, k]))
                      for k, p in enumerate(DEMOD_PHASES)},
        "frame_sm_cycles": float(np.median(np.diff(stamps[:, 0])[1:])),
        # every stamp the source keeps, as cycles after the frame's start
        "stamps": {k: float(np.median(stamps[1:, k] - stamps[1:, 0]))
                   for k in kept},
        "card": smi_line()}))
    return 0


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
    ap.add_argument("--source", default=None,
                    help="fsk_demod, deframe_topk, channelize: the "
                    "kernel source to profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    if args.kernel == "fsk_demod":
        return profile_demod(args)
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
