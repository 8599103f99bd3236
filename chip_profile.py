"""Phase clocks of the one-hot BP kernel on one NVIDIA GPU.

    python3 chip_profile.py [--batch 70] [--snr 2.5] [--seed 5]

Builds wenet_tpu_torch/csrc/bp_onehot.cu a second time with
-DBP_ONEHOT_PHASES, which makes thread 0 of each of the first 64 blocks
keep clock64 at the end of every phase of its first 16 iterations, decodes
one batch of random codewords at the given SNR (10 iterations at most),
checks the outputs against ops.ldpc.decode_reference, and prints for each
phase the median over iterations 1..8 of the slowest block's SM cycles,
with the card's name, power limit and SM clock.  Without a CUDA device it
fails at once.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=70)
    ap.add_argument("--snr", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
