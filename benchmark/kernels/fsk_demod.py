"""The demod frame loop's work (`csrc/fsk_demod.cu`, launched by
`ops.fsk.demod_raw` on a CUDA tensor).

NAMES lists the device kernels whose time is this kernel's: a later
implementation of the demod adds its kernel's name here, and its
roofline then reads the same work.  The work is counted from the call's
shapes and the frames its data made valid (a frozen copy of the smoke
run's `demod_bound`): per estimator block used, the Hann window (2 a
sample), the DFT (8 a sample and bin), the magnitude and EMA (6 a bin); M
peak picks over the bins; per tone and window sample the angle (6), cos
and sin (1 each) and the mix (6); the window sums (2 a sample and
integrator); the timing line (3 a tone and integrator, 4 an integrator);
the decisions (8 a tone and symbol).  Bytes: the call's raw samples read
once, every frame's outputs and the states (and the eye probe) written
once.
"""
from __future__ import annotations

OP = "wenet_tpu_torch.ops.fsk:demod_raw"
NAMES = ("fsk_demod_kernel",)
SAMPLE_BYTES = {"cu8": 2, "cs16": 4, "c64": 8}


def _geometry(cfg) -> dict:
    return {k: int(getattr(cfg, k)) for k in
            ("N", "Ts", "P", "M", "Nsym", "Nmem", "Ndft", "Nbits")}


def record(args, kwargs, result) -> dict:
    """What one call's work needs, taken without waiting for the device:
    the shapes, and a histogram on the device of its valid frames by nin."""
    import torch
    names = ("cfg", "data", "fmt", "num_frames", "starts", "n_valid",
             "state", "with_eye", "with_probe")
    call = dict(zip(names, args), **kwargs)
    cfg, outs = call["cfg"], result[1]
    g = _geometry(cfg)
    lo, K = g["N"] - g["Ts"] // 2, g["Ts"] + 1
    idx = torch.where(outs.valid, (outs.nin.long() - lo).clamp(0, K - 1),
                      K).reshape(-1)
    hist = torch.zeros(K + 1, dtype=torch.int64, device=idx.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    return {"geometry": g, "lanes": int(call["starts"].shape[0]),
            "frames": int(call["num_frames"]),
            "samples": int(call["data"].shape[0]), "fmt": call["fmt"],
            "eye": bool(call.get("with_eye", False)), "nin_lo": lo,
            "hist": hist}


def frame_ops(g: dict, nin: int) -> int:
    half, M, Nmem, Ndft = g["Ndft"] // 2, g["M"], g["Nmem"], g["Ndft"]
    NP = (g["Nsym"] + 1) * g["P"]
    rest = (M * half + M * Nmem * 14 + M * NP * (g["Ts"] - 1) * 2
            + NP * (3 * M + 4) + g["Nsym"] * M * 8)
    nb = nin // Ndft
    fs = sum(min(max(nin - (j + 1) * Ndft, 0), Ndft) for j in range(nb))
    return fs * (2 + 8 * half) + nb * half * 6 + rest


def work(rec: dict, hist) -> tuple:
    """(float operations, bytes) of one recorded call; hist: its nin
    histogram on the host (the last bin counts the invalid frames)."""
    g, L, nf = rec["geometry"], rec["lanes"], rec["frames"]
    half, M = g["Ndft"] // 2, g["M"]
    NP = (g["Nsym"] + 1) * g["P"]
    ops = sum(int(c) * frame_ops(g, rec["nin_lo"] + i)
              for i, c in enumerate(hist[:-1]) if c)
    nbytes = (rec["samples"] * SAMPLE_BYTES[rec["fmt"]]
              + L * nf * (5 * g["Nbits"] + 4 * M + 13)
              + 2 * L * (4 * half + 8 * M + 24)
              + (L * (8 * M * NP + 5) if rec["eye"] else 0))
    return ops, nbytes
