"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the BP decode kernel from wenet_tpu_torch/csrc with nvcc, holds it
against its plain PyTorch version on the card, then drives the streaming
receiver (the port's main path) at the v2 and v1 flight geometries on
synthetic captures, a negative probe below the decode cliff, and the
`python -m wenet_tpu_torch rx` CLI.  Each phase prints one line; any failed
check raises, so the script exits non-zero before its last line.  The last
two lines are a JSON object with the kernels' numbers and one with the
device.  Without a CUDA device the script fails at once.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
V2_PACKETS = 40
V1_PACKETS = 20
EBNO_DB = 12.0
BP_BATCH = 128
BP_SNRS = (2.5, 3.0, 6.0)


def require(ok, msg: str):
    """Fail the run (checks must hold even under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def say(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def add_awgn(iq, ebno_db, Fs, Rs, rng):
    """Calibrated complex AWGN at Eb/N0 (1 bit/symbol), peak-normalised."""
    var = float(np.var(iq))
    nvar = var * Fs / (Rs * 10.0 ** (ebno_db / 10.0))
    n = rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq))
    noisy = iq + np.sqrt(nvar / 2.0) * n
    return (noisy / np.max(np.abs(noisy))).astype(np.complex64)


def make_capture(cfg, mode, payloads, ebno_db, rng):
    """Framed packets with random idle bits between them -> FSK -> AWGN ->
    cu8 bytes."""
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import fsk, ldpc

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
    return fsk.iq_to_cu8(add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs, rng))


def text_message(message: str, count: int) -> bytes:
    """Wenet text-message packet: type 0x00, length, big-endian count,
    ASCII text."""
    return (b"\x00" + struct.pack(">BH", len(message), count)
            + message.encode("ascii"))


def timed(fn, *args, n=20):
    """Seconds per call: warm-up, n calls, synchronize, one-element D2H."""
    import torch
    out = fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    torch.cuda.synchronize()
    out[1][:1].cpu()
    return (time.perf_counter() - t0) / n


def run_receiver(cfg, mode, raw, pipelined=False, chunk_seconds=2.0):
    from wenet_tpu_torch.rx.pipeline import Receiver
    import torch

    rx = Receiver(mode=mode, cfg=cfg, input_format="cu8", device="cuda",
                  pipelined=pipelined)
    step = 2 * int(cfg.Fs * chunk_seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = []
    for i in range(0, len(raw), step):
        got += rx.push(raw[i:i + step])
    got += rx.flush()
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, rx


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from wenet_tpu_torch import kernels
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.kernels import bp_decode
    from wenet_tpu_torch.ops import fsk, ldpc

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    bp_decode.build()
    say("build", kernel="bp_decode", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc=kernels.nvcc_path())

    # 3. kernel vs plain on the card, B = 128
    rng = np.random.default_rng(SEED)
    max_err = 0
    times = {}
    for snr in BP_SNRS:
        ib = np.unpackbits(rng.integers(0, 256, (BP_BATCH, 258),
                                        dtype=np.uint8), axis=1)
        cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
        esn0 = 10 ** (snr / 10) * 0.8
        sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
        llr = ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32,
                                             device=dev))
        bk, ik, ok_k = ldpc.decode(llr)
        br, ir, ok_r = ldpc.decode_reference(llr)
        torch.cuda.synchronize()
        bk, ik, ok_k, br, ir, ok_r = (t.cpu().numpy() for t in
                                      (bk, ik, ok_k, br, ir, ok_r))
        # exact: bits, iters and parity_ok of every codeword
        bit_mis = int((bk != br).any(axis=1).sum())
        it_mis = int((ik != ir).sum())
        ok_mis = int((ok_k != ok_r).sum())
        require(bit_mis == 0 and it_mis == 0 and ok_mis == 0,
                f"{snr} dB: {bit_mis} codewords differ in bits, {it_mis} in "
                f"iters, {ok_mis} in parity_ok")
        max_err = max(max_err, int(np.abs(bk.astype(int) - br).max()),
                      int(np.abs(ik - ir).max()))
        tk = timed(ldpc.decode, llr) * 1e3
        tr = timed(ldpc.decode_reference, llr) * 1e3
        times[snr] = (tk, tr)
        say("bp_vs_plain", snr_db=snr, batch=BP_BATCH,
            converged=int(ok_k.sum()), bit_mismatch=bit_mis,
            iters_mismatch=it_mis, parity_mismatch=ok_mis,
            kernel_ms=f"{tk:.4f}", plain_ms=f"{tr:.4f}")

    # 4. main path, v2 at flight rate (the counted run)
    cfg2 = fsk.V2_CONFIG
    sent2 = [text_message(f"smoke {i}", i)
             for i in range(V2_PACKETS)]
    raw2 = make_capture(cfg2, "v2", sent2, EBNO_DB, rng)
    want2 = [framing.pad_payload(p) for p in sent2]
    bp_decode.launches = 0
    got2, dt2, rx2 = run_receiver(cfg2, "v2", raw2)
    main_launches = bp_decode.launches
    n2 = len(raw2) // 2
    require(got2 == want2, f"v2: {len(got2)}/{len(want2)} payloads match")
    require(main_launches > 0, "v2 main path never launched bp_decode")
    sec2 = rx2.seconds
    say("v2_stream", packets=f"{len(got2)}/{len(sent2)}", samples=n2,
        wall_s=f"{dt2:.3f}", msps=f"{n2 / dt2 / 1e6:.4f}",
        realtime_msps=f"{cfg2.Fs / 1e6:.3f}",
        demod_share=f"{sec2['demod'] / dt2:.3f}",
        deframe_share=f"{sec2['deframe'] / dt2:.3f}",
        bp_launches=main_launches, frames=rx2.stats.frames)

    # 5. main path, v1 at flight rate; pipelined == serial
    cfg1 = fsk.V1_CONFIG
    sent1 = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
             for _ in range(V1_PACKETS)]
    raw1 = make_capture(cfg1, "v1", sent1, EBNO_DB, rng)
    before = bp_decode.launches
    got1, dt1, rx1 = run_receiver(cfg1, "v1", raw1)
    got1p, dt1p, _ = run_receiver(cfg1, "v1", raw1, pipelined=True)
    n1 = len(raw1) // 2
    require(got1 == sent1, f"v1: {len(got1)}/{len(sent1)} payloads match")
    require(got1p == got1, "v1 pipelined differs from serial")
    require(bp_decode.launches > before, "v1 path never launched bp_decode")
    say("v1_stream", packets=f"{len(got1)}/{len(sent1)}", samples=n1,
        wall_s=f"{dt1:.3f}", msps=f"{n1 / dt1 / 1e6:.4f}",
        pipelined_wall_s=f"{dt1p:.3f}", pipelined_equal=True,
        realtime_msps=f"{cfg1.Fs / 1e6:.3f}",
        demod_share=f"{rx1.seconds['demod'] / dt1:.3f}",
        deframe_share=f"{rx1.seconds['deframe'] / dt1:.3f}")

    # 6. negative probe far below the cliff
    raw_neg = make_capture(cfg2, "v2", sent2[:8], -6.0, rng)
    got_neg, dt_neg, rx_neg = run_receiver(cfg2, "v2", raw_neg)
    require(got_neg == [], f"negative probe decoded {len(got_neg)} payloads")
    say("negative", ebno_db=-6.0, payloads=len(got_neg),
        detections=rx_neg.stats.detections, wall_s=f"{dt_neg:.3f}")

    # 7. CLI on the v2 capture
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke_v2.cu8")
        raw2.tofile(path)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "wenet_tpu_torch", "rx", path,
             "--format", "cu8", "--mode", "v2", "--no-udp",
             "--image-dir", os.path.join(tmp, "img")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        dt_cli = time.perf_counter() - t0
    line = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
    require(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr}")
    require(f"crc_ok={V2_PACKETS} " in line, f"CLI: {line}")
    say("cli", rc=proc.returncode, wall_s=f"{dt_cli:.2f}", stderr=repr(line))

    tk, tr = times[BP_SNRS[0]]
    print(json.dumps({"kernels": [{
        "name": "bp_decode", "route": "cuda",
        "source": "wenet_tpu_torch/csrc/bp_decode.cu",
        "replaces": "wenet_tpu/ops/ldpc_pallas2.py:114",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": tk, "plain_ms": tr}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
