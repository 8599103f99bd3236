"""Multi-rank dry run of the scale-out layer (counterpart of
`__graft_entry__.dryrun_multichip`) and the launcher of rank processes.

    python -m wenet_tpu_torch.parallel.dryrun --ranks N \\
        [--backend gloo|nccl] [--device cuda|cpu]

starts N fresh rank processes (new interpreters, never forks: a forked
child cannot use CUDA), gives each its rank, the world size and a
coordinator port on localhost, and runs `dryrun_multichip(N)` in every
one.  Each rank prints one JSON line; the launcher prints them, in rank
order, and exits non-zero if any rank fails or runs past the time limit
(the other ranks are then killed).  Several ranks on one card share it
through gloo (NCCL refuses two ranks on one card); `--backend nccl` needs
a card per rank.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

DRYRUN = "wenet_tpu_torch.parallel.dryrun:dryrun_multichip"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _check(ok, msg: str):
    """Fail the rank (checks that hold under python -O too)."""
    if not ok:
        raise RuntimeError(msg)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run in every rank of a world of n_devices: a data-parallel chain
    sweep with counters summed over the mesh, the time-sharded overlap-save
    decode of one capture, the fused cu8 path with its chunks sharded over
    the mesh, and a batch x check-row-sharded BP decode (tp = 2 where
    n_devices is even).  Raises on any wrong result; returns a summary."""
    import torch

    from ..core import framing
    from ..ops import fsk, ldpc
    from ..rx.pipeline import decode_iq_fused, decode_iq_parallel
    from . import sharded_ldpc, sweep
    from .mesh import make_mesh, make_mesh_2d

    # ---- DP: full-chain Monte-Carlo trials sharded over every rank
    mesh_dp = make_mesh(n_devices, device=device)
    cfg = fsk.FSKConfig(Fs=9600, Rs=960, Nsym=16)   # tiny shapes
    r = sweep.chain_per_sweep(cfg, [14.0], trials_per_point=n_devices,
                              mesh=mesh_dp)
    _check(r["trials"] >= n_devices, f"chain sweep ran {r['trials']} trials")

    # ---- SP: overlap-save time-axis sharding of one capture
    rng0 = np.random.default_rng(7)
    frame = framing.frame_packet(bytes(range(256)), ldpc.encode_bytes, "v2")
    bits0 = np.concatenate([
        rng0.integers(0, 2, cfg.Nbits * 4).astype(np.uint8),
        framing.frame_to_bits(frame, "v2"),
        rng0.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)])
    bits0 = np.concatenate(
        [bits0, np.zeros((-len(bits0)) % cfg.Nbits, np.uint8)])
    sig0, _ = fsk.fsk_mod_np(cfg, bits0, 2 * cfg.Rs, cfg.Rs)
    payloads = decode_iq_parallel(
        (0.3 * sig0).astype(np.complex64), "v2", cfg, n_chunks=n_devices,
        warmup_frames=4, mesh=mesh_dp)
    _check(payloads == [bytes(range(256))], "SP chunked decode failed")

    # ---- the fused ingest path over the mesh: raw cu8 bytes in, the chunk
    # axis sharded over every rank, CRC-valid payloads out
    raw_cu8 = fsk.iq_to_cu8((0.3 * sig0).astype(np.complex64))
    payloads = decode_iq_fused(raw_cu8, "v2", cfg, n_chunks=n_devices,
                               warmup_frames=4, input_format="cu8",
                               mesh=mesh_dp)
    _check(payloads == [bytes(range(256))],
           "fused mesh-sharded decode failed")

    # ---- DP x TP: batch-sharded, check-row-sharded BP decode
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh2 = make_mesh_2d(dp, tp, device=device)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (dp * 2, 258), dtype=np.uint8)
    ibits = np.unpackbits(data, axis=1)
    cw = np.concatenate([ibits, ldpc.encode_bits_np(ibits)], axis=1)
    llr = torch.from_numpy(((1.0 - 2.0 * cw) * 8.0).astype(np.float32))
    bits, iters, ok = sharded_ldpc.decode_sharded(llr, mesh2)
    _check(np.array_equal(bits.cpu().numpy(), cw), "sharded decode: bits")
    _check(bool(ok.all()), "sharded decode: parity")
    return {"n_devices": n_devices, "dp": dp, "tp": tp,
            "per": float(r["per"][0]), "codewords": int(llr.shape[0]),
            "device": str(mesh_dp.device), "backend": mesh_dp.backend}


# ---------------------------------------------------------------- launcher


def free_port() -> int:
    """A localhost TCP port the OS reports free (bound to 0, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n_ranks: int, target: str = DRYRUN, args=(), backend=None,
           device="cuda", timeout: float = 600.0) -> list:
    """Run `target` ("module:function") in n_ranks fresh rank processes as
    `function(*args, device=device)` -> a JSON-able dict, and return the
    dicts in rank order.  backend: None for gloo on the CPU and the
    default of `mesh.init_distributed` on the card.  Raises if a rank
    exits non-zero (after killing the others) or the time runs out."""
    port = free_port()
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(n_ranks),
               PYTHONPATH=os.pathsep.join(
                   p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for rank in range(n_ranks):
                out = open(os.path.join(tmp, f"{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"{rank}.err"), "w+")
                logs.append((out, err))
                cmd = [sys.executable, "-m", "wenet_tpu_torch.parallel.dryrun",
                       "--rank", str(rank), "--world", str(n_ranks),
                       "--port", str(port), "--device", device,
                       "--target", target, "--args", json.dumps(list(args))]
                if backend:
                    cmd += ["--backend", backend]
                procs.append(subprocess.Popen(
                    cmd, cwd=_ROOT, stdout=out, stderr=err,
                    env=dict(env, LOCAL_RANK=str(rank))))
            deadline = time.monotonic() + timeout
            failed = []
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                failed = [r for r, p in enumerate(procs) if p.returncode]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if failed:
        raise RuntimeError("\n".join(
            f"rank {r} of {n_ranks} exited with {procs[r].returncode}:\n"
            + "\n".join(texts[r][1].strip().splitlines()[-15:])
            for r in failed))
    if any(p.returncode for p in procs):
        raise RuntimeError(f"the ranks ran past {timeout} s and were killed")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in texts]


def _rank_main(a) -> int:
    """One rank: start the process group, run the target, print its dict
    as one JSON line."""
    import torch
    import torch.distributed as dist

    from .mesh import init_distributed

    if a.device == "cpu":            # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // a.world))
    backend = a.backend or ("gloo" if a.device == "cpu" else None)
    init_distributed(f"127.0.0.1:{a.port}", a.world, a.rank, backend)
    module, name = a.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(*json.loads(a.args), device=a.device)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    print(json.dumps({"rank": a.rank, **result}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    # a rank process (started by the launcher)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--target", default=DRYRUN, help=argparse.SUPPRESS)
    ap.add_argument("--args", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return _rank_main(a)
    t0 = time.perf_counter()
    for line in launch(a.ranks, DRYRUN, [a.ranks], a.backend, a.device,
                       a.timeout):
        print(json.dumps(line), flush=True)
    print(f"dryrun_multichip({a.ranks}): OK in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
