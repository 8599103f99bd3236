"""The rank side of tests/test_torch_mesh.py: run in every rank of a gloo
world on the CPU (started by `wenet_tpu_torch.parallel.dryrun.launch`), it
makes the meshes and calls each `mesh=` function once on the inputs the
test wrote, and returns what they gave as one JSON-able dict.  The test
process compares those with the JAX package and the unsharded port.
No JAX here: a rank imports torch and the port only."""
import time

import numpy as np
import torch
import torch.distributed as dist

from wenet_tpu_torch.ops import fsk
from wenet_tpu_torch.parallel import dryrun, sharded_ldpc, sweep
from wenet_tpu_torch.parallel.mesh import (init_distributed, make_hybrid_mesh,
                                           make_mesh, make_mesh_2d)
from wenet_tpu_torch.rx import pipeline

CFG = fsk.FSKConfig(Fs=96000, Rs=9600)
# the inputs of the checks, shared with the test
FUSED_CHUNKS = 8
BER_GRID, BER_CODEWORDS = [2.5, 3.5], 5
CHAIN_GRID, CHAIN_TRIALS = [6.0, 8.0], 5


def _raises(fn) -> str | None:
    """The name of the exception fn raises, None if it returns."""
    try:
        fn()
    except Exception as e:             # the test asserts which one
        return type(e).__name__
    return None


def _mesh(m) -> dict:
    return {"axis_names": list(m.axis_names), "shape": m.shape,
            "size": m.size, "coords": m.coords, "device": str(m.device)}


def _decoded(out) -> dict:
    bits, iters, ok = (t.cpu().numpy() for t in out)
    return {"bits": np.packbits(bits, axis=1).tobytes().hex(),
            "iters": iters.tolist(), "ok": ok.tolist()}


def checks(path: str, device="cpu") -> dict:
    torch.set_num_threads(1)
    d = np.load(path)
    world = init_distributed()           # the launcher started the group
    out = {"world": world}
    m1 = make_mesh(device=device)
    m2 = make_mesh_2d(world // 2, 2, device=device)
    out["mesh"] = _mesh(m1)
    out["mesh_2d"] = _mesh(m2)
    out["mesh_hybrid"] = _mesh(make_hybrid_mesh(tp=2, device=device))
    out["errors"] = [
        _raises(lambda: make_mesh(world + 1, device=device)),
        _raises(lambda: make_mesh_2d(world, 2, device=device)),
        _raises(lambda: make_hybrid_mesh(tp=3, device=device)),
        _raises(lambda: pipeline.decode_iq_fused(
            d["raw"], "v2", CFG, n_chunks=world + 1, mesh=m1))]
    rank = torch.tensor([m1.rank], dtype=torch.int64)
    out["sum"] = m1.sum(rank).tolist()
    out["gather"] = m1.gather(rank).tolist()
    out["sum_model"] = m2.sum(rank, "model").tolist()
    out["gather_batch"] = m2.gather(rank, "batch").tolist()

    for name in ("llr_seed30", "llr_cliff"):
        out[name] = _decoded(sharded_ldpc.decode_sharded(
            torch.from_numpy(d[name]), m2))

    out["fused"] = [p.hex() for p in pipeline.decode_iq_fused(
        d["raw"], "v2", CFG, n_chunks=FUSED_CHUNKS, input_format="cu8",
        mesh=m1)]
    out["parallel"] = [p.hex() for p in pipeline.decode_iq_parallel(
        d["iq"], "v2", CFG, n_chunks=FUSED_CHUNKS, mesh=m1)]

    r = sweep.ldpc_ber_sweep(BER_GRID, BER_CODEWORDS, mesh=m1)
    out["ber"] = {k: np.asarray(v).tolist() for k, v in r.items()}
    r = sweep.chain_per_sweep(CFG, CHAIN_GRID, CHAIN_TRIALS, mesh=m1)
    out["chain"] = {k: np.asarray(v).tolist() for k, v in r.items()}
    best, scores = sweep.acquisition_search(
        CFG, d["acq_iq"], d["acq_grid"], probe_frames=int(d["acq_frames"]),
        mesh=m1)
    out["acquire"] = {"best": best, "scores": scores.tolist()}

    if world == 2:
        out["dryrun"] = dryrun.dryrun_multichip(world, device=device)
    return out


def fail(device="cpu") -> dict:
    """Rank 1 raises; rank 0 waits for it in a barrier that never ends."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return {}


def hang(device="cpu") -> dict:
    """Every rank sleeps past the launcher's time limit."""
    time.sleep(3600)
    return {}
