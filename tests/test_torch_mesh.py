"""The port's scale-out layer (wenet_tpu_torch.parallel.{mesh,sharded_ldpc,
dryrun} and the `mesh=` of the sweeps and capture decoders) against the
JAX package and the unsharded port, on gloo worlds of CPU ranks.

A module-scoped fixture starts one world of 2 ranks and one of 4 (each
rank a fresh process, one torch thread), in which every rank runs every
check of tests/torch_mesh_ranks.py once; the tests below then hold one
result each.  The JAX references run in this process on the conftest's 8
virtual CPU devices.  Exact throughout: mesh shapes, collectives, BP bits,
iterations and parity, payload lists, sweep counts and padded sizes, and
acquisition scores.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.parallel import mesh as jmesh
from wenet_tpu.parallel import sharded_ldpc as jsharded
from wenet_tpu.parallel import sweep as jsweep
from wenet_tpu.rx import pipeline as jpipe
from wenet_tpu_torch.ops import ldpc
from wenet_tpu_torch.parallel import dryrun, make_mesh, sweep
from wenet_tpu_torch.parallel.mesh import init_distributed
from wenet_tpu_torch.rx import pipeline

import torch_mesh_ranks as R
from test_parallel_decode import CFG as JCFG, _capture
from test_torch_sweep import _shifted_capture, _valid_frames

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)


def _codeword_llrs(seed: int, ebno_db: float, B: int = 8) -> np.ndarray:
    """LLRs of B random codewords at ebno_db, through JAX's sd_to_llr (the
    LLRs of tests/test_parallel.py at seed 30 and 7.5 dB)."""
    rng = np.random.default_rng(seed)
    ibits = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8),
                          axis=1)
    cw = np.concatenate([ibits, jldpc.encode_bits_np(ibits)], axis=1)
    esn0 = 10 ** (ebno_db / 10) * 0.8
    sd = 1.0 - 2.0 * cw + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return np.asarray(jldpc.sd_to_llr(jnp.asarray(sd, jnp.float32)))


@functools.lru_cache(maxsize=None)
def _inputs():
    payloads, iq = _capture(12, np.random.default_rng(64), ebno=14.0)
    acq_iq = _shifted_capture()
    return {"llr_seed30": _codeword_llrs(30, 7.5),
            # near the cliff (at 2.5 dB none of 8 converges): the
            # codewords stop at 7, 9 and 10 iterations
            "llr_cliff": _codeword_llrs(31, 3.5),
            "raw": jfsk.iq_to_cu8(iq / np.abs(iq).max()),
            "iq": iq, "acq_iq": acq_iq,
            "acq_grid": np.arange(-40000, 40001, 5000, np.float32),
            "acq_frames": np.int64(_valid_frames(R.CFG, acq_iq) - 1)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's dict]}."""
    path = str(tmp_path_factory.mktemp("mesh") / "inputs.npz")
    np.savez(path, **_inputs())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            p for p in (TESTS, os.environ.get("PYTHONPATH")) if p))
        for n in WORLDS:
            out[n] = dryrun.launch(n, "torch_mesh_ranks:checks", [path],
                                   device="cpu", timeout=300)
    return out


def _same_in_every_rank(ranks, key):
    for r in ranks[1:]:
        assert r[key] == ranks[0][key], (key, r["rank"])
    return ranks[0][key]


def test_init_distributed_without_a_group():
    assert init_distributed() == 1
    m = make_mesh(device="cpu")
    assert (m.size, m.rank, m.axis_names) == (1, 0, ("batch",))
    t = torch.arange(3)
    assert m.sum(t) is t and m.gather(t) is t
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    with pytest.raises(TypeError):       # a device where the mesh goes
        sweep.ldpc_ber_sweep([3.0], 4, None, "cpu")


@pytest.mark.parametrize("n", WORLDS)
def test_meshes(worlds, n):
    ranks = worlds[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    for i, r in enumerate(ranks):
        assert r["world"] == n
        assert r["mesh"] == {"axis_names": ["batch"], "shape": {"batch": n},
                             "size": n, "coords": {"batch": i},
                             "device": "cpu"}
        for key in ("mesh_2d", "mesh_hybrid"):
            # row-major: rank = b * tp + m, the tp group innermost
            assert r[key] == {"axis_names": ["batch", "model"],
                              "shape": {"batch": n // 2, "model": 2},
                              "size": n,
                              "coords": {"batch": i // 2, "model": i % 2},
                              "device": "cpu"}


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_errors(worlds, n):
    """n_devices other than the world, a grid of another size, tp that does
    not divide the world, chunks that do not split over the mesh."""
    assert _same_in_every_rank(worlds[n], "errors") == ["ValueError"] * 4


@pytest.mark.parametrize("n", WORLDS)
def test_collectives(worlds, n):
    for i, r in enumerate(worlds[n]):
        assert r["sum"] == [n * (n - 1) // 2]
        assert r["gather"] == list(range(n))
        b, m = divmod(i, 2)
        assert r["sum_model"] == [4 * b + 1]
        assert r["gather_batch"] == list(range(m, n, 2))


@functools.lru_cache(maxsize=None)
def _jax_sharded(name):
    mesh = jmesh.make_mesh_2d(4, 2)
    out = jax.jit(lambda x: jsharded.decode_sharded(x, mesh))(
        jnp.asarray(_inputs()[name]))
    return tuple(np.asarray(t) for t in out)


@pytest.mark.parametrize("name", ["llr_seed30", "llr_cliff"])
@pytest.mark.parametrize("n", WORLDS)
def test_decode_sharded_matches_jax_and_plain(worlds, n, name):
    """1x2 and 2x2 meshes: bits, iterations and parity equal JAX's
    decode_sharded on a 4x2 mesh and the port's plain decode, exactly; the
    cliff batch's codewords stop at different iterations, so the exit is
    held where a model group's ranks must agree on it."""
    got = _same_in_every_rank(worlds[n], name)
    llr = _inputs()[name]
    plain = [t.numpy() for t in ldpc.decode_reference(torch.tensor(llr))]
    for bits, iters, ok in (_jax_sharded(name), plain):
        assert got["bits"] == np.packbits(bits, axis=1).tobytes().hex()
        assert got["iters"] == iters.tolist()
        assert got["ok"] == ok.tolist()
    if name == "llr_cliff":
        assert sorted(set(got["iters"])) == [7, 9, 10]


@functools.lru_cache(maxsize=None)
def _fused_lists():
    d = _inputs()
    jax_mesh = jpipe.decode_iq_fused(d["raw"], "v2", JCFG,
                                     n_chunks=R.FUSED_CHUNKS,
                                     input_format="cu8",
                                     mesh=jmesh.make_mesh(8))
    port = pipeline.decode_iq_fused(d["raw"], "v2", R.CFG,
                                    n_chunks=R.FUSED_CHUNKS,
                                    input_format="cu8", device="cpu")
    return [p.hex() for p in jax_mesh], [p.hex() for p in port]


@functools.lru_cache(maxsize=None)
def _parallel_lists():
    d = _inputs()
    jax_mesh = jpipe.decode_iq_parallel(d["iq"], "v2", JCFG,
                                        n_chunks=R.FUSED_CHUNKS,
                                        mesh=jmesh.make_mesh(8))
    port = pipeline.decode_iq_parallel(d["iq"], "v2", R.CFG,
                                       n_chunks=R.FUSED_CHUNKS,
                                       device="cpu")
    return [p.hex() for p in jax_mesh], [p.hex() for p in port]


@pytest.mark.parametrize("n", WORLDS)
def test_decode_iq_fused_mesh(worlds, n):
    """Every rank returns the unsharded port's list and JAX's list with the
    chunk axis sharded over 8 devices."""
    got = _same_in_every_rank(worlds[n], "fused")
    want_jax, want_port = _fused_lists()
    assert got == want_port == want_jax
    assert len(got) >= 11


@pytest.mark.parametrize("n", WORLDS)
def test_decode_iq_parallel_mesh(worlds, n):
    got = _same_in_every_rank(worlds[n], "parallel")
    want_jax, want_port = _parallel_lists()
    assert got == want_port == want_jax == _fused_lists()[0]
    assert len(got) >= 11


@pytest.mark.parametrize("n", WORLDS)
def test_ldpc_ber_sweep_mesh(worlds, n):
    """The padded count is JAX's; the n-rank sweep equals the one-rank
    sweep of that count."""
    got = _same_in_every_rank(worlds[n], "ber")
    j = jsweep.ldpc_ber_sweep(R.BER_GRID, R.BER_CODEWORDS,
                              mesh=jmesh.make_mesh(n))
    assert got["n_codewords"] == j["n_codewords"] == -(-5 // n) * n
    one = sweep.ldpc_ber_sweep(R.BER_GRID, got["n_codewords"], device="cpu")
    assert got == {k: np.asarray(v).tolist() for k, v in one.items()}


@pytest.mark.parametrize("n", WORLDS)
def test_chain_per_sweep_mesh(worlds, n):
    got = _same_in_every_rank(worlds[n], "chain")
    tiny = jfsk.FSKConfig(Fs=9600, Rs=960, Nsym=16)   # the count alone
    j = jsweep.chain_per_sweep(tiny, [14.0], R.CHAIN_TRIALS,
                               mesh=jmesh.make_mesh(n))
    assert got["trials"] == j["trials"] == -(-5 // n) * n
    one = sweep.chain_per_sweep(R.CFG, R.CHAIN_GRID, got["trials"],
                                device="cpu")
    assert got == {k: np.asarray(v).tolist() for k, v in one.items()}


@functools.lru_cache(maxsize=None)
def _jax_acquisition():
    """JAX's best offset (its sharded search scores the same offsets)."""
    d = _inputs()
    return jsweep.acquisition_search(JCFG, d["acq_iq"], d["acq_grid"],
                                     probe_frames=int(d["acq_frames"]))[0]


@pytest.mark.parametrize("n", WORLDS)
def test_acquisition_search_mesh(worlds, n):
    """The grid of 17 offsets pads to a multiple of n; the scores, cut back
    to the grid, equal the unsharded call's, and the offset JAX's."""
    got = _same_in_every_rank(worlds[n], "acquire")
    d = _inputs()
    nf = int(d["acq_frames"])
    best, scores = sweep.acquisition_search(R.CFG, d["acq_iq"], d["acq_grid"],
                                            probe_frames=nf, device="cpu")
    assert got == {"best": best, "scores": scores.tolist()}
    assert got["best"] == _jax_acquisition() and len(got["scores"]) == 17


@pytest.mark.parametrize("target,timeout,match", [
    ("fail", 120.0, "exited with 1:(.|\n)*rank 1 fails on purpose"),
    ("hang", 5.0, "ran past 5.0 s")])
def test_launcher_fails_with_its_ranks(target, timeout, match, monkeypatch):
    """A rank that raises, or ranks that run past the time limit, make the
    launcher kill the rest and raise (the dry run's CLI then exits
    non-zero): no rank's failure passes unseen."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (TESTS, os.environ.get("PYTHONPATH")) if p))
    with pytest.raises(RuntimeError, match=match):
        dryrun.launch(2, f"torch_mesh_ranks:{target}", device="cpu",
                      timeout=timeout)


def test_dryrun_multichip_two_ranks(worlds):
    """The counterpart of tests/test_parallel.py::test_graft_entry_multichip
    on 2 ranks: every stage's checks held in each rank."""
    for r in worlds[2]:
        assert r["dryrun"] == {"n_devices": 2, "dp": 1, "tp": 2,
                               "per": r["dryrun"]["per"], "codewords": 2,
                               "device": "cpu", "backend": "gloo"}
