"""The port's whole-capture and throughput receive paths on the CPU against
the JAX package on the same inputs: `deframe_topk` and the packed results
exactly, the fused geometry, `decode_iq_fused` (v2 c64/cu8/cs16, v1 c64)
and `decode_iq_parallel` payload lists equal; within the port,
`decode_iq_fused_overlap` and `FusedReceiver` equal `decode_iq_fused`, and
the CLI's --parallel and --slabs; `FusedReceiver` also against JAX's on the
same pushes.  Scaled geometries as in
test_torch_pipeline.py; each JAX result is built once."""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wenet_tpu.core import framing
from wenet_tpu.ops import channel
from wenet_tpu.ops import deframe as jdeframe
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.rx import pipeline as jpipe
from wenet_tpu_torch.ops import deframe
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.ops import ldpc
from wenet_tpu_torch.rx import pipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}
N_CHUNKS = 4


@functools.lru_cache(maxsize=None)
def _capture(mode, n_packets=6, seed=0):
    """(iq complex64 scaled to |x| <= 1, payloads): packets between random
    idle bits at 11 dB."""
    cfg = jfsk.FSKConfig(**GEOM[mode])
    rng = np.random.default_rng(seed + (30 if mode == "v2" else 80))
    payloads, bits = [], [rng.integers(0, 2, 1000).astype(np.uint8)]
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        bits.append(rng.integers(0, 2, int(rng.integers(100, 400))
                                 ).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = jfsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig, 11.0, cfg.Fs, cfg.Rs, rng=rng)
    return (iq / np.abs(iq).max()).astype(np.complex64), payloads


def _raw(mode, fmt, **kw):
    iq, _ = _capture(mode, **kw)
    if fmt == "c64":
        return iq
    if fmt == "cu8":
        return jfsk.iq_to_cu8(iq)
    raw = np.empty(2 * len(iq), np.int16)
    raw[0::2] = np.round(iq.real * jfsk.FDMDV_SCALE)
    raw[1::2] = np.round(iq.imag * jfsk.FDMDV_SCALE)
    return raw


def _cfgs(mode):
    return jfsk.FSKConfig(**GEOM[mode]), tfsk.FSKConfig(**GEOM[mode])


@functools.lru_cache(maxsize=None)
def _jax_fused(mode, fmt):
    return jpipe.decode_iq_fused(_raw(mode, fmt), mode, _cfgs(mode)[0],
                                 n_chunks=N_CHUNKS, input_format=fmt)


@functools.lru_cache(maxsize=None)
def _port_fused(mode, fmt):
    return pipeline.decode_iq_fused(_raw(mode, fmt), mode, _cfgs(mode)[1],
                                    n_chunks=N_CHUNKS, input_format=fmt,
                                    device="cpu")


def _soft_streams(mode):
    """Two soft streams of one noisy packet train (the second reversed,
    so its picks are noise and its k picks run out)."""
    rng = np.random.default_rng(3 if mode == "v2" else 4)
    bits = [rng.integers(0, 2, 500).astype(np.uint8)]
    for _ in range(3):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        bits.append(rng.integers(0, 2, 300).astype(np.uint8))
    b = np.concatenate(bits)
    soft = (1 - 2.0 * b + rng.normal(0, 0.5, b.shape)).astype(np.float32)
    return np.stack([soft, soft[::-1].copy()])


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_deframe_topk_matches_jax(mode):
    """Positions, crc_ok, iterations and payload bytes equal JAX's on the
    same soft streams, exhausted picks (-1) included; a 1-d input gives
    the per-stream results."""
    soft = _soft_streams(mode)
    got = deframe.deframe_topk(soft, mode, k=6, device="cpu")
    for c in range(2):
        want = jdeframe.deframe_topk(jnp.asarray(soft[c]), mode=mode, k=6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))
    assert int(got[1][0].sum()) == 3 and (got[3][1] == -1).any()
    one = deframe.deframe_topk(soft[0], mode, k=6, device="cpu")
    for g, w in zip(one, got):
        assert torch.equal(g, w[0])


def test_pack_decode_results_match_jax():
    """deframe_topk(packed=True)'s rows, built by crc_pack, equal JAX's
    pack_decode_results of its unpacked results, and unpack back."""
    soft = _soft_streams("v2")
    pb, ok, _, pos = deframe.deframe_topk(soft, "v2", k=5, device="cpu")
    packed = deframe.deframe_topk(soft, "v2", k=5, device="cpu", packed=True)
    want = jdeframe.pack_decode_results(jnp.asarray(pb.numpy()),
                                        jnp.asarray(ok.numpy()),
                                        jnp.asarray(pos.numpy()))
    assert packed.dtype == torch.uint8 and packed.shape == (2, 5, 263)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    for g, w in zip(deframe.unpack_decode_results(packed.numpy()),
                    (pb, ok, pos)):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("mode,n,n_chunks,warmup", [
    ("v2", 123457, 4, 8), ("v2", 10, 16, 8), ("v1", 900001, 3, 5),
    ("v1", 0, 2, 8)])
def test_fused_geometry_matches_jax(mode, n, n_chunks, warmup):
    want = jpipe._fused_geometry(_cfgs(mode)[0], mode, n, n_chunks, warmup)
    got = pipeline._fused_geometry(_cfgs(mode)[1], mode, n, n_chunks, warmup)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode,fmt", [("v2", "c64"), ("v2", "cu8"),
                                      ("v2", "cs16"), ("v1", "c64")])
def test_decode_iq_fused_matches_jax(mode, fmt):
    want = _jax_fused(mode, fmt)
    assert _port_fused(mode, fmt) == want
    assert want == _capture(mode)[1]


@pytest.mark.parametrize("fmt", ["c64", "cu8"])
def test_decode_iq_parallel_matches_jax(fmt):
    jcfg, tcfg = _cfgs("v2")
    raw = _raw("v2", fmt)
    want = jpipe.decode_iq_parallel(raw, "v2", jcfg, n_chunks=3,
                                    input_format=fmt)
    got = pipeline.decode_iq_parallel(raw, "v2", tcfg, n_chunks=3,
                                      input_format=fmt, device="cpu")
    assert got == want and len(got) == 6


@pytest.mark.parametrize("fmt,n_slabs,depth", [("c64", 2, 2), ("c64", 3, 1),
                                               ("cu8", 3, 2)])
def test_fused_overlap_equals_fused(fmt, n_slabs, depth):
    got = pipeline.decode_iq_fused_overlap(
        _raw("v2", fmt), "v2", _cfgs("v2")[1], n_slabs=n_slabs,
        chunks_per_slab=2, input_format=fmt, depth=depth, device="cpu")
    assert got == _port_fused("v2", fmt)


def _stream(rx, data, bucket):
    got = []
    for i in range(0, len(data), bucket):
        got += rx.push(data[i:i + bucket])
    return got + rx.flush()


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_fused_receiver_streaming_equals_batch(fmt):
    """Unaligned pushes of raw bytes give decode_iq_fused's payloads, each
    once."""
    raw = _raw("v2", fmt)
    cfg = _cfgs("v2")[1]
    rx = pipeline.FusedReceiver("v2", cfg, push_samples=len(raw) // 2 // 3,
                                n_chunks=2, input_format=fmt, depth=2,
                                device="cpu")
    got = _stream(rx, raw, 2 * (37 * cfg.N + 131))
    assert got == _port_fused("v2", fmt)
    assert rx.n_crc_ok == len(got) == 6


@pytest.mark.parametrize("depth", [2, 0])
def test_fused_receiver_matches_jax(depth):
    """The port's FusedReceiver against JAX's FusedReceiver on the same
    cu8 bytes and pushes: equal payload lists, push by push."""
    raw = _raw("v2", "cu8")
    jcfg, tcfg = _cfgs("v2")
    kw = dict(push_samples=len(raw) // 2 // 3, n_chunks=2,
              input_format="cu8", depth=depth)
    bucket = 2 * (37 * tcfg.N + 131)
    jrx = jpipe.FusedReceiver("v2", jcfg, **kw)
    trx = pipeline.FusedReceiver("v2", tcfg, device="cpu", **kw)
    want, got = [], []
    for i in range(0, len(raw), bucket):
        want.append(jrx.push(raw[i:i + bucket]))
        got.append(trx.push(raw[i:i + bucket]))
    want.append(jrx.flush())
    got.append(trx.flush())
    assert got == want
    assert sum(want, []) == _capture("v2")[1]


def test_fused_receiver_push_after_flush():
    """flush() re-anchors the stream: a later push starts a fresh segment
    and its packets decode too."""
    iq, payloads = _capture("v2")
    cfg = _cfgs("v2")[1]
    rx = pipeline.FusedReceiver("v2", cfg, push_samples=len(iq) // 2,
                                n_chunks=2, input_format="c64", depth=1,
                                device="cpu")
    first = rx.push(iq) + rx.flush()
    second = rx.push(iq[::-1].conj()) + rx.flush()
    third = rx.push(iq) + rx.flush()
    assert first == third == payloads
    assert second == []


def test_fused_receiver_dedup_map_stays_bounded():
    """On a long stream of distinct packets the dedup map keeps only the
    entries a later slab could still match, and the payloads equal the
    batch decode of the whole stream."""
    iq = np.concatenate([_capture("v2", seed=s)[0] for s in range(3)])
    want = pipeline.decode_iq_fused(iq, "v2", _cfgs("v2")[1], n_chunks=4,
                                    input_format="c64", device="cpu")
    rx = pipeline.FusedReceiver("v2", _cfgs("v2")[1],
                                push_samples=len(iq) // 7, n_chunks=2,
                                input_format="c64", depth=1, device="cpu")
    got, sizes = [], []
    for i in range(0, len(iq), len(iq) // 10):
        got += rx.push(iq[i:i + len(iq) // 10])
        sizes.append(len(rx._emitted))
    got += rx.flush()
    assert got == want and len(got) == 18
    assert max(sizes) <= 8 and len(rx._emitted) <= 8


def _cli(tmp_path, *args):
    path = tmp_path / "cap.cu8"
    _raw("v2", "cu8").tofile(path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx", str(path),
         "--format", "cu8", "--mode", "v2", "--fs", "96000", "--rs", "9600",
         "--device", "cpu", "--no-udp", "--image-dir", str(tmp_path / "img"),
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("args", [("--parallel", "4"), ("--slabs", "2")])
def test_cli_parallel_and_slabs(tmp_path, args):
    proc = _cli(tmp_path, *args)
    assert proc.returncode == 0, proc.stderr
    last = proc.stderr.strip().splitlines()[-1]
    assert "crc_ok=6 " in last and "device=cpu" in last
    if args[0] == "--slabs":
        assert "implies --parallel 8" in proc.stderr
