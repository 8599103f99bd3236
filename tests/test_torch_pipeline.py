"""PyTorch port of the streaming Receiver (wenet_tpu_torch.rx.pipeline) on
the CPU against the JAX Receiver on the same bytes, v2 and v1: payload
lists and frames/detections/crc_ok are identical for c64 one-shot, cu8 and
cs16 push, unaligned streaming and pipelined mode; plus the CLI."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wenet_tpu.core import framing
from wenet_tpu.ops import channel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.rx.pipeline import Receiver as JaxReceiver
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.ops import ldpc
from wenet_tpu_torch.rx.pipeline import Receiver, receiver_stats_record

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = {"v2": dict(Fs=96000, Rs=9600), "v1": dict(Fs=92000, Rs=11500)}


@functools.lru_cache(maxsize=None)
def _capture(mode):
    """(iq complex64, payloads) at 9.5 dB: 5 packets between idle bits."""
    cfg = jfsk.FSKConfig(**GEOM[mode])
    rng = np.random.default_rng(21 if mode == "v2" else 70)
    payloads, bits = [], [rng.integers(0, 2, 1000).astype(np.uint8)]
    for _ in range(5):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        bits.append(rng.integers(0, 2, 300).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = jfsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig, 9.5, cfg.Fs, cfg.Rs, rng=rng)
    return iq, payloads


def _raw(mode, fmt):
    iq, _ = _capture(mode)
    if fmt == "cu8":
        return jfsk.iq_to_cu8(iq)
    raw = np.empty(2 * len(iq), np.int16)
    raw[0::2] = np.round(iq.real * 820)
    raw[1::2] = np.round(iq.imag * 820)
    return raw


def _stats(rx):
    return rx.stats.frames, rx.stats.detections, rx.stats.crc_ok


@functools.lru_cache(maxsize=None)
def _jax_oneshot(mode):
    rx = JaxReceiver(mode=mode, cfg=jfsk.FSKConfig(**GEOM[mode]))
    return rx.decode_iq(_capture(mode)[0]), _stats(rx)


def _port(mode, **kw):
    return Receiver(mode=mode, cfg=tfsk.FSKConfig(**GEOM[mode]),
                    device="cpu", **kw)


def _push_all(rx, data, step):
    got = []
    for i in range(0, len(data), step):
        got += rx.push(data[i:i + step])
    return got + rx.flush()


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_c64_oneshot_matches_jax(mode):
    want, want_stats = _jax_oneshot(mode)
    rx = _port(mode)
    assert rx.decode_iq(_capture(mode)[0]) == want
    assert _stats(rx) == want_stats
    assert want == _capture(mode)[1]
    rec = receiver_stats_record(rx)
    assert len(rec["samp_fft"]) == rx.cfg.Ndft // 2 and rec["f2_est"] > 0


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_raw_push_matches_jax(fmt):
    raw = _raw("v2", fmt)
    step = 2 * (len(raw) // 2 // 5)
    cfg = jfsk.FSKConfig(**GEOM["v2"])
    rj = JaxReceiver(mode="v2", cfg=cfg, input_format=fmt)
    want = _push_all(rj, raw, step)
    rt = _port("v2", input_format=fmt)
    assert _push_all(rt, raw, step) == want
    assert _stats(rt) == _stats(rj)
    assert len(want) == 5


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_unaligned_streaming_equals_oneshot(mode):
    iq, _ = _capture(mode)
    rx = _port(mode)
    chunk = 37 * rx.cfg.N + 13
    assert _push_all(rx, iq, chunk) == _jax_oneshot(mode)[0]
    assert _stats(rx) == _jax_oneshot(mode)[1]


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_pipelined_equals_serial(mode):
    iq, _ = _capture(mode)
    serial, pp = _port(mode), _port(mode, pipelined=True)
    chunk = 29 * serial.cfg.N + 7
    got_s = _push_all(serial, iq, chunk)
    got_p = _push_all(pp, iq, chunk)
    assert got_p == got_s == _jax_oneshot(mode)[0]
    assert _stats(pp) == _stats(serial)
    assert pp.stats.samples == serial.stats.samples == len(iq)


def test_cli_decodes_cu8_file(tmp_path):
    raw = _raw("v2", "cu8")
    path = tmp_path / "cap.cu8"
    raw.tofile(path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx", str(path),
         "--format", "cu8", "--mode", "v2", "--fs", "96000", "--rs", "9600",
         "--device", "cpu", "--no-udp", "--image-dir", str(tmp_path / "img"),
         "--chunk-seconds", "0.5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "crc_ok=5 " in proc.stderr.strip().splitlines()[-1]


def test_cli_rejects_unported_modes(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx", "x.cu8",
         "--parallel", "4", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert "not yet ported to wenet_tpu_torch" in proc.stderr
