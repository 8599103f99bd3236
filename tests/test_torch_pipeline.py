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
from wenet_tpu.rx.stats import receiver_stats_record as jax_stats_record
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


def _wideband_capture(cfg, n_ch, channel_k, message, seed):
    """One text packet on channel `channel_k` of an n_ch-channel wideband
    capture at 30 dB (tests/test_channelizer.py::test_wideband_cli)."""
    from wenet_tpu.core import packets as wp
    rng = np.random.default_rng(seed)
    frame = framing.frame_packet(wp.encode_text_message(message, 7),
                                 ldpc.encode_bytes, mode="v2")
    bits = np.concatenate([
        rng.integers(0, 2, cfg.Nbits * 3).astype(np.uint8),
        framing.frame_to_bits(frame, "v2"),
        rng.integers(0, 2, cfg.Nbits * 3).astype(np.uint8)])
    bits = np.concatenate([bits, np.zeros((-len(bits)) % cfg.Nbits,
                                          np.uint8)])
    sig = jfsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)[0].astype(
        np.complex64)
    fs_total = cfg.Fs * n_ch
    n = len(sig)
    t = np.arange(n * n_ch) / fs_total
    dst_t = np.arange(n * n_ch) / n_ch
    i0 = np.minimum(dst_t.astype(np.int64), n - 2)
    fr = dst_t - i0
    nb = (1 - fr) * sig[i0] + fr * sig[i0 + 1]
    wide = (nb * np.exp(2j * np.pi * (channel_k * fs_total / n_ch) * t)
            ).astype(np.complex64)
    return channel.add_awgn(wide, 30.0, fs_total, cfg.Rs,
                            rng=np.random.default_rng(seed + 1))


def _text_logs(log_dir):
    return sorted(p.read_text() for p in log_dir.glob("*text*"))


def test_cli_wideband_matches_jax(tmp_path, capsys):
    """`rx --channels 8 --channel-select 3` through both CLIs on the CPU
    (the port with --device cpu): exit 0, one packet each, the same text
    log; and without --channel-select the port routes it too."""
    from wenet_tpu.cli import rx as jax_cli
    from wenet_tpu_torch.cli import rx as port_cli
    cfg = jfsk.FSKConfig(**GEOM["v2"])
    cap = tmp_path / "wide.c64"
    _wideband_capture(cfg, 8, 3, "wideband channel three", 60).tofile(cap)
    common = [str(cap), "--format", "c64", "--channels", "8", "--mode", "v2",
              "--fs", str(cfg.Fs), "--rs", str(cfg.Rs), "--no-udp"]
    logs, lines = {}, {}
    for name, cli, extra in (
            ("jax", jax_cli, ["--channel-select", "3"]),
            ("port", port_cli, ["--channel-select", "3", "--device", "cpu"]),
            ("port_all", port_cli, ["--device", "cpu"])):
        out = tmp_path / name
        assert cli.main(common + extra + [
            "--image-dir", str(out / "img"), "--log-dir",
            str(out / "logs")]) == 0
        logs[name] = _text_logs(out / "logs")
        lines[name] = capsys.readouterr().err.strip().splitlines()[-1]
    assert logs["port"] == logs["jax"] == logs["port_all"]
    assert len(logs["jax"]) == 1 and "wideband channel three" in logs["jax"][0]
    for name in lines:
        assert lines[name].startswith("wideband: 8 channels, 1 packets, "), \
            lines[name]


def test_cli_wideband_cu8_matches_jax(tmp_path, capsys):
    """`rx --format cu8 --channels 8` through both CLIs on the CPU: the
    port passes the raw bytes to the channelizer (converted there), the
    JAX CLI converts on the host; exit 0, one packet each, the same text
    log."""
    from wenet_tpu.cli import rx as jax_cli
    from wenet_tpu_torch.cli import rx as port_cli
    cfg = jfsk.FSKConfig(**GEOM["v2"])
    cap = tmp_path / "wide.cu8"
    wide = _wideband_capture(cfg, 8, 3, "wideband channel three", 60)
    jfsk.iq_to_cu8(wide / 2).tofile(cap)
    common = [str(cap), "--format", "cu8", "--channels", "8", "--mode", "v2",
              "--fs", str(cfg.Fs), "--rs", str(cfg.Rs), "--no-udp"]
    logs, lines = {}, {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / name
        assert cli.main(common + extra + [
            "--image-dir", str(out / "img"), "--log-dir",
            str(out / "logs")]) == 0
        logs[name] = _text_logs(out / "logs")
        lines[name] = capsys.readouterr().err.strip().splitlines()[-1]
    assert logs["port"] == logs["jax"]
    assert len(logs["jax"]) == 1 and "wideband channel three" in logs["jax"][0]
    for name in lines:
        assert lines[name].startswith("wideband: 8 channels, 1 packets, "), \
            lines[name]


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_stats_record_with_eye_matches_jax(mode):
    """A with_eye receiver's stats record has JAX's keys, and its eye
    diagram (the last valid frame's) is within 1e-5 of JAX's; chunked
    pushes keep the eye of the last push that had a valid frame."""
    iq, _ = _capture(mode)
    rj = JaxReceiver(mode=mode, cfg=jfsk.FSKConfig(**GEOM[mode]),
                     with_eye=True)
    chunk = 29 * rj.cfg.N + 7
    _push_all(rj, iq, chunk)
    rt = _port(mode, with_eye=True)
    _push_all(rt, iq, chunk)
    rec_j, rec_t = jax_stats_record(rj), receiver_stats_record(rt)
    assert set(rec_t) == set(rec_j) and "eye_diagram" in rec_t
    assert rt.last_eye[1] == rj.last_eye[1]
    np.testing.assert_allclose(np.array(rec_t["eye_diagram"]),
                               np.array(rec_j["eye_diagram"]),
                               rtol=0, atol=1e-5)
    last = rt.last_eye
    rt.push(np.zeros(rt.cfg.N // 2, np.complex64))    # no valid frame
    assert rt.last_eye is last
    assert "eye_diagram" not in receiver_stats_record(_port(mode))


def _s16_capture(tmp_path):
    """Three v2 packets as real s16 samples: real FSK (2 cos) plus real
    noise at 15 dB."""
    cfg = jfsk.FSKConfig(**GEOM["v2"])
    rng = np.random.default_rng(16)
    payloads, bits = [], [rng.integers(0, 2, 1000).astype(np.uint8)]
    for _ in range(3):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        payloads.append(p)
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode="v2"), "v2"))
        bits.append(rng.integers(0, 2, 300).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = jfsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs,
                             complex_out=False)
    sigma = np.sqrt(2.0 * cfg.Fs / cfg.Rs / 10 ** 1.5)
    x = sig + rng.normal(0, sigma, sig.shape)
    path = tmp_path / "cap.s16"
    np.round(x * 820).astype(np.int16).tofile(path)
    return path, payloads


def _s16_args(path, image_dir):
    return [str(path), "--format", "s16", "--mode", "v2", "--fs", "96000",
            "--rs", "9600", "--no-udp", "--image-dir", str(image_dir),
            "--chunk-seconds", "0.5"]


def _crc_ok(stderr):
    return int(stderr.strip().splitlines()[-1].split("crc_ok=")[1].split()[0])


def test_cli_s16_matches_jax(tmp_path, capsys):
    """--format s16 (real samples, converted on the host) gives the JAX
    CLI's crc_ok; both Receivers' decode_file(path, "s16") give the same
    payloads; the flags the JAX CLI takes parse."""
    from wenet_tpu.cli.rx import main as jax_rx_main
    path, payloads = _s16_capture(tmp_path)
    want = JaxReceiver(mode="v2", cfg=jfsk.FSKConfig(**GEOM["v2"])
                       ).decode_file(str(path), "s16")
    got = _port("v2").decode_file(str(path), "s16")
    assert got == want == payloads
    assert jax_rx_main(_s16_args(path, tmp_path / "jax")) == 0
    crc_jax = _crc_ok(capsys.readouterr().err)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "wenet_tpu_torch", "rx",
         *_s16_args(path, tmp_path / "port"), "--device", "cpu",
         "--partialupdate", "5", "--headless", "--throttle",
         "--channel-select", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert _crc_ok(proc.stderr) == crc_jax == len(want)


def test_receiver_rejects_s16_input():
    with pytest.raises(ValueError):
        _port("v2", input_format="s16")
