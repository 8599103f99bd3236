"""The port's ground-station deploy files (wenet_tpu_torch/deploy/) against
the JAX package's (deploy/): the scripts parse; start_rx.sh, fed by a fake
rtl_sdr, tunes by the reference's formula and its receiver decodes the
payloads the JAX Receiver decodes from the same bytes, at the scaled v2
and v1 geometries on the CPU; and every launch line runs the port with the
JAX line's flags (plus --device where the receiver runs).  Docker and
systemd are not run: their files are only read."""
import functools
import os
import re
import stat
import subprocess

import numpy as np
import pytest

from wenet_tpu import ssdv as jssdv
from wenet_tpu.core import framing
from wenet_tpu.ops import channel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc
from wenet_tpu.rx.pipeline import Receiver as JaxReceiver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "wenet_tpu_torch", "deploy")
JAX = os.path.join(ROOT, "deploy")
FILES = ("start_rx.sh", "start_tx.sh", "start_docker.sh", "Dockerfile",
         "wenet_rx.service", "wenet_tx.service")
SCRIPTS = [f for f in FILES if f.endswith(".sh")]
# (mode, start_rx.sh environment): the reference tests' scaled geometries
GEOMETRIES = {
    "v2": {"BAUD_RATE": "9600", "OVERSAMPLING": "10"},
    "v1": {"FRAMING_MODE": "v1", "BAUD_RATE": "11500", "OVERSAMPLING": "8"},
}


def _jpeg():
    """A small 4:2:0 JPEG of random low-order coefficients (the port's own
    writer)."""
    from wenet_tpu_torch.ssdv import codec
    from wenet_tpu_torch.ssdv import jpeg as J
    rng = np.random.default_rng(3)
    lum, chroma = codec.quant_tables(6)
    mcus = np.zeros((12, 6, 64), np.int32)
    mcus[:, :, 0] = rng.integers(-40, 40, (12, 6))
    mcus[:, :, 1:10] = rng.integers(-6, 7, (12, 6, 9))
    comps = [J.Component(1, 2, 2, 0), J.Component(2, 1, 1, 1),
             J.Component(3, 1, 1, 1)]
    return J.write_jpeg(J.JpegImage(64, 48, comps, {0: lum, 1: chroma}, mcus))


@functools.lru_cache(maxsize=None)
def _capture(mode):
    """(cu8 bytes, SSDV packets sent): one image's SSDV packets between
    idle bits at 12 dB.  SSDV only: the router broadcasts telemetry
    packets on the LAN, while image packets go to files and localhost."""
    env = GEOMETRIES[mode]
    rs = int(env["BAUD_RATE"])
    cfg = jfsk.FSKConfig(Fs=rs * int(env["OVERSAMPLING"]), Rs=rs)
    pkts = jssdv.encode(_jpeg(), "VK5QI", 5, 6)
    rng = np.random.default_rng(40 + len(pkts))
    bits = [rng.integers(0, 2, 1000).astype(np.uint8)]
    for p in pkts:
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        bits.append(rng.integers(0, 2, 300).astype(np.uint8))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % cfg.Nbits, np.uint8)])
    sig, _ = jfsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig, 12.0, cfg.Fs, cfg.Rs, rng=rng)
    return jfsk.iq_to_cu8(iq), pkts


def _tuning(rxfreq, baud, oversampling):
    """The reference's tuning offset, start_rx.sh:103-108."""
    return int(rxfreq - baud * (oversampling / 4.0 - 0.25))


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_parse(name):
    for d in (PORT, JAX):
        out = subprocess.run(["bash", "-n", os.path.join(d, name)],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stderr
    assert os.stat(os.path.join(PORT, name)).st_mode & stat.S_IXUSR


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_start_rx_decodes_like_jax(mode, tmp_path):
    """start_rx.sh with a fake rtl_sdr on PATH that records its argv and
    writes a cu8 capture: exit 0, rtl_sdr asked for Fs and the tuning
    formula's frequency, and the router's record of the payloads (the
    image's .bin holds the SSDV packets as received, the .jpg their
    decode) equal to the JAX Receiver's on the same bytes."""
    raw, pkts = _capture(mode)
    env_geom = GEOMETRIES[mode]
    cfg = jfsk.FSKConfig(Fs=int(env_geom["BAUD_RATE"])
                         * int(env_geom["OVERSAMPLING"]),
                         Rs=int(env_geom["BAUD_RATE"]))
    jrx = JaxReceiver(mode=mode, cfg=cfg, input_format="cu8")
    step = 2 * int(cfg.Fs * 2.0)          # the CLI's 2-s chunks of bytes
    want = []
    for i in range(0, len(raw), step):
        want += jrx.push(raw[i:i + step])
    want += jrx.flush()
    assert want == pkts

    cap = tmp_path / "capture.cu8"
    raw.tofile(cap)
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "rtl_sdr").write_text(
        '#!/bin/sh\nprintf "%s\\n" "$@" > "$FAKE_RTL_ARGV"\n'
        'exec cat "$FAKE_RTL_CAPTURE"\n')
    (fake / "rtl_sdr").chmod(0o755)
    img, logs = tmp_path / "img", tmp_path / "logs"
    env = dict(os.environ, PATH=f"{fake}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=ROOT, RX_DEVICE="cpu", HEADLESS="1",
               IMAGE_DIR=str(img), LOG_DIR=str(logs),
               FAKE_RTL_ARGV=str(tmp_path / "argv"),
               FAKE_RTL_CAPTURE=str(cap), **env_geom)
    for key in ("RXFREQ", "DEVICE", "GAIN", "BIAS", "RX_FLOW"):
        env.pop(key, None)
    out = subprocess.run(["bash", os.path.join(PORT, "start_rx.sh")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert f"crc_ok={len(pkts)} images=1" in out.stderr, out.stderr[-2000:]
    assert f"mode {mode}" in out.stderr
    argv = (tmp_path / "argv").read_text().split()
    assert argv == ["-d", "0", "-s", str(cfg.Fs), "-f",
                    str(_tuning(443500000, cfg.Rs, cfg.Fs // cfg.Rs)), "-"]
    bins = sorted(img.glob("*_VK5QI_5.bin"))
    jpgs = sorted(img.glob("*_VK5QI_5.jpg"))
    assert len(bins) == len(jpgs) == 1, sorted(os.listdir(img))
    assert bins[0].read_bytes() == b"".join(want)
    assert jpgs[0].read_bytes() == jssdv.decode(want)
    assert logs.is_dir() and not list(logs.iterdir())   # no telemetry


def _module_commands(text):
    """[(module, first argument, flags)] of every `python3 -m wenet_tpu...`
    command in a script or unit, comments dropped and continuation lines
    joined."""
    text = re.sub(r"^\s*#.*\n", "", text, flags=re.M)
    text = re.sub(r"\\\n\s*", " ", text)
    out = []
    for m in re.finditer(r"python3 -m (wenet_tpu\S*)([^|'\n]*)", text):
        args = m.group(2).split()
        out.append((m.group(1), args[0] if args else "",
                    [a for a in args if re.match(r"--?[a-zA-Z]", a)]))
    return out


@pytest.mark.parametrize("name", FILES)
def test_launch_lines_run_the_port(name):
    """Each file launches `wenet_tpu_torch`, never the JAX package, and
    installs no jax; each `python3 -m` line carries its deploy/
    counterpart's flags, plus --device on the receiver's lines (the flight
    side is host code and has no device)."""
    with open(os.path.join(PORT, name)) as fh:
        port = fh.read()
    with open(os.path.join(JAX, name)) as fh:
        ref = fh.read()
    # start_docker.sh launches the image the port's Dockerfile builds
    assert ("wenet-tpu-torch" if name == "start_docker.sh"
            else "wenet_tpu_torch") in port
    assert not re.search(r"(-m|COPY|import) wenet_tpu(?!_torch)\b", port)
    assert not re.search(r"\bjax\b", port, re.I)
    got, want = _module_commands(port), _module_commands(ref)
    assert len(got) == len(want)
    for (mod_p, cmd_p, flags_p), (mod_j, cmd_j, flags_j) in zip(got, want):
        assert mod_p == mod_j.replace("wenet_tpu", "wenet_tpu_torch", 1)
        assert cmd_p == cmd_j
        receiver = mod_p == "wenet_tpu_torch" and cmd_p == "rx"
        assert flags_p == flags_j + (["--device"] if receiver else []), (
            mod_p, flags_p, flags_j)
    if name == "Dockerfile":
        assert re.search(r"^FROM nvidia/cuda:\S+-devel-", port, re.M)
        copies = re.findall(r"^COPY (\S+)", port, re.M)
        assert copies == ["wenet_tpu_torch",
                          "wenet_tpu_torch/deploy/start_rx.sh"]
    if name == "start_docker.sh":
        assert "--gpus all" in port
    if name == "start_rx.sh":
        assert '--device "$RX_DEVICE"' in port
        assert 'RX_DEVICE="${RX_DEVICE:-cuda}"' in port
