"""The port's flight side against the JAX package's on the same inputs
(CPU): the UBX codec and GPS reader, the simulated GPS, the camera's SSDV
pipeline, the payload-LED utility, the flight composition (GPS fixes,
telemetry and an SSDV image through PacketTX into an IQRadio) and the
`flight` CLI.

Exact: UBX records, frames and UBloxGPS state, GPS states, SSDV bytes,
packet frames, clock-setter commands.  The IQ is held within the fsk_mod
tolerance of tests/test_torch_probe.py::test_fsk_mod_matches_jax.  The
JPEGs are made with Pillow, which this machine has.
"""
import os
import queue
import threading
import time

import numpy as np
import pytest

from wenet_tpu.cli import flight as jflight
from wenet_tpu.tx import PacketTX as JPacketTX
from wenet_tpu.tx import camera as jcamera
from wenet_tpu.tx import gps as jgps
from wenet_tpu.tx import packet_tx as jpacket_tx
from wenet_tpu.tx import pi_utils as jpi
from wenet_tpu.tx import radios as jradios
from wenet_tpu.tx import ubx as jubx
from wenet_tpu_torch.cli import flight as tflight
from wenet_tpu_torch.tx import PacketTX
from wenet_tpu_torch.tx import camera as tcamera
from wenet_tpu_torch.tx import gps as tgps
from wenet_tpu_torch.tx import packet_tx as tpacket_tx
from wenet_tpu_torch.tx import pi_utils as tpi
from wenet_tpu_torch.tx import radios as tradios
from wenet_tpu_torch.tx import ubx as tubx

PIL = pytest.importorskip("PIL.Image")

WAIT = 10.0
FSK_MOD_ATOL = 2e-4            # tests/test_torch_probe.py fsk_mod tolerance
FIX = {"week": 2345, "iTOW": 302400.5, "leapS": 18,
       "latitude": -34.92850, "longitude": 138.60074, "altitude": 31245.5,
       "ground_speed": 62.3, "heading": 271.75, "ascent_rate": 5.25,
       "numSV": 12, "gpsFix": 3}
ORIENTATION = {"sys_status": 1, "sys_error": 0, "sys_cal": 3, "gyro_cal": 3,
               "accel_cal": 2, "magnet_cal": 1, "temp": -12,
               "euler_heading": 0.5, "euler_roll": -0.25, "euler_pitch": 0.125,
               "quaternion_x": 0.1, "quaternion_y": 0.2, "quaternion_z": -0.3,
               "quaternion_w": 0.9}


def _jpeg_file(path, w=200, h=150, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 10 + 1, w // 10 + 1, 3), np.uint8)
    arr = np.kron(base, np.ones((10, 10, 1), np.uint8))[:h, :w]
    PIL.fromarray(arr).save(path, "JPEG", quality=85)
    return str(path)


# ---------------------------------------------------------------------- UBX

def _ubx_stream():
    """Fix bursts, config frames, garbage, a broken checksum and a false
    sync."""
    states = [dict(FIX, iTOW=FIX["iTOW"] + i, altitude=1000.0 * i,
                   ascent_rate=-3.5 * i) for i in range(3)]
    bad = bytearray(jubx.frame(0x01, 0x02, b"\x00" * 28))
    bad[-1] ^= 0xFF
    return (b"\xffJUNK\xb5" + jubx.nav_frames(states[0]) + bytes(bad)
            + b"\x00\xb5\x00" + jubx.pack_cfg_nav5(6)
            + jubx.nav_frames(states[1]) + jubx.frame(0x05, 0x01, b"\x06\x24")
            + jubx.nav_frames(states[2]) + b"\xb5")


@pytest.mark.parametrize("step", [1, 17, 4096], ids=["bytewise", "17", "all"])
def test_ubx_parser_matches(step):
    """The same bytes, fed in pieces of any size, give the same records,
    the same count of bad checksums and the same held tail."""
    data = _ubx_stream()
    out = []
    for mod in (jubx, tubx):
        p = mod.UBXParser()
        recs = []
        for i in range(0, len(data), step):
            recs += p.feed(data[i:i + step])
        out.append((recs, p.bad_checksums, bytes(p._buf)))
    assert out[0] == out[1]
    assert len(out[1][0]) == 14 and out[1][1] >= 1


def test_ubx_packing_matches():
    """checksum, frame, every pack_* and nav_frames give the same bytes;
    the constants and layouts are equal."""
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 52, 300):
        body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tubx.checksum(body) == jubx.checksum(body)
        assert tubx.frame(0x06, 0x24, body) == jubx.frame(0x06, 0x24, body)
    for i in range(5):
        st = dict(FIX, iTOW=float(rng.uniform(0, 604800)),
                  latitude=float(rng.uniform(-90, 90)),
                  longitude=float(rng.uniform(-180, 180)),
                  altitude=float(rng.uniform(0, 40000)),
                  ascent_rate=float(rng.uniform(-30, 10)),
                  heading=float(rng.uniform(0, 360)), numSV=i)
        assert tubx.nav_frames(st) == jubx.nav_frames(st)
    for args, name in (((1000, 2345, 3, 9), "pack_nav_sol"),
                       ((1000, -34.9, 138.6, 123.4), "pack_nav_posllh"),
                       ((1000, 55.5, 271.75, -4.25), "pack_nav_velned"),
                       ((1000, 2345, 18), "pack_nav_timegps"),
                       ((6,), "pack_cfg_nav5")):
        assert getattr(tubx, name)(*args) == getattr(jubx, name)(*args)
    for name in ("SYNC1", "SYNC2", "CLASS_NAV", "CLASS_CFG", "CLASS_ACK",
                 "MSG_NAV_POSLLH", "MSG_NAV_SOL", "MSG_NAV_VELNED",
                 "MSG_NAV_TIMEGPS", "MSG_CFG_MSG", "MSG_CFG_RATE",
                 "MSG_CFG_NAV5", "DYNAMIC_MODEL_PORTABLE",
                 "DYNAMIC_MODEL_AIRBORNE1G"):
        assert getattr(tubx, name) == getattr(jubx, name), name
    for name in ("_NAV_SOL", "_NAV_POSLLH", "_NAV_VELNED", "_NAV_TIMEGPS",
                 "_CFG_RATE", "_CFG_MSG", "_CFG_NAV5"):
        assert getattr(tubx, name).format == getattr(jubx, name).format


class _Pipe:
    """In-memory duplex transport: reads from a queue, writes captured."""

    def __init__(self):
        self.rx: queue.Queue = queue.Queue()
        self.tx = bytearray()

    def write(self, data):
        self.tx.extend(data)

    def read(self, n):
        try:
            return self.rx.get(timeout=0.05)
        except queue.Empty:
            return b""


def _drive_ubx(mod, tmp_path):
    """A UBloxGPS thread over a pipe fed fragmented fix bursts of the same
    simulated flight; its config frames, fixes, log, time stamps (a
    time_sync that fails once) and debug messages."""
    pipe, fixes, stamps, msgs = _Pipe(), [], [], []

    def sync(ts):
        if not stamps:
            stamps.append(None)
            raise RuntimeError("shm gone")
        stamps.append(ts)
    log = tmp_path / f"{mod.__name__}.jsonl"
    gps = mod.UBloxGPS(transport=pipe, callback=fixes.append,
                       update_rate_ms=250, debug_ptr=msgs.append,
                       log_file=str(log), time_sync=sync)
    sim = tgps.SimulatedGPS(rate=2.0, burst_alt=12.0, realtime=False)
    gps.start()
    try:
        for _ in range(6):
            raw = mod.nav_frames(sim.step())
            for j in range(0, len(raw), 17):
                pipe.rx.put(raw[j:j + 17])
        pipe.rx.put(mod.pack_cfg_nav5(4))
        deadline = time.time() + WAIT
        while (len(fixes) < 6 or gps.read_state()["dynamic_model"] != 4) \
                and time.time() < deadline:
            time.sleep(0.01)
    finally:
        gps.close()
    return (bytes(pipe.tx), fixes, gps.read_state(), gps.fix_count,
            log.read_text(), stamps, msgs, gps.parser.bad_checksums)


def test_ubx_gps_over_a_pipe_matches(tmp_path):
    """UBloxGPS: the same configuration frames, the same state after
    every fix (reference scalings, UTC time stamps), the same fix log,
    time_sync calls on whole seconds only (a failing one contained) and
    the same debug messages."""
    got, want = _drive_ubx(tubx, tmp_path), _drive_ubx(jubx, tmp_path)
    assert got == want
    assert len(got[1]) == 6 and got[2]["dynamic_model"] == 4
    assert got[5][0] is None and len(got[5]) == 3
    assert any("time_sync failed" in m for m in got[6])


def test_ubx_handles_the_same_messages_alike():
    """handle() on a null transport: short and unknown payloads are
    ignored alike, CFG-NAV5 reports the dynamic model."""
    class Null:
        def write(self, data):
            pass

        def read(self, n):
            return b""
    states = []
    for mod in (jubx, tubx):
        gps = mod.UBloxGPS(transport=Null())
        for cls, mid, payload in ((0x01, 0x06, b"\x00" * 10),
                                  (0x02, 0x10, b"\x01"),
                                  (0x06, 0x24, b"\x00\x00\x07"),
                                  (0x01, 0x02, b"\x00" * 28)):
            gps.handle(cls, mid, payload)
        assert gps.rx_once() == 0
        states.append((gps.read_state(), gps.fix_count))
        gps.close()
    assert states[0] == states[1] and states[1][0]["dynamic_model"] == 7


# ---------------------------------------------------------------------- GPS

@pytest.mark.parametrize("kw", [{}, dict(rate=4.0, ascent_rate=10.0,
                                         burst_alt=200.0, ground_speed=12.0,
                                         lat=51.5, lon=-0.12)],
                         ids=["default", "burst"])
def test_simulated_gps_matches(kw):
    """SimulatedGPS: the same state sequence (ascent, burst, descent,
    landing) and the same callbacks; the constants are equal."""
    out = []
    for mod in (jgps, tgps):
        calls = []
        sim = mod.SimulatedGPS(callback=calls.append, realtime=False, **kw)
        states = [dict(sim.state)] + [dict(sim.step()) for _ in range(250)]
        out.append((states, calls))
    assert out[0] == out[1]
    if kw:
        alts = [s["altitude"] for s in out[1][0]]
        assert 190.0 < max(alts) <= 200.0 and alts[-1] == 0.0
        assert out[1][0][-1]["ascent_rate"] == 0.0
    assert tgps.GPS_FIX_3D == jgps.GPS_FIX_3D == 3
    assert tgps.DYNAMIC_MODEL_AIRBORNE1G == jgps.DYNAMIC_MODEL_AIRBORNE1G
    for mod in (jgps, tgps):
        with pytest.raises(RuntimeError, match="pyserial"):
            mod.UBloxGPS()


# ------------------------------------------------------------------- camera

def test_camera_matches(tmp_path):
    """FileCamera captures, capture_best, SSDVCamera.ssdvify (with an
    overlay and without) give the same files and SSDV bytes; a file that
    is no image gives None in both."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        _jpeg_file(src / f"{i}.jpg", seed=i)
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    out = {}
    for mod in (jcamera, tcamera):
        d = tmp_path / mod.__name__
        d.mkdir()
        cam = mod.FileCamera(str(src), loop=False)
        shots = []
        for i in range(3):
            dest = d / f"shot{i}.jpg"
            shots.append(cam.capture(str(dest)) and dest.read_bytes())
        ssdv_cam = mod.SSDVCamera(
            mod.FileCamera(str(src)), callsign="VK5QI", tx_resolution=(96, 64),
            num_images=2, temp_filename_prefix=str(d / "tmp"), quality=5)
        best = ssdv_cam.capture_best(str(d / "best.jpg"))
        ssdv = []
        for overlay in (None, lambda img: img.transpose(0)):
            ssdv_cam.overlay_fn = overlay
            with open(ssdv_cam.ssdvify(str(d / "best.jpg")), "rb") as fh:
                ssdv.append(fh.read())
        bad = ssdv_cam.ssdvify(str(tmp_path / "bad.jpg"))
        out[mod] = (shots, best, *ssdv, bad, ssdv_cam.image_id,
                    cam.get_metadata())
        with pytest.raises(FileNotFoundError):
            mod.FileCamera(str(tmp_path / "empty"))
    assert out[tcamera] == out[jcamera]
    shots, best, plain, flipped, bad, image_id, meta = out[tcamera]
    assert shots[2] is False and best and bad is None and image_id == 2
    assert len(plain) % 256 == 0 and plain != flipped and meta == {}


def test_camera_capture_loop_matches(tmp_path):
    """SSDVCamera.run: the loop captures, SSDV-encodes, waits for the TX
    queue and queues each image, calling the telemetry hook, as the JAX
    loop does (the same SSDV bytes for the first images)."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        _jpeg_file(src / f"{i}.jpg", seed=5 + i)

    class Tx:
        def __init__(self):
            self.files, self.lock = [], threading.Lock()

        def image_queue_empty(self):
            return True

        def queue_image_file(self, path):
            with open(path, "rb") as fh:
                self.files.append(fh.read())

    out = {}
    for mod in (jcamera, tcamera):
        d = tmp_path / mod.__name__
        tx, ids, posts = Tx(), [], []
        cam = mod.SSDVCamera(mod.FileCamera(str(src)), callsign="VK5QI",
                             tx_resolution=(64, 48),
                             temp_filename_prefix=str(tmp_path / "t"),
                             telemetry_cb=ids.append)
        cam.run(str(d), tx, post_process_ptr=posts.append, start_id=250)
        deadline = time.time() + WAIT
        while len(tx.files) < 3 and time.time() < deadline:
            time.sleep(0.01)
        cam.stop()
        out[mod] = (tx.files[:3], ids[:3], len(posts) >= 3)
    assert out[tcamera] == out[jcamera]
    assert out[tcamera][1] == [250, 251, 252]


# ----------------------------------------------------------------- pi_utils

def test_kill_payload_leds_matches():
    class Channel:
        duty_cycle = 0

    class PCA:
        def __init__(self):
            self.channels = [Channel() for _ in range(16)]
            self.frequency = 0

    out = []
    for mod in (jpi, tpi):
        pca = PCA()
        assert mod.kill_payload_leds(pca=pca, channels=range(3, 12))
        out.append((pca.frequency, [c.duty_cycle for c in pca.channels]))
    assert out[0] == out[1] and out[1][1][3:12] == [0xFFFF] * 9
    assert (tpi.PCA9685_ADDRESS, list(tpi.LED_CHANNELS), tpi.LED_OFF) == \
        (jpi.PCA9685_ADDRESS, list(jpi.LED_CHANNELS), jpi.LED_OFF)


# ------------------------------------------------------ flight composition

def _pin_host(monkeypatch):
    """Freeze the clock and the host readings a GPS packet carries."""
    for mod in (jpacket_tx, tpacket_tx):
        monkeypatch.setattr(mod, "get_cpu_temperature", lambda: 45.5)
        monkeypatch.setattr(mod, "get_cpu_speed", lambda: 1200.0)

    def no_load():
        raise OSError("pinned")
    monkeypatch.setattr(os, "getloadavg", no_load)
    monkeypatch.setattr(time, "time", lambda: 1.75e9)


def _fly(radios_mod, tx_cls, gps_mod, camera_mod, ssdv_file, tmp_path):
    from wenet_tpu_torch.ops import fsk
    chunks, frames = [], []
    radio = radios_mod.IQRadio(chunks.append,
                               cfg=fsk.FSKConfig(Fs=96000, Rs=9600),
                               mode="v2")
    tx = tx_cls(radio, callsign="VK5QI")
    sim = gps_mod.SimulatedGPS(realtime=False)
    cam = camera_mod.FileCamera(str(tmp_path / "src"))
    radio.transmit_packet(tx.idle_message)
    for i in range(3):
        state = sim.step()
        tx.transmit_gps_telemetry(state, dict(cam.get_metadata(),
                                              LensPosition=1.5 * i))
        tx.transmit_image_telemetry(state, ORIENTATION, image_id=i)
        tx.transmit_text_message(f"flight {i}")
    assert tx.queue_image_file(ssdv_file)
    while not (tx.telemetry_queue_empty() and tx.image_queue_empty()):
        q = tx.telemetry_queue if tx.telemetry_queue.qsize() else tx.ssdv_queue
        frames.append(q.get_nowait())
        radio.transmit_packet(frames[-1])
    radio.transmit_packet(tx.idle_message)
    return frames, np.concatenate(chunks)


def test_flight_composition_matches(tmp_path, monkeypatch):
    """SimulatedGPS fixes, image telemetry, texts and one SSDV image (the
    camera's, from a Pillow JPEG) through PacketTX into an IQRadio: the
    frames are byte-equal and the IQ is within the fsk_mod tolerance, with
    the clock and the host readings frozen in both."""
    _pin_host(monkeypatch)
    (tmp_path / "src").mkdir()
    jpg = _jpeg_file(tmp_path / "src" / "a.jpg", 160, 128)
    cam = tcamera.SSDVCamera(tcamera.FileCamera(str(tmp_path / "src")),
                             callsign="VK5QI", tx_resolution=(160, 128))
    ssdv_file = cam.ssdvify(jpg)
    got = _fly(tradios, PacketTX, tgps, tcamera, ssdv_file, tmp_path)
    want = _fly(jradios, JPacketTX, jgps, jcamera, ssdv_file, tmp_path)
    assert got[0] == want[0] and len(got[0]) > 9 + 3
    assert got[1].dtype == want[1].dtype == np.complex64
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=FSK_MOD_ATOL)


# -------------------------------------------------------------- flight CLI

def test_flight_cli_runs(tmp_path, monkeypatch, capsys):
    """`flight` runs to rc 0 on the simulated GPS and the file camera,
    writing a c64 capture of several packets and its SSDV images under
    ./tx_images of the working directory."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "imgs").mkdir()
    _jpeg_file(tmp_path / "imgs" / "a.jpg", 96, 64)
    out = tmp_path / "flight.c64"
    rc = tflight.main(["--images-dir", str(tmp_path / "imgs"),
                       "--out", str(out), "--fs", "96000", "--rs", "9600",
                       "--duration", "2", "--gps-rate", "4",
                       "--tx-resolution", "96x64"])
    assert rc == 0
    assert out.stat().st_size > 100000
    assert any(f.endswith(".ssdv") for f in os.listdir(tmp_path / "tx_images"))
    assert "packets transmitted" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--mode", "v2", "--out", "serial:/dev/null"],
    ["--mode", "v1", "--out", "alsa:hw:0"]], ids=["serial", "alsa"])
def test_flight_cli_rejects_a_transport_of_the_other_mode(argv, tmp_path,
                                                          capsys):
    codes = []
    for mod in (jflight, tflight):
        with pytest.raises(SystemExit) as e:
            mod.main(["--images-dir", str(tmp_path), *argv])
        codes.append((e.value.code, capsys.readouterr().err.splitlines()[-1]))
    assert codes[0][0] == 2 and codes[0][1].split(": ", 1)[1] == \
        codes[1][1].split(": ", 1)[1]


@pytest.mark.parametrize("rc", [0, 1], ids=["set", "failed"])
def test_system_clock_setter_matches(rc):
    """SystemClockSetter: the first 3D fix runs the same timedatectl
    commands and downlinks the same debug texts, once."""
    out = []
    for mod in (jflight, tflight):
        ran, texts = [], []
        setter = mod.SystemClockSetter(
            debug_ptr=texts.append, runner=lambda cmd: ran.append(cmd) or rc)
        setter.on_fix(dict(FIX, gpsFix=2))
        setter.on_fix(dict(FIX, iTOW=302400.0))
        setter.on_fix(dict(FIX, iTOW=302460.0))
        broken = mod.SystemClockSetter(debug_ptr=texts.append,
                                       runner=lambda cmd: 0)
        broken.on_fix({"gpsFix": 3})                    # no week: fails
        out.append((ran, texts))
    assert out[0] == out[1] and len(out[1][0]) == 2
    assert out[1][1][-1] == "GPS Debug: Attempt to set system clock failed!"
