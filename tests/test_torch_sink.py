"""The port's copy of the payload sink (`rx/router`, `rx/stats`,
`core/packets`, `ssdv/`) against the JAX package's: the same payload stream,
made from a numpy seed, writes byte-identical files, and the codecs and
decoders give equal results on the same bytes."""
import datetime
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from wenet_tpu import ssdv as jssdv
from wenet_tpu.core import packets as jpackets
from wenet_tpu.rx import router as jrouter
from wenet_tpu.rx import stats as jstats
from wenet_tpu.ssdv import rs as jrs
from wenet_tpu_torch import ssdv as tssdv
from wenet_tpu_torch.core import packets as tpackets
from wenet_tpu_torch.rx import router as trouter
from wenet_tpu_torch.rx import stats as tstats
from wenet_tpu_torch.ssdv import rs as trs

FIXED_NOW = datetime.datetime(2026, 1, 2, 3, 4, 5,
                              tzinfo=datetime.timezone.utc)


def make_jpeg(w=320, h=240, seed=0, quality=80, mode="RGB"):
    """The source JPEG of tests/test_ssdv.py."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w)[None, :] + np.linspace(0, 100, h)[:, None]
    g = (x + rng.normal(0, 10, (h, w))).clip(0, 255).astype(np.uint8)
    if mode == "L":
        img = Image.fromarray(g, "L")
    else:
        img = Image.fromarray(np.stack([g, g[::-1], np.roll(g, 20, 1)], -1))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _gps(rng):
    return {"week": 2300, "iTOW": float(rng.integers(0, 604800)),
            "leapS": 18, "latitude": float(rng.uniform(-90, 90)),
            "longitude": float(rng.uniform(-180, 180)),
            "altitude": float(rng.uniform(0, 35000)),
            "ground_speed": float(rng.uniform(0, 50)),
            "heading": float(rng.uniform(0, 360)),
            "ascent_rate": float(rng.uniform(-5, 5)),
            "numSV": int(rng.integers(0, 16)), "gpsFix": int(rng.integers(0, 6)),
            "dynamic_model": int(rng.integers(0, 9))}


def _orientation(rng):
    o = {k: int(rng.integers(0, 4)) for k in
         ("sys_status", "sys_error", "sys_cal", "gyro_cal", "accel_cal",
          "magnet_cal")}
    o["temp"] = int(rng.integers(-40, 40))
    for k in ("euler_heading", "euler_roll", "euler_pitch", "quaternion_x",
              "quaternion_y", "quaternion_z", "quaternion_w"):
        o[k] = float(rng.uniform(-1, 1))
    return o


def _telemetry(rng, count):
    """Text, GPS, orientation, image and secondary-payload packets, each
    padded to 256 bytes as the receiver hands them on."""
    gps, ori = _gps(rng), _orientation(rng)
    pkts = [
        jpackets.encode_text_message(f"sink {count}", count),
        jpackets.encode_gps_telemetry(gps),
        jpackets.encode_orientation_telemetry(2300, 1234.5, 18, ori),
        jpackets.encode_image_telemetry(gps, ori, image_id=count % 256,
                                        callsign="VK5QI", count=count),
        jpackets.encode_sec_payload(count, rng.integers(
            0, 256, 20, dtype=np.uint8).tobytes()),
    ]
    return [p + b"\x55" * (256 - len(p)) for p in pkts]


def _stream(seed, fec):
    """Two SSDV images with telemetry between their packets, an idle packet
    and a packet of an unknown type."""
    rng = np.random.default_rng(seed)
    stream = []
    for image_id in (3, 4):
        jpg = make_jpeg(160, 128, seed=seed + image_id)
        ssdv_pkts = jssdv.encode(jpg, "VK5QI", image_id, fec=fec)
        for i, p in enumerate(ssdv_pkts):
            stream.append(p)
            if i % 4 == 0:
                stream += _telemetry(rng, len(stream))
    stream.append(b"\x56" + b"\x55" * 255)                  # idle
    stream.append(b"\x7f" + bytes(255))                     # unknown type
    return stream


def _route(mod, stream, out, partial_update, monkeypatch):
    monkeypatch.setattr(mod, "_utcnow", lambda: FIXED_NOW)
    images, telem = [], []
    r = mod.PacketRouter(
        image_dir=str(out / "img"), log_dir=str(out / "log"),
        partial_update=partial_update,
        emitter=mod.UDPEmitter(enabled=False),
        callbacks={"image": lambda p, i: images.append(
                       (os.path.relpath(p, out), i)),
                   "telemetry": lambda t, d: telem.append((t, d))})
    for p in stream:
        r.handle_packet(p)
    r.flush()
    files = {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, out)] = f.read()
    return files, images, telem, (r.images_decoded, r.packets_seen)


@pytest.mark.parametrize("seed,fec,partial_update", [
    (0, False, 0), (1, False, 5), (2, True, 0), (3, True, 7)])
def test_router_writes_the_same_bytes(tmp_path, monkeypatch, seed, fec,
                                      partial_update):
    stream = _stream(seed, fec)
    jax_out = _route(jrouter, stream, tmp_path / "jax", partial_update,
                     monkeypatch)
    port_out = _route(trouter, stream, tmp_path / "port", partial_update,
                      monkeypatch)
    files, images, telem, counts = port_out
    assert counts == jax_out[3] and counts[0] == 2
    assert sorted(files) == sorted(jax_out[0])
    assert any(k.endswith(".jpg") for k in files)
    assert any(k.endswith("_gps.log") for k in files)
    for name in files:
        assert files[name] == jax_out[0][name], name
    assert images == jax_out[1]
    assert repr(telem) == repr(jax_out[2])


@pytest.mark.parametrize("w,h,mode,quality,fec", [
    (320, 240, "RGB", 6, False), (160, 128, "RGB", 4, True),
    (160, 128, "L", 6, False), (64, 48, "RGB", 7, False),
    (176, 144, "L", 2, True)])
def test_ssdv_codec_matches(w, h, mode, quality, fec):
    jpg = make_jpeg(w, h, seed=w + h, mode=mode)
    want = jssdv.encode(jpg, "VK5QI", 9, quality=quality, fec=fec)
    got = tssdv.encode(jpg, "VK5QI", 9, quality=quality, fec=fec)
    assert got == want
    assert tssdv.decode(got) == jssdv.decode(want)
    for p in got[:3] + got[-1:]:
        assert tssdv.packet_info(p) == jssdv.packet_info(p)


def test_ssdv_file_codec_matches(tmp_path):
    jpg = make_jpeg(160, 128, seed=11)
    (tmp_path / "in.jpg").write_bytes(jpg)
    for name, mod in (("jax", jssdv), ("port", tssdv)):
        assert mod.encode_file(str(tmp_path / "in.jpg"),
                               str(tmp_path / f"{name}.bin"), "VK5QI", 5)
        assert mod.decode_file(str(tmp_path / f"{name}.bin"),
                               str(tmp_path / f"{name}.jpg"))
    for ext in ("bin", "jpg"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes())


def test_reed_solomon_matches():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, jrs.KK, dtype=np.uint8).tobytes()
    cw = data + jrs.encode(data)
    assert trs.encode(data) == jrs.encode(data)
    bad = bytearray(cw)
    for pos in rng.choice(255, 9, replace=False):
        bad[pos] ^= int(rng.integers(1, 256))
    assert trs.correct(bytes(bad)) == jrs.correct(bytes(bad))
    assert trs.check(cw) == jrs.check(cw)


DECODERS = ["decode_packet_type", "packet_to_string", "decode_text_message",
            "gps_telemetry_decoder", "orientation_telemetry_decoder",
            "image_telemetry_decoder", "sec_payload_decode",
            "ssdv_packet_info", "ssdv_packet_string"]


@pytest.mark.parametrize("name", DECODERS)
def test_packet_decoders_match(name):
    """Every decoder of the port's core.packets equals the JAX package's on
    every packet of a stream, including short and corrupt ones."""
    stream = _stream(5, False)[:40]
    stream += [p[:10] for p in stream[:12]] + [b"\x01", b"\x54" + bytes(3)]
    for p in stream:        # repr: a float field of foreign bytes may be nan
        assert (repr(getattr(tpackets, name)(p))
                == repr(getattr(jpackets, name)(p)))


def test_packet_encoders_match():
    rng = np.random.default_rng(12)
    gps, ori = _gps(rng), _orientation(rng)
    pairs = [
        (lambda m: m.encode_text_message("x" * 300, 65535)),
        (lambda m: m.encode_gps_telemetry(gps)),
        (lambda m: m.encode_orientation_telemetry(2300, 99.25, 18, ori)),
        (lambda m: m.encode_image_telemetry(gps, ori, 9, "VK5QI", 77)),
        (lambda m: m.encode_sec_payload(300, b"abc" * 100)),
        (lambda m: m.ssdv_encode_callsign("VK5QI")),
        (lambda m: m.ssdv_decode_callsign(m.ssdv_encode_callsign("N0CALL"))),
        (lambda m: m.image_telemetry_habitat_string(
            m.encode_image_telemetry(gps, ori, 9, "VK5QI", 77))),
        (lambda m: m.crc16_ccitt_hex(b"wenet")),
        (lambda m: m.gps_weeksecondstoutc(2300, 12345.5, 18)),
    ]
    for f in pairs:
        assert f(tpackets) == f(jpackets)


def _stats_records(rng, n):
    recs = []
    for i in range(n):
        recs.append({"secs": i, "EbNodB": float(rng.normal(8, 2)),
                     "ppm": int(rng.integers(-20, 20)),
                     "f1_est": float(rng.uniform(1000, 20000)),
                     "f2_est": float(rng.uniform(20000, 40000)),
                     "samp_fft": [float(x) for x in rng.uniform(0, 1, 16)]})
    return recs


@pytest.mark.parametrize("peak_hold", [False, True])
def test_stats_to_wire_matches(monkeypatch, peak_hold):
    """FSKDemodStats: the same records (dicts, JSON strings with nan, bad
    input) give the same MODEM_STATS message; the clock is frozen so the
    averaging window and the time stamp agree."""
    monkeypatch.setattr(jstats.time, "time", lambda: 1000.0)
    recs = _stats_records(np.random.default_rng(3), 6)
    recs.append(json.dumps(recs[0]).replace("8", "nan", 1))
    recs += ["{not json", {"EbNodB": 1.0}, 17]
    accs = [m.FSKDemodStats(averaging_time=2.0, peak_hold=peak_hold,
                            sample_rate=96000.0) for m in (jstats, tstats)]
    for rec in recs:
        for acc in accs:
            acc.update(rec)
        a, b = (acc.to_wire() for acc in accs)
        assert a.pop("time")[:10] == b.pop("time")[:10]
        assert a == b
    assert tstats.FSK_STATS_FIELDS == jstats.FSK_STATS_FIELDS
    from wenet_tpu_torch.rx import pipeline
    assert tstats.receiver_stats_record is pipeline.receiver_stats_record
