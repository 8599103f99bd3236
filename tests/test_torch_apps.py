"""The port's ground-station apps and examples against the JAX package's on
the same inputs (CPU): the telemetry console, the web server (SSE events,
/latest.jpg, the Horus PAYLOAD_SUMMARY and SondeHub records), the SSDV
uploader, the GUI models and their terminal views, the link emulator
(ideal and through the port's receiver on the CPU), `rx_tester.feed`,
`sec_payload_rx.listen`, the modem-stats record's home in `rx.stats`, and
the `rx` CLI's read-ahead.

Exact throughout: console lines (less the time stamp), event and datagram
JSON, upload bodies (less the time of receipt), model state and status
lines, payload lists, router outputs.  Sockets are on localhost, on ports
the OS picks, and every wait has its own timeout.
"""
import glob
import http.client
import http.server
import io
import json
import os
import socket
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from wenet_tpu.examples import link_emulation as jlink
from wenet_tpu.examples import rx_tester as jrx_tester
from wenet_tpu.examples import sec_payload_rx as jsec
from wenet_tpu.rx import gui as jgui
from wenet_tpu.rx import telemetry_console as jconsole
from wenet_tpu.rx import uploader as juploader
from wenet_tpu.rx import web as jweb
from wenet_tpu_torch.cli import rx as cli_rx
from wenet_tpu_torch.core import framing
from wenet_tpu_torch.core import packets as wp
from wenet_tpu_torch.examples import link_emulation as tlink
from wenet_tpu_torch.examples import rx_tester as trx_tester
from wenet_tpu_torch.examples import sec_payload_rx as tsec
from wenet_tpu_torch.ops import fsk, ldpc
from wenet_tpu_torch.rx import gui as tgui
from wenet_tpu_torch.rx import stats as tstats
from wenet_tpu_torch.rx import telemetry_console as tconsole
from wenet_tpu_torch.rx import uploader as tuploader
from wenet_tpu_torch.rx import web as tweb

torch.set_num_threads(1)

WAIT = 10.0                    # seconds any one socket wait may take
GPS = {"week": 2345, "iTOW": 302400.5, "leapS": 18, "latitude": -34.9285,
       "longitude": 138.60074, "altitude": 21245.5, "ground_speed": 62.3,
       "heading": 271.75, "ascent_rate": 5.25, "numSV": 11, "gpsFix": 3,
       "dynamic_model": 6}
ORIENTATION = {"sys_status": 1, "sys_error": 0, "sys_cal": 3, "gyro_cal": 3,
               "accel_cal": 2, "magnet_cal": 1, "temp": -12,
               "euler_heading": 0.5, "euler_roll": -0.25, "euler_pitch": 0.125,
               "quaternion_x": 0.1, "quaternion_y": 0.2, "quaternion_z": -0.3,
               "quaternion_w": 0.9}


def _pad(p):
    return p + b"\x55" * (256 - len(p))


def _payloads():
    """One payload of every telemetry kind, an SSDV packet, an idle packet
    and one of an unknown type, padded as the receiver hands them on."""
    from wenet_tpu_torch import ssdv
    ssdv_pkt = ssdv.encode(_jpeg(), "VK5QI", 7)[0]
    return [_pad(p) for p in (
        wp.encode_text_message("hello ground", 5),
        wp.encode_gps_telemetry(GPS),
        wp.encode_orientation_telemetry(2345, 302400.5, 18, ORIENTATION),
        wp.encode_image_telemetry(GPS, ORIENTATION, image_id=7,
                                  callsign="VK5QI", count=3),
        wp.encode_sec_payload(9, bytes(range(20))),
        wp.encode_gps_telemetry(dict(GPS, altitude=21300.0, gpsFix=2)),
        b"\x56", b"\x7f")] + [ssdv_pkt]


def _jpeg(seed=0):
    """A 4:2:0 JPEG of random low-order coefficients, made by the port's
    own writer."""
    from wenet_tpu_torch.ssdv import codec
    from wenet_tpu_torch.ssdv import jpeg as J
    rng = np.random.default_rng(seed)
    lum, chroma = codec.quant_tables(6)
    mcus = np.zeros((20, 6, 64), np.int32)
    mcus[:, :, 0] = rng.integers(-40, 40, (20, 6))
    mcus[:, :, 1:10] = rng.integers(-6, 7, (20, 6, 9))
    comps = [J.Component(1, 2, 2, 0), J.Component(2, 1, 1, 1),
             J.Component(3, 1, 1, 1)]
    return J.write_jpeg(J.JpegImage(80, 64, comps, {0: lum, 1: chroma}, mcus))


def _wenet(payload):
    return json.dumps({"type": "WENET",
                       "packet": list(bytearray(payload))}).encode()


def _free_udp_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _udp_sink():
    """A UDP socket on a port the OS picks, bound to every address so that
    it takes the apps' broadcasts too."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("", 0))
    s.settimeout(WAIT)
    return s


def _send(port, datagrams):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for d in datagrams:
        s.sendto(d, ("127.0.0.1", port))
        time.sleep(0.01)
    s.close()


def _listen_both(targets, datagrams):
    """Run each listen(port=...) target in a thread on a port of its own,
    send the same datagrams to each, and wait for each to return."""
    ports = [_free_udp_port() for _ in targets]
    threads = [threading.Thread(target=fn, kwargs=dict(port=p), daemon=True)
               for fn, p in zip(targets, ports)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    for p in ports:
        _send(p, datagrams)
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a listener did not get its packets"


# ------------------------------------------------------------ rx.stats (F5)

def test_receiver_stats_record_lives_in_stats():
    """`rx.stats.receiver_stats_record` is the function `rx.pipeline`
    exports, and its record goes through FSKDemodStats.to_wire into the
    port's ModemStatsModel as into the JAX package's (eye included)."""
    from wenet_tpu_torch.rx import pipeline
    assert tstats.receiver_stats_record is pipeline.receiver_stats_record
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    bits = np.random.default_rng(0).integers(0, 2, cfg.Nbits * 30)
    sig, _ = fsk.fsk_mod_np(cfg, bits.astype(np.uint8), 19200, 9600)
    rx = pipeline.Receiver(mode="v2", cfg=cfg, with_eye=True, device="cpu")
    assert tstats.receiver_stats_record(rx) == {}
    rx.push((0.3 * sig).astype(np.complex64))
    rec = tstats.receiver_stats_record(rx)
    assert set(tstats.FSK_STATS_FIELDS) <= set(rec)
    assert len(rec["eye_diagram"]) == 8
    acc = tstats.FSKDemodStats(averaging_time=1.0, sample_rate=cfg.Fs)
    acc.update(rec)
    models = [jgui.ModemStatsModel(), tgui.ModemStatsModel()]
    for m in models:
        m.update(acc.to_wire() | rec)
    a, b = models
    assert a.snapshot() == b.snapshot() and b.snapshot()["eye_lines"] == 8
    np.testing.assert_array_equal(a.eye, b.eye)
    np.testing.assert_array_equal(a.spectrum, b.spectrum)


# ------------------------------------------------------------------ console

def test_telemetry_console_matches(tmp_path):
    """The same UDP JSON gives the same console lines and log file, less
    the time stamp; non-WENET datagrams and bad JSON are skipped alike."""
    payloads = [p for p in _payloads() if p[0] != 0x56]
    datagrams = [b"{not json", json.dumps({"type": "OTHER"}).encode()]
    datagrams += [_wenet(p) for p in payloads]
    lines = {"jax": [], "port": []}
    targets = [
        lambda port, m=m, k=k: m.listen(
            port=port, log_file=str(tmp_path / f"{k}.log"),
            max_packets=len(payloads), print_fn=lines[k].append)
        for m, k in ((jconsole, "jax"), (tconsole, "port"))]
    _listen_both(targets, datagrams)

    def strip(ls):
        return [ln.split(" \t", 1)[1] for ln in ls]
    assert strip(lines["port"]) == strip(lines["jax"])
    assert len(lines["port"]) == len(payloads)
    assert strip(lines["port"])[0] == wp.packet_to_string(payloads[0])
    logs = [strip((tmp_path / f"{k}.log").read_text().splitlines())
            for k in ("jax", "port")]
    assert logs[0] == logs[1] == strip(lines["port"])


# ---------------------------------------------------------------------- web

class _Sondehub:
    def __init__(self):
        self.calls = []

    def add_telemetry(self, *args, **kwargs):
        self.calls.append((args, kwargs))


def _sse_events(port, n, out):
    """Read n `data:` events of the server's SSE stream into out."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    conn.request("GET", "/events")
    resp = conn.getresponse()
    assert resp.status == 200
    try:
        while len(out) < n:
            line = resp.fp.readline()
            if not line:
                break
            if line.startswith(b"data:"):
                out.append(json.loads(line[5:]))
    except OSError:
        pass
    finally:
        conn.close()


def _drive_web(mod, tmp_path, payloads):
    """A server on ports of its own: direct packets and an image, then the
    same over its UDP bus (modem stats, uploader stats, WENET packets, an
    image update); -> (SSE events, /, /latest.jpg, Horus datagrams,
    SondeHub calls)."""
    horus = _udp_sink()
    hub = _Sondehub()
    udp_port = _free_udp_port()
    srv = mod.WenetWebServer(port=0, udp_port=udp_port,
                             image_dir=str(tmp_path), my_callsign="GROUND",
                             horus_udp_port=horus.getsockname()[1],
                             sondehub=hub)
    img = tmp_path / f"{mod.__name__}.jpg"
    img.write_bytes(_jpeg(1))
    n_events = 0
    events = []
    try:
        stats = {"type": "MODEM_STATS", "snr": 14.5, "ppm": -3.0,
                 "fcentre": 441200500.0, "fft_db": [1.0, 2.0]}
        datagrams = [json.dumps(stats).encode(),
                     json.dumps({"type": "UPLOADER_STATS", "queued": 1,
                                 "uploaded": 2, "discarded": 0}).encode(),
                     b"{bad", json.dumps({"filename": str(img),
                                          "metadata": {"k": 1}}).encode()]
        datagrams += [_wenet(p) for p in payloads]
        # events: five of the packets and the image, directly; then modem
        # stats, uploader stats, the image and the packets over the bus
        n_events = 6 + 3 + 5
        reader = threading.Thread(target=_sse_events,
                                  args=(srv.port, n_events, events),
                                  daemon=True)
        reader.start()
        deadline = time.time() + WAIT
        while not srv._subscribers and time.time() < deadline:
            time.sleep(0.01)
        for p in payloads:
            srv.handle_packet(p)
        srv.handle_image(str(img), {"image_id": 7})
        _send(udp_port, datagrams)
        reader.join(timeout=WAIT)
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=WAIT)
        c.request("GET", "/")
        index = c.getresponse().read()
        c.request("GET", "/latest.jpg")
        r = c.getresponse()
        latest = (r.status, r.read())
        c.request("GET", "/nothing")
        r = c.getresponse()
        r.read()
        missing = r.status
        c.close()
        horus_msgs = []
        try:
            while len(horus_msgs) < 1:
                horus_msgs.append(json.loads(horus.recvfrom(65535)[0]))
        except socket.timeout:
            pass
    finally:
        srv.close()
        horus.close()
    return events, index, latest, missing, horus_msgs, hub.calls


def test_web_server_matches(tmp_path):
    """The same packets, image and UDP bus traffic give the same SSE event
    JSON; the page (its title kept), /latest.jpg and 404s are the same;
    the GPS fix that follows modem stats and image telemetry gives the
    same Horus PAYLOAD_SUMMARY datagram and SondeHub record."""
    payloads = _payloads()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    got = _drive_web(tweb, tmp_path / "port", payloads)
    want = _drive_web(jweb, tmp_path / "jax", payloads)
    ev_t, ev_j = got[0], want[0]
    for ev in ev_t + ev_j:
        if ev.get("type") == "IMAGE":
            ev.pop("filename")
    assert ev_t == ev_j
    kinds = [e["type"] for e in ev_t]
    assert {"TEXT", "GPS", "ORIENTATION", "IMAGE_TELEMETRY", "IMAGE",
            "MODEM_STATS", "UPLOADER_STATS"} <= set(kinds)
    assert got[1] == want[1] and b"Wenet TPU" in got[1]
    assert tweb.INDEX_HTML == jweb.INDEX_HTML
    assert got[2] == (200, _jpeg(1)) and want[2] == got[2]
    assert got[3] == want[3] == 404
    assert got[4] == want[4] and got[4][0]["type"] == "PAYLOAD_SUMMARY"
    assert got[4][0]["callsign"] == "VK5QI-Wenet"
    assert got[5] == want[5] and len(got[5]) == 1


def test_payload_summary_matches():
    """emit_payload_summary: the same fix and stats give the same
    datagram."""
    sink = _udp_sink()
    port = sink.getsockname()[1]
    gps = dict(GPS, timestamp="2026-08-17T01:02:03")
    try:
        out = []
        for mod in (jweb, tweb):
            mod.emit_payload_summary("GROUND", "VK5QI", gps,
                                     {"fcentre": 441200500.0, "snr": 15.2},
                                     port)
            out.append(sink.recvfrom(65535)[0])
            mod.emit_payload_summary("GROUND", "VK5QI", gps, {}, port)
            out.append(sink.recvfrom(65535)[0])
    finally:
        sink.close()
    assert out[:2] == out[2:]
    assert json.loads(out[2])["frequency"] == round(441200500.0 / 1e6, 5)


# ------------------------------------------------------- uploads (HTTP sink)

class _HTTPSink:
    """A localhost HTTP server that keeps every POST and PUT body."""

    def __init__(self):
        self.bodies = []
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _keep(self):
                n = int(self.headers["Content-Length"])
                sink.bodies.append((self.command, self.path,
                                    json.loads(self.rfile.read(n))))
                self.send_response(200)
                self.end_headers()

            do_POST = do_PUT = _keep

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def requests_module(monkeypatch):
    """`requests` where it is installed, else a stand-in over urllib with
    the calls and the exception the apps use."""
    try:
        import requests
        return requests
    except ImportError:
        pass
    import urllib.request

    def call(method):
        def fn(url, json=None, timeout=None, data=None):
            body = (__import__("json").dumps(json).encode() if json is not None
                    else data)
            req = urllib.request.Request(
                url, data=body, method=method,
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=timeout)
        return fn
    fake = types.ModuleType("requests")
    fake.post, fake.put = call("POST"), call("PUT")
    fake.exceptions = types.SimpleNamespace(Timeout=TimeoutError)
    monkeypatch.setitem(sys.modules, "requests", fake)
    return fake


def _drive_uploader(mod, tmp_path, packets, url, dead_url):
    status = _udp_sink()
    up = mod.SSDVUploader(uploader_callsign="VK5QI", ssdv_url=url,
                          enable_file_watch=False,
                          watch_directory=str(tmp_path), queue_size=8,
                          upload_block_size=1000, upload_anyway=1e6,
                          status_port=status.getsockname()[1])
    try:
        added = [up.add_packet(p) for p in packets[:3]]
        binf = tmp_path / "img.bin"
        binf.write_bytes(b"".join(packets[3:6]))
        added.append(up.add_file(str(binf)))
        binf.write_bytes(b"".join(packets[3:9]))
        added.append(up.add_file(str(binf)))       # only the new packets
        added.append(up.add_file(str(tmp_path / "missing.bin")))
        added += [up.add_packet(p) for p in packets[9:]]   # queue full
        ok = [up.ssdv_upload_multiple(4), up.ssdv_upload_multiple(100)]
        up.ssdv_url = dead_url
        up.add_packet(packets[0])
        ok.append(up.ssdv_upload_multiple(1))
        up.send_status()
        heartbeat = json.loads(status.recvfrom(65535)[0])
        counts = (up.upload_count, up.discard_count, up.upload_queue.qsize())
    finally:
        up.close()
        status.close()
    return added, ok, heartbeat, counts


def test_uploader_matches(tmp_path, requests_module):
    """The same packets (queued, read from a growing .bin file, and over
    the bounded queue) give the same upload bodies at a localhost sink,
    less the time of receipt; a dead endpoint discards alike; the status
    heartbeats are equal."""
    rng = np.random.default_rng(2)
    packets = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
               for _ in range(12)]
    sink = _HTTPSink()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}/"
    dead.close()
    out = {}
    try:
        for mod in (juploader, tuploader):
            (tmp_path / mod.__name__).mkdir()
            n = len(sink.bodies)
            res = _drive_uploader(mod, tmp_path / mod.__name__, packets,
                                  sink.url + "/api/v0/packets", dead_url)
            bodies = sink.bodies[n:]
            for _, _, body in bodies:
                for pkt in body["packets"]:
                    received = pkt.pop("received")
                    assert len(received) == 20 and received.endswith("Z")
            out[mod] = (res, bodies)
    finally:
        sink.close()
    assert out[tuploader] == out[juploader]
    (added, ok, heartbeat, counts), bodies = out[tuploader]
    assert ok == [True, True, False] and counts == (8, 5, 0)
    assert heartbeat == {"type": "UPLOADER_STATS", "queued": 0,
                         "uploaded": 8, "discarded": 5}
    assert [len(b["packets"]) for _, _, b in bodies] == [4, 4]
    assert bodies[0][2]["packets"][0]["receiver"] == "VK5QI"
    assert tuploader.DEFAULT_SSDV_URL == juploader.DEFAULT_SSDV_URL


def test_sondehub_uploader_matches(requests_module):
    """SondeHubAmateurUploader: the same telemetry gives the same PUT
    batch at a localhost sink."""
    sink = _HTTPSink()
    try:
        for mod in (jweb, tweb):
            up = mod.SondeHubAmateurUploader("GROUND", upload_rate=0.05,
                                             url=sink.url + "/amateur")
            up.add_telemetry("VK5QI-Wenet", "2026-08-17T01:02:03Z", -34.9,
                             138.6, 1000.0, sats=9, heading=90.0,
                             extra_fields={"speed": 4.2},
                             modulation="Wenet")
            deadline = time.time() + WAIT
            n = len(sink.bodies)
            while len(sink.bodies) == n and time.time() < deadline:
                time.sleep(0.02)
            up.close()
    finally:
        sink.close()
    assert len(sink.bodies) == 2 and sink.bodies[0] == sink.bodies[1]
    assert sink.bodies[1][2][0]["speed"] == 4.2


# ---------------------------------------------------------------------- GUI

def _gui_messages():
    payloads = _payloads()
    return [{"filename": "/tmp/img_1.jpg", "text": "GPS overlay"},
            {"uploader_status": {"queued": 3, "uploaded": 7,
                                 "discarded": 1}},
            {"filename": "/tmp/img_2.jpg"}, {"unrelated": True},
            {"type": "OTHER", "packet": [0]}] + [
        {"type": "WENET", "packet": list(p)} for p in payloads]


def _stats_records(n):
    rng = np.random.default_rng(4)
    recs = []
    for i in range(n):
        recs.append({"EbNodB": float(rng.normal(10, 3)),
                     "ppm": float(rng.normal(0, 20)),
                     "f1_est": float(rng.normal(19200, 50)),
                     "f2_est": float(rng.normal(28800, 50)),
                     "samp_fft": rng.normal(0, 1, 16).tolist(),
                     "eye_diagram": rng.uniform(0, 1, (8, 5)).tolist()})
    recs.append({"EbNodB": float("nan"), "ppm": 1.0})
    recs.append({"f1_est": 5.0})
    return recs


def _gui_state(mod):
    changes = []
    img = mod.ImageViewerModel(on_change=lambda m: changes.append(
        m.status_line()))
    dash = mod.TelemetryDashboardModel(history=2)
    stats = mod.ModemStatsModel(history=5)
    for msg in _gui_messages():
        img.handle(msg)
        dash.handle(msg)
    for rec in _stats_records(7):
        stats.update(rec)
    return (changes, img.status_line(), img.images_seen, img.upload_status,
            dash.status_line(), dash.track, dash.orientation, dash.text_log,
            dash.packets, stats.snapshot(), stats.ebno.tolist(),
            stats.ppm.tolist(), stats.fest.tolist(), stats.eye.tolist(),
            stats.spectrum.tolist())


def test_gui_models_match():
    """ImageViewerModel, TelemetryDashboardModel and ModemStatsModel: the
    same messages give the same status lines, snapshots and state."""
    got, want = _gui_state(tgui), _gui_state(jgui)
    assert repr(got) == repr(want)          # nan == nan in the histories
    assert got[9]["frames"] == 9 and "alt=" in got[4]
    assert tgui.HISTORY == jgui.HISTORY


def test_gui_over_udp_and_terminal_views_match(capsys):
    """UDPListener on a port the OS picks feeds each model; the terminal
    views print the same lines."""
    out = []
    for mod in (jgui, tgui):
        m = mod.ImageViewerModel()
        dash = mod.TelemetryDashboardModel()
        lst = [mod.UDPListener(0, m.handle).start(),
               mod.UDPListener(0, dash.handle).start()]
        try:
            _send(lst[0].port, [json.dumps({"filename": "a.jpg",
                                            "text": "hi"}).encode()])
            _send(lst[1].port, [_wenet(p) for p in _payloads()[:2]])
            deadline = time.time() + WAIT
            while (not m.images_seen or dash.packets < 2) \
                    and time.time() < deadline:
                time.sleep(0.01)
        finally:
            for listener in lst:
                listener.close()
        out.append((m.status_line(), dash.status_line(), dash.text_log))
        mod.run_image_gui(port=0, refresh_s=0, iterations=2)
        mod.run_telemetry_gui(port=0, refresh_s=0, iterations=1)
    assert out[0] == out[1] and out[1][2] == ["hello ground"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == lines[3:] and len(lines) == 6


# ---------------------------------------------------------- link emulation

def _pin_host(monkeypatch):
    """GPS packets carry the host's load, disk use and CPU temperature:
    pin them in both packages so the frames compare."""
    from wenet_tpu.tx import packet_tx as jtx
    from wenet_tpu_torch.tx import packet_tx as ttx
    for mod in (jtx, ttx):
        monkeypatch.setattr(mod, "get_cpu_temperature", lambda: 45.5)
        monkeypatch.setattr(mod, "get_cpu_speed", lambda: 1200.0)

    def no_load():
        raise OSError("pinned")
    monkeypatch.setattr(os, "getloadavg", no_load)


def _emulate(mod, through_modem, **kw):
    """Texts, a secondary payload over the emulator's UDP uplink, GPS
    fixes; drained, a trailing idle -> (packets received, broadcasts)."""
    from wenet_tpu_torch.tx.gps import SimulatedGPS
    tel = _udp_sink()
    emu = mod.LinkEmulator(tx_port=0, telemetry_port=tel.getsockname()[1],
                           through_modem=through_modem,
                           cfg=fsk.FSKConfig(Fs=96000, Rs=9600), **kw)
    try:
        deadline = time.time() + WAIT
        while getattr(emu.tx, "_udp", None) is None \
                and time.time() < deadline:
            time.sleep(0.01)
        uplink = emu.tx._udp.getsockname()[1]
        _send(uplink, [json.dumps({"type": "WENET_TX_SEC_PAYLOAD", "id": 7,
                                   "packet": list(range(20))}).encode()])
        while emu.tx.telemetry_queue_empty() and time.time() < deadline:
            time.sleep(0.01)
        emu.tx.transmit_text_message("bit-true link")
        emu.tx.transmit_text_message("second", repeats=2)
        gps = SimulatedGPS(realtime=False)
        for _ in range(2):
            emu.tx.transmit_gps_telemetry(gps.step())
        emu.drain()
        emu.tx.radio.transmit_packet(emu.tx.idle_message)
        broadcasts = [json.loads(tel.recvfrom(65535)[0])
                      for _ in emu.packets_received]
    finally:
        emu.close()
        tel.close()
    return emu.packets_received, broadcasts


@pytest.mark.parametrize("through_modem", [False, True],
                         ids=["ideal", "through_modem"])
def test_link_emulator_matches(through_modem, monkeypatch):
    """With device="cpu" the port's LinkEmulator receives the same packets
    as the JAX package's, ideal and through the modem (the port's
    Receiver on the CPU), and broadcasts them alike."""
    _pin_host(monkeypatch)
    kw = dict(device="cpu") if through_modem else {}
    got = _emulate(tlink, through_modem, **kw)
    want = _emulate(jlink, through_modem)
    assert got == want
    kinds = [wp.decode_packet_type(p) for p in got[0]]
    assert kinds == [wp.PacketType.SEC_PAYLOAD_TELEMETRY] + \
        [wp.PacketType.TEXT_MESSAGE] * 3 + [wp.PacketType.GPS_TELEMETRY] * 2
    assert [b["packet"] for b in got[1]] == [list(p) for p in got[0]]


def test_loopback_radio_frames_match():
    """_LoopbackRadio scrambles and hands frames on as the JAX one does."""
    frames = {"jax": [], "port": []}
    for mod, k in ((jlink, "jax"), (tlink, "port")):
        radio = mod._LoopbackRadio(frames[k].append)
        radio.transmit_packet(radio.scramble(bytes(range(200))))
        radio.shutdown()
        assert radio.mode == "v2"
    assert frames["jax"] == frames["port"]


# ---------------------------------------------------------------- examples

def test_rx_tester_feed_matches(tmp_path, monkeypatch):
    """rx_tester.feed: the same SSDV files give the same packet and image
    counts and the same images (names less their time stamp)."""
    from wenet_tpu_torch import ssdv
    files = []
    for i in range(2):
        path = tmp_path / f"img{i}.bin"
        path.write_bytes(b"".join(ssdv.encode(_jpeg(i), "VK5QI", i)))
        files.append(str(path))
    out = {}
    for mod in (jrx_tester, trx_tester):
        d = tmp_path / mod.__name__
        n = mod.feed(files, rate_baud=1e12, image_dir=str(d),
                     emit_udp=False, partial_update=4)
        out[mod] = (n, sorted((p.name.split("_", 1)[1], p.read_bytes())
                              for p in d.iterdir()))
    assert out[trx_tester] == out[jrx_tester]
    assert out[trx_tester][0][1] == 2


def test_sec_payload_rx_matches():
    """sec_payload_rx.listen: the same bus traffic gives the same
    secondary payloads, filtered by id alike."""
    payloads = [_pad(wp.encode_sec_payload(i % 3, bytes([i] * 10)))
                for i in range(6)]
    datagrams = [b"{bad", _wenet(_payloads()[0])]
    datagrams += [_wenet(p) for p in payloads]
    got = {}
    for pid in (None, 1):
        got[pid] = {"jax": [], "port": []}
        n = 6 if pid is None else 2
        targets = [
            lambda port, m=m, k=k, pid=pid: m.listen(
                payload_id=pid, port=port, callback=got[pid][k].append,
                max_packets=n)
            for m, k in ((jsec, "jax"), (tsec, "port"))]
        _listen_both(targets, datagrams)
        assert got[pid]["port"] == got[pid]["jax"]
        assert len(got[pid]["port"]) == n
    assert all(s["id"] == 1 for s in got[1]["port"])


# ------------------------------------------------------- rx CLI read-ahead

def _capture(path, texts):
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    rng = np.random.default_rng(11)
    bits = [rng.integers(0, 2, 3000).astype(np.uint8)]
    for i, t in enumerate(texts):
        frame = framing.frame_packet(wp.encode_text_message(t, i),
                                     ldpc.encode_bytes, mode="v2")
        bits += [framing.frame_to_bits(frame, "v2"),
                 rng.integers(0, 2, 2000).astype(np.uint8)]
    stream = np.concatenate(bits)
    sig, _ = fsk.fsk_mod_np(cfg, stream, 2 * cfg.Rs, cfg.Rs)
    (0.4 * sig).astype(np.complex64).tofile(path)


def _rx_cli(path, out, **kw):
    logs = out / "logs"
    assert cli_rx.main([str(path), "--format", "c64", "--fs", "96000",
                        "--rs", "9600", "--device", "cpu", "--no-udp",
                        "--chunk-seconds", "0.25", "--image-dir",
                        str(out / "img"), "--log-dir", str(logs)]) == 0
    texts = []
    for p in glob.glob(str(logs / "*_text.log")):
        with open(p) as fh:
            texts += [json.loads(ln) for ln in fh]
    return texts


def test_rx_cli_read_ahead_matches_inline_reads(tmp_path, monkeypatch):
    """The streaming CLI reads through the prefetch thread and routes the
    same text records as with the inline reads it made before."""
    texts = [f"read ahead {i}" for i in range(4)]
    cap = tmp_path / "cap.c64"
    _capture(cap, texts)
    got = _rx_cli(cap, tmp_path / "ahead")
    calls = []

    def inline(fin, chunk_bytes):
        calls.append(chunk_bytes)
        while True:
            raw = fin.read(chunk_bytes)
            if not raw:
                return
            yield raw
    monkeypatch.setattr(cli_rx, "_chunk_reader", inline)
    want = _rx_cli(cap, tmp_path / "inline")
    assert calls == [int(96000 * 0.25) * 8]
    assert got == want and [t["text"] for t in got] == texts


def test_rx_cli_ends_cleanly_on_a_failing_read(tmp_path, monkeypatch):
    """A read that raises mid-stream ends the stream, as the JAX pump
    does: the CLI returns 0 with the packets of the chunks read before."""
    texts = [f"failing read {i}" for i in range(4)]
    cap = tmp_path / "cap.c64"
    _capture(cap, texts)
    data = cap.read_bytes()
    cut = len(data) // 16 * 8              # half, in whole samples

    class Failing(io.RawIOBase):
        def __init__(self):
            self.pos = 0

        def read(self, n):
            if self.pos >= cut:
                raise OSError("device went away")
            out = data[self.pos:min(self.pos + n, cut)]
            self.pos += len(out)
            return out

    reader = cli_rx._chunk_reader(Failing(), 4096)
    chunks = list(reader)
    assert b"".join(chunks) == data[:cut]
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(buffer=Failing()))
    logs = tmp_path / "logs"
    assert cli_rx.main(["-", "--format", "c64", "--fs", "96000", "--rs",
                        "9600", "--device", "cpu", "--no-udp",
                        "--chunk-seconds", "0.25", "--image-dir",
                        str(tmp_path / "img"), "--log-dir", str(logs)]) == 0
    got = []
    for p in glob.glob(str(logs / "*_text.log")):
        with open(p) as fh:
            got += [json.loads(ln)["text"] for ln in fh]
    assert got and got == texts[:len(got)] and len(got) < len(texts)
