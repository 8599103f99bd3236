"""Desktop GUI equivalents of rx/rx_gui.py, rx/fskdemodgui.py and
rx/TelemetryGUI.py.

The reference ships three Qt/pyqtgraph desktop tools:
  * rx_gui.py — latest-image viewer + uploader status (UDP 7890 JSON)
  * fskdemodgui.py — live modem plots: Eb/N0, clock-offset ppm, eye
    diagram, spectrum (stdin JSON from the demod's stats stream)
  * TelemetryGUI.py — GPS/IMU dashboard (UDP 55672 telemetry, deprecated)

Here each tool is split into a headless *model* (UDP/stdin ingestion +
ring-buffer state — fully testable with no display) and a thin view. The
view uses PyQt5 if importable; otherwise a terminal renderer prints the
same state, so the tools degrade gracefully on headless stations (the
web GUI in rx/web.py remains the primary live display).  A copy of
wenet_tpu/rx/gui.py.
"""
from __future__ import annotations

import json
import socket
import threading

import numpy as np

from ..core import packets as wp

HISTORY = 100          # fskdemodgui.py's plot history depth


class UDPListener:
    """Shared UDP JSON ingest thread (rx_gui.py:99-127 / TelemetryGUI)."""

    def __init__(self, port: int, callback):
        self.port = port
        self.callback = callback
        self._running = False
        self._thread = None

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(0.2)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        except OSError:
            pass
        self._sock.bind(("", self.port))
        self.port = self._sock.getsockname()[1]   # resolve port=0 -> assigned
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while self._running:
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self.callback(json.loads(data.decode("ascii", "ignore")))
            except Exception:
                pass

    def close(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=1.0)
        self._sock.close()


class ImageViewerModel:
    """rx_gui.py state: latest decoded image + text + uploader counters.

    Accepts the same UDP 7890 vocabulary: {"filename","text"} image
    updates (rx_gui.py:66-75) and {"uploader_status": {...}} heartbeats
    (rx_gui.py:77-79, ssdvuploader.py:329-343)."""

    def __init__(self, on_change=None):
        self.latest_image: str | None = None
        self.text: str = ""
        self.upload_status = {"queued": 0, "uploaded": 0, "discarded": 0}
        self.images_seen = 0
        self.on_change = on_change

    def handle(self, msg: dict):
        if "filename" in msg:
            self.latest_image = msg["filename"]
            self.text = msg.get("text") or ""
            self.images_seen += 1
        elif "uploader_status" in msg:
            st = msg["uploader_status"]
            for k in self.upload_status:
                if k in st:
                    self.upload_status[k] = st[k]
        else:
            return
        if self.on_change:
            self.on_change(self)

    def status_line(self) -> str:
        u = self.upload_status
        return (f"{self.latest_image or '(no image yet)'} | {self.text} | "
                f"upload q={u['queued']} ok={u['uploaded']} "
                f"drop={u['discarded']}")


class ModemStatsModel:
    """fskdemodgui.py state: rolling Eb/N0 / ppm / tone-estimate history,
    latest eye diagram and spectrum (fskdemodgui.py:46-160)."""

    def __init__(self, history: int = HISTORY):
        self.ebno = np.full(history, np.nan)
        self.ppm = np.full(history, np.nan)
        self.fest = np.full((2, history), np.nan)
        self.eye: np.ndarray | None = None
        self.spectrum: np.ndarray | None = None
        self.frames = 0

    def update(self, stats: dict):
        for buf, key in ((self.ebno, "EbNodB"), (self.ppm, "ppm")):
            if key in stats:
                buf[:-1] = buf[1:]
                v = float(stats[key])
                buf[-1] = v if np.isfinite(v) else np.nan
        if "f1_est" in stats and "f2_est" in stats:
            self.fest[:, :-1] = self.fest[:, 1:]
            self.fest[0, -1] = float(stats["f1_est"])
            self.fest[1, -1] = float(stats["f2_est"])
        if stats.get("eye_diagram"):
            self.eye = np.asarray(stats["eye_diagram"], np.float32)
        if stats.get("samp_fft"):
            self.spectrum = np.asarray(stats["samp_fft"], np.float32)
        self.frames += 1

    def snapshot(self) -> dict:
        def last(a):
            return None if np.all(np.isnan(a)) else float(a[~np.isnan(a)][-1])
        return {"EbNodB": last(self.ebno), "ppm": last(self.ppm),
                "f1_est": last(self.fest[0]), "f2_est": last(self.fest[1]),
                "eye_lines": 0 if self.eye is None else len(self.eye),
                "frames": self.frames}


class TelemetryDashboardModel:
    """TelemetryGUI.py state: GPS track history + latest orientation/text
    from the UDP 55672 broadcast bus."""

    def __init__(self, history: int = 1000):
        self.history = history
        self.track: list[dict] = []        # time/lat/lon/alt/speed/ascent
        self.orientation: dict | None = None
        self.text_log: list[str] = []
        self.packets = 0

    def handle(self, msg: dict):
        if msg.get("type") != "WENET":
            return
        payload = bytes(bytearray(msg["packet"]))
        self.packets += 1
        ptype = wp.decode_packet_type(payload)
        if ptype == wp.PacketType.GPS_TELEMETRY:
            gps = wp.gps_telemetry_decoder(payload)
            if isinstance(gps, dict) and gps.get("error", "None") == "None":
                self.track.append({k: gps[k] for k in
                                   ("timestamp", "latitude", "longitude",
                                    "altitude", "ground_speed", "ascent_rate")
                                   if k in gps})
                self.track = self.track[-self.history:]
        elif ptype == wp.PacketType.ORIENTATION_TELEMETRY:
            o = wp.orientation_telemetry_decoder(payload)
            if isinstance(o, dict):
                self.orientation = o
        elif ptype == wp.PacketType.TEXT_MESSAGE:
            t = wp.decode_text_message(payload)
            if isinstance(t, dict):
                self.text_log.append(t.get("text", ""))
                self.text_log = self.text_log[-50:]

    def status_line(self) -> str:
        if not self.track:
            return f"packets={self.packets} (no GPS fix yet)"
        g = self.track[-1]
        return (f"packets={self.packets} lat={g.get('latitude', 0):.5f} "
                f"lon={g.get('longitude', 0):.5f} alt={g.get('altitude', 0):.0f}m "
                f"spd={g.get('ground_speed', 0):.1f} "
                f"asc={g.get('ascent_rate', 0):+.1f}m/s")


def _qt_available() -> bool:
    try:
        import PyQt5  # noqa: F401
        return True
    except ImportError:
        return False


def run_image_gui(port: int = wp.WENET_IMAGE_UDP_PORT,
                  refresh_s: float = 1.0, iterations: int | None = None):
    """rx_gui.py entry: Qt viewer when available, else terminal status."""
    import time
    model = ImageViewerModel()
    listener = UDPListener(port, model.handle).start()
    try:
        if _qt_available():  # pragma: no cover - needs a display
            _run_qt_image_view(model, refresh_s)
        else:
            n = 0
            while iterations is None or n < iterations:
                print(f"[rx_gui] {model.status_line()}", flush=True)
                time.sleep(refresh_s)
                n += 1
    except KeyboardInterrupt:
        pass
    finally:
        listener.close()


def _run_qt_image_view(model, refresh_s):  # pragma: no cover - needs display
    from PyQt5 import QtCore, QtGui, QtWidgets
    app = QtWidgets.QApplication([])
    win = QtWidgets.QLabel("waiting for imagery...")
    win.setWindowTitle("wenet_tpu SSDV viewer")
    win.setMinimumSize(640, 480)

    def refresh():
        if model.latest_image:
            win.setPixmap(QtGui.QPixmap(model.latest_image).scaled(
                win.size(), QtCore.Qt.KeepAspectRatio))
            win.setToolTip(model.status_line())
    timer = QtCore.QTimer()
    timer.timeout.connect(refresh)
    timer.start(int(refresh_s * 1000))
    win.show()
    app.exec_()


def run_telemetry_gui(port: int = wp.WENET_TELEMETRY_UDP_PORT,
                      refresh_s: float = 1.0, iterations: int | None = None):
    """TelemetryGUI.py entry (terminal dashboard; Qt plots superseded by
    the web GUI's live charts)."""
    import time
    model = TelemetryDashboardModel()
    listener = UDPListener(port, model.handle).start()
    try:
        n = 0
        while iterations is None or n < iterations:
            print(f"[telemetry] {model.status_line()}", flush=True)
            if model.text_log:
                print(f"[telemetry] last text: {model.text_log[-1]}",
                      flush=True)
            time.sleep(refresh_s)
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        listener.close()
