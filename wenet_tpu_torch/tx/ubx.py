"""u-blox UBX binary protocol: codec + GPS reader.

The reference vendors pyUblox (tx/ublox.py, 1314 LoC) and wraps it in a
`UBloxGPS` abstraction (ublox.py:930-1200): configure the receiver
(solution rate, per-message rates, airborne-1G dynamic model), parse the
NAV message stream, maintain a state dict, and fire a per-fix callback.

This is a clean-room implementation of the protocol subset Wenet uses
(message layouts from the public u-blox M8 interface description):

  * frame codec: sync 0xB5 0x62 | class | id | len LE16 | payload | ck_a ck_b
    (Fletcher-8 checksum over class..payload)
  * messages: NAV-SOL, NAV-POSLLH, NAV-VELNED, NAV-TIMEGPS, CFG-NAV5,
    CFG-RATE, CFG-MSG — the set ublox.py:1046-1069 subscribes to
  * `UBloxGPS`: transport-agnostic (pyserial gated; any file-like object
    works), real `threading.Lock` state access — the reference's boolean
    "lock" flags (ublox.py:953-955) are a known-benign race that we fix —
    per-fix callback on NAV-TIMEGPS, ascent rate from -velD, reconnect-on-
    failure loop, JSON fix logging.

`nav_frames(state)` packs a full fix as the 4-message burst a real chip
emits, which both the tests and `SimulatedGPS` use to drive the *real*
parser end-to-end with zero hardware.  A copy of wenet_tpu/tx/ubx.py.
"""
from __future__ import annotations

import json
import struct
import threading
import time

from ..core.packets import gps_weeksecondstoutc

SYNC1, SYNC2 = 0xB5, 0x62

CLASS_NAV, CLASS_CFG, CLASS_ACK = 0x01, 0x06, 0x05
MSG_NAV_POSLLH, MSG_NAV_SOL = 0x02, 0x06
MSG_NAV_VELNED, MSG_NAV_TIMEGPS = 0x12, 0x20
MSG_CFG_MSG, MSG_CFG_RATE, MSG_CFG_NAV5 = 0x01, 0x08, 0x24

DYNAMIC_MODEL_PORTABLE = 0
DYNAMIC_MODEL_AIRBORNE1G = 6    # ublox.py default for flight use

# payload layouts (u-blox M8 interface description, little-endian)
_NAV_SOL = struct.Struct("<IihBBiiiIiiiIHBBI")          # 52 B
_NAV_POSLLH = struct.Struct("<IiiiiII")                 # 28 B
_NAV_VELNED = struct.Struct("<IiiiIIiII")               # 36 B
_NAV_TIMEGPS = struct.Struct("<IihbBI")                 # 16 B
_CFG_RATE = struct.Struct("<HHH")                       # 6 B
_CFG_MSG = struct.Struct("<BBB")                        # 3 B
_CFG_NAV5 = struct.Struct("<HBBiIbBHHHHBB12x")          # 36 B


def checksum(body: bytes) -> bytes:
    """Fletcher-8 over class..payload (UBX spec 32.4)."""
    ck_a = ck_b = 0
    for b in body:
        ck_a = (ck_a + b) & 0xFF
        ck_b = (ck_b + ck_a) & 0xFF
    return bytes((ck_a, ck_b))


def frame(msg_class: int, msg_id: int, payload: bytes = b"") -> bytes:
    body = struct.pack("<BBH", msg_class, msg_id, len(payload)) + payload
    return bytes((SYNC1, SYNC2)) + body + checksum(body)


class UBXParser:
    """Incremental stream parser: feed bytes, get (class, id, payload)
    tuples; resynchronizes on garbage or checksum failure."""

    def __init__(self):
        self._buf = bytearray()
        self.bad_checksums = 0

    def feed(self, data: bytes):
        self._buf.extend(data)
        out = []
        while True:
            i = self._buf.find(bytes((SYNC1, SYNC2)))
            if i < 0:
                # no sync byte pair: keep at most one trailing 0xB5
                del self._buf[:max(0, len(self._buf) - 1)]
                return out
            if i:
                del self._buf[:i]
            if len(self._buf) < 8:
                return out
            length = struct.unpack_from("<H", self._buf, 4)[0]
            end = 6 + length + 2
            if len(self._buf) < end:
                return out
            body = bytes(self._buf[2:6 + length])
            if checksum(body) == bytes(self._buf[6 + length:end]):
                out.append((self._buf[2], self._buf[3],
                            bytes(self._buf[6:6 + length])))
                del self._buf[:end]
            else:
                self.bad_checksums += 1
                del self._buf[:2]       # resync past this false sync


# ---------------------------------------------------------------- pack/unpack

def pack_nav_sol(iTOW_ms: int, week: int, gpsFix: int, numSV: int) -> bytes:
    return frame(CLASS_NAV, MSG_NAV_SOL, _NAV_SOL.pack(
        iTOW_ms, 0, week, gpsFix, 0x0D, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        numSV, 0))


def pack_nav_posllh(iTOW_ms: int, lat_deg: float, lon_deg: float,
                    height_m: float) -> bytes:
    return frame(CLASS_NAV, MSG_NAV_POSLLH, _NAV_POSLLH.pack(
        iTOW_ms, int(round(lon_deg * 1e7)), int(round(lat_deg * 1e7)),
        int(round(height_m * 1e3)), int(round(height_m * 1e3)), 0, 0))


def pack_nav_velned(iTOW_ms: int, ground_speed_kph: float,
                    heading_deg: float, ascent_rate_ms: float) -> bytes:
    g_cm = int(round(ground_speed_kph / 0.036))     # kph -> cm/s
    return frame(CLASS_NAV, MSG_NAV_VELNED, _NAV_VELNED.pack(
        iTOW_ms, 0, 0, int(round(-ascent_rate_ms * 100.0)), g_cm, g_cm,
        int(round(heading_deg * 1e5)), 0, 0))


def pack_nav_timegps(iTOW_ms: int, week: int, leapS: int) -> bytes:
    return frame(CLASS_NAV, MSG_NAV_TIMEGPS, _NAV_TIMEGPS.pack(
        iTOW_ms, 0, week, leapS, 0x07, 0))


def pack_cfg_nav5(dyn_model: int) -> bytes:
    return frame(CLASS_CFG, MSG_CFG_NAV5, _CFG_NAV5.pack(
        0x0005, dyn_model, 3, 0, 0, 5, 0, 250, 250, 100, 100, 0, 0))


def nav_frames(state: dict) -> bytes:
    """Pack one complete fix as the NAV_SOL/POSLLH/VELNED/TIMEGPS burst the
    chip emits per solution (ublox.py:1124-1135 relies on this order)."""
    iTOW_ms = int(round(state["iTOW"] * 1000.0))
    return (pack_nav_sol(iTOW_ms, state["week"], state["gpsFix"],
                         state["numSV"]) +
            pack_nav_posllh(iTOW_ms, state["latitude"], state["longitude"],
                            state["altitude"]) +
            pack_nav_velned(iTOW_ms, state["ground_speed"], state["heading"],
                            state["ascent_rate"]) +
            pack_nav_timegps(iTOW_ms, state["week"], state["leapS"]))


class NtpShmSink:
    """ntpd shared-memory time sink — the reference's `ntpd_update=True`
    option (ublox.py:1019-1029): GPS time pushed into ntpd via the SHM
    refclock (type 28), unit 2, so /etc/ntp.conf needs
    `server 127.127.28.2 minpoll 1 maxpoll 3 prefer`.  Requires the
    `ntpdshm` package (not bundled); construction raises ImportError when
    it is absent so callers degrade gracefully."""

    def __init__(self, unit: int = 2):  # pragma: no cover - needs ntpdshm
        import ntpdshm
        self.shm = ntpdshm.NtpdShm(unit=unit)
        self.shm.mode = 0
        self.shm.precision = -5
        self.shm.leap = 0

    def __call__(self, utc_unix_ts: int):  # pragma: no cover
        self.shm.update(utc_unix_ts)


class UBloxGPS:
    """ublox.py:930 equivalent over any byte transport.

    transport: object with read(n)->bytes and write(bytes) (a pyserial
    Serial, a socket makefile, or an in-memory pipe). State keys and
    scalings are identical to the reference so the GPS telemetry packet
    encoder consumes the dict unchanged.

    time_sync: optional callable(utc_unix_seconds) invoked on every fix
    that lands exactly on a whole GPS second — the reference's NTPD-SHM
    push condition (ublox.py:1186-1188).  Pass an `NtpShmSink()` for the
    reference behavior, or any callable for custom host time discipline;
    `ntpd_update=True` wires the sink with the reference's silent-failure
    semantics (ublox.py:1019-1030).
    """

    def __init__(self, transport=None, port: str = "/dev/ublox",
                 baudrate: int = 115200, callback=None,
                 update_rate_ms: int = 500,
                 dynamic_model: int = DYNAMIC_MODEL_AIRBORNE1G,
                 debug_ptr=None, log_file: str | None = None,
                 reconnect_delay: float = 5.0,
                 time_sync=None, ntpd_update: bool = False):
        self.port = port
        self.baudrate = baudrate
        self._own_transport = transport is None
        if transport is None:  # pragma: no cover - hardware only
            import serial
            transport = serial.Serial(port, baudrate, timeout=2)
        self.transport = transport
        self.callback = callback
        self.update_rate_ms = update_rate_ms
        self.dynamic_model = dynamic_model
        self.debug_ptr = debug_ptr
        self.reconnect_delay = reconnect_delay
        self.time_sync = time_sync
        if ntpd_update and time_sync is None:  # pragma: no cover - ntpdshm
            try:
                self.time_sync = NtpShmSink()
                self.debug_message("Setup NTPD Interface OK")
            except Exception:
                self.debug_message("Failed to start NTPD Interface")
        self._log = open(log_file, "a") if log_file else None
        self._lock = threading.Lock()
        self.state = {
            "latitude": 0.0, "longitude": 0.0, "altitude": 0.0,
            "ground_speed": 0.0, "ascent_rate": 0.0, "heading": 0.0,
            "gpsFix": 0, "numSV": 0, "week": 0, "iTOW": 0.0, "leapS": 0,
            "timestamp": " ", "dynamic_model": 255,
        }
        self.parser = UBXParser()
        self.fix_count = 0
        self._running = False
        self._thread = None
        self.setup()

    # ---- configuration writes (ublox.py:1037-1060 setup_ublox) ----
    def setup(self):
        w = self.transport.write
        w(frame(CLASS_CFG, MSG_CFG_RATE,
                _CFG_RATE.pack(self.update_rate_ms, 1, 0)))
        for msg in (MSG_NAV_POSLLH, MSG_NAV_SOL, MSG_NAV_VELNED,
                    MSG_NAV_TIMEGPS):
            w(frame(CLASS_CFG, MSG_CFG_MSG, _CFG_MSG.pack(CLASS_NAV, msg, 1)))
        w(pack_cfg_nav5(self.dynamic_model))

    def debug_message(self, message: str):
        message = "GPS Debug: " + message
        if self.debug_ptr:
            self.debug_ptr(message)

    def write_state(self, key, value):
        with self._lock:
            self.state[key] = value

    def read_state(self) -> dict:
        with self._lock:
            return dict(self.state)

    # ---- message dispatch (ublox.py:1159-1199 scalings) ----
    def handle(self, msg_class: int, msg_id: int, payload: bytes):
        if msg_class != CLASS_NAV:
            if msg_class == CLASS_CFG and msg_id == MSG_CFG_NAV5 \
                    and len(payload) >= 3:
                self.write_state("dynamic_model", payload[2])
            return
        if msg_id == MSG_NAV_SOL and len(payload) == _NAV_SOL.size:
            d = _NAV_SOL.unpack(payload)
            self.write_state("gpsFix", d[3])
            self.write_state("numSV", d[15])
        elif msg_id == MSG_NAV_POSLLH and len(payload) == _NAV_POSLLH.size:
            d = _NAV_POSLLH.unpack(payload)
            self.write_state("longitude", d[1] * 1e-7)
            self.write_state("latitude", d[2] * 1e-7)
            self.write_state("altitude", d[3] * 1e-3)
        elif msg_id == MSG_NAV_VELNED and len(payload) == _NAV_VELNED.size:
            d = _NAV_VELNED.unpack(payload)
            self.write_state("ground_speed", d[5] * 0.036)    # cm/s -> kph
            self.write_state("heading", d[6] * 1e-5)
            self.write_state("ascent_rate", -d[3] / 100.0)    # -velD
        elif msg_id == MSG_NAV_TIMEGPS and len(payload) == _NAV_TIMEGPS.size:
            d = _NAV_TIMEGPS.unpack(payload)
            self.write_state("week", d[2])
            self.write_state("iTOW", d[0] * 1e-3)
            self.write_state("leapS", d[3])
            self.write_state("timestamp", gps_weeksecondstoutc(
                d[2], d[0] * 1e-3, d[3]))
            # host time discipline on whole-second fixes only — the
            # reference's NTPD-SHM push condition (ublox.py:1186-1188)
            if self.time_sync is not None and d[0] % 1000 == 0:
                import calendar
                from ..core.packets import gps_weeksecondstoutc_dt
                dt = gps_weeksecondstoutc_dt(d[2], d[0] * 1e-3, d[3])
                try:
                    self.time_sync(calendar.timegm(dt.utctimetuple()))
                except Exception as e:
                    self.debug_message(f"time_sync failed - {e}")
            self._fix_complete()

    def _fix_complete(self):
        self.fix_count += 1
        latest = self.read_state()
        if self._log:
            self._log.write(json.dumps(latest, default=str) + "\n")
            self._log.flush()
        if self.callback:
            self.callback(latest)

    # ---- RX thread (ublox.py:1119-1199 rx_loop w/ reconnect) ----
    def rx_once(self) -> int:
        data = self.transport.read(256)
        if not data:
            return 0
        n = 0
        for msg in self.parser.feed(data):
            self.handle(*msg)
            n += 1
        return n

    def _rx_loop(self):
        while self._running:
            try:
                if not self.rx_once():
                    time.sleep(0.01)
            except Exception as e:
                self.debug_message(f"WARNING: GPS Failure - {e}")
                self.write_state("numSV", 0)
                time.sleep(self.reconnect_delay)
                try:
                    if self._own_transport:  # pragma: no cover - hardware
                        # the device itself may have gone away: close and
                        # re-open the port, as the reference does on failure
                        # (ublox.py:1146-1156), rather than re-configuring a
                        # dead file handle
                        import serial
                        try:
                            self.transport.close()
                        except Exception:
                            pass
                        self.transport = serial.Serial(
                            self.port, self.baudrate, timeout=2)
                    self.setup()
                    self.debug_message("WARNING: GPS Re-connected.")
                except Exception:
                    continue

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)
        if self._log:
            self._log.close()
        if self._own_transport:  # pragma: no cover - hardware only
            try:
                self.transport.close()
            except Exception:
                pass
