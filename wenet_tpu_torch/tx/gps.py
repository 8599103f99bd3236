"""GPS sources for the TX stack (tx/ublox.py UBloxGPS abstraction role).

The reference vendors a full u-blox binary-protocol stack; the contract the
rest of the system needs is small (ublox.py:930-1100): a background source
of state dicts {week, iTOW, leapS, latitude, longitude, altitude,
ground_speed, heading, ascent_rate, numSV, gpsFix, dynamic_model} with a
per-fix callback and ascent-rate derivation.  Provided here:

  * `SimulatedGPS` — deterministic balloon-flight trajectory generator for
    development, testing, and link emulation (ascent at a settable rate,
    wind drift, burst + descent)
  * `UBloxGPS` — hardware path, import-gated on pyserial; raises with a
    clear message off-Pi

A copy of wenet_tpu/tx/gps.py.
"""
from __future__ import annotations

import threading
import time


GPS_FIX_3D = 3
DYNAMIC_MODEL_AIRBORNE1G = 6


class SimulatedGPS:
    """Synthetic flight: linear ascent with drift, burst at `burst_alt`,
    then descent.  Calls `callback(state_dict)` at `rate` Hz."""

    def __init__(self, callback=None, rate: float = 1.0,
                 lat: float = -34.9285, lon: float = 138.6007,
                 ascent_rate: float = 5.0, burst_alt: float = 30000.0,
                 ground_speed: float = 40.0, realtime: bool = True):
        self.callback = callback
        self.rate = rate
        self.lat0, self.lon0 = lat, lon
        self.ascent_rate = ascent_rate
        self.burst_alt = burst_alt
        self.ground_speed = ground_speed
        self.realtime = realtime
        self._t = 0.0
        self._running = False
        self._thread = None
        self.state = self._state_at(0.0)

    def _state_at(self, t: float) -> dict:
        ascending = t * self.ascent_rate < self.burst_alt
        if ascending:
            alt = t * self.ascent_rate
            vr = self.ascent_rate
        else:
            t_burst = self.burst_alt / self.ascent_rate
            alt = max(self.burst_alt - (t - t_burst) * 8.0, 0.0)
            vr = -8.0 if alt > 0 else 0.0
        drift_deg = self.ground_speed * t / 111000.0
        week = 2400
        itow = (t % 604800.0)
        return {
            "week": week, "iTOW": itow, "leapS": 18,
            "latitude": self.lat0, "longitude": self.lon0 + drift_deg,
            "altitude": alt, "ground_speed": self.ground_speed,
            "heading": 90.0, "ascent_rate": vr,
            "numSV": 11, "gpsFix": GPS_FIX_3D,
            "dynamic_model": DYNAMIC_MODEL_AIRBORNE1G,
        }

    def step(self) -> dict:
        """Advance one tick and return (and deliver) the new state."""
        self._t += 1.0 / self.rate
        self.state = self._state_at(self._t)
        if self.callback:
            self.callback(dict(self.state))
        return self.state

    def _loop(self):
        while self._running:
            if self.realtime:
                time.sleep(1.0 / self.rate)
            self.step()

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=3)


class UBloxGPS:  # pragma: no cover - hardware only
    """Hardware u-blox source (requires pyserial + a connected module)."""

    def __init__(self, *args, **kwargs):
        try:
            import serial  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pyserial not available; use SimulatedGPS for development "
                "(hardware GPS requires a Pi with a u-blox module)") from e
        raise NotImplementedError(
            "wire the u-blox binary protocol on flight hardware; the "
            "SimulatedGPS contract documents the required state dict")
