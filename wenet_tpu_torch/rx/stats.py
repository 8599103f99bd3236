"""Modem statistics bus (rx/fskstatsudp.py equivalent).

Consumes per-frame demod stats — either our Receiver's native stats or
fsk_demod-style JSON dicts — applies the same time-windowed averaging
(SNR mean or peak-hold, ppm mean, fft -> dB + absolute frequency axis),
and emits the reference's MODEM_STATS JSON to the image/GUI UDP port
(fskstatsudp.py:73-142, 170-178, 200-226)."""
from __future__ import annotations

import datetime
import json
import logging
import socket
import time

import numpy as np

from ..core.packets import WENET_IMAGE_UDP_PORT

logger = logging.getLogger("wenet_tpu.rx.stats")

FSK_STATS_FIELDS = ["EbNodB", "ppm", "f1_est", "f2_est", "samp_fft"]


class FSKDemodStats:
    """Time-windowed statistics accumulator."""

    def __init__(self, averaging_time: float = 5.0, peak_hold: bool = False,
                 freq: float = 441200000.0, sample_rate: float = 921416.0,
                 real: bool = False, decoder_id: str = ""):
        self.averaging_time = averaging_time
        self.peak_hold = peak_hold
        self.freq = freq
        self.sample_rate = sample_rate
        self.real = real
        self.decoder_id = decoder_id

        self.in_times = np.array([])
        self.in_snr = np.array([])
        self.in_ppm = np.array([])

        self.snr = -999.0
        self.fest = [0.0, 0.0]
        self.fft = []
        self.fft_db = []
        self.fft_freq = []
        self.ppm = 0.0
        self.fcentre = freq
        self.eye = []          # latest eye-diagram traces (list of lists)

    def update(self, data):
        """Accept one stats record: JSON string or dict with
        FSK_STATS_FIELDS (nan entries scrubbed, fskstatsudp.py:89-91)."""
        if isinstance(data, (bytes, str)):
            try:
                s = data.decode() if isinstance(data, bytes) else data
                if "nan" in s:
                    s = s.replace("nan", "0.0")
                data = json.loads(s)
            except Exception as e:
                logger.error("FSK Demod Stats - %s", e)
                return
        if not isinstance(data, dict):
            return
        for f in FSK_STATS_FIELDS:
            if f not in data:
                logger.error("Missing Field %s", f)
                return

        now = time.time()
        if data.get("eye_diagram"):
            self.eye = data["eye_diagram"]
        self.fft = np.array(data["samp_fft"])
        self.fest[0] = data["f1_est"]
        self.fest[1] = data["f2_est"]
        self.fcentre = self.freq + (self.fest[0] + self.fest[1]) / 2.0
        try:
            self.fft_db = list(np.around(
                10 * np.log10(self.fft + 1e-9), 1))
            self.fft_freq = list(np.around(np.linspace(
                0, self.sample_rate / 2, len(self.fft)) + self.freq, 1))
        except Exception:
            pass

        self.in_times = np.append(self.in_times, now)
        self.in_snr = np.append(self.in_snr, data["EbNodB"])
        self.in_ppm = np.append(self.in_ppm, data["ppm"])
        keep = self.in_times > (now - self.averaging_time)
        self.in_times = self.in_times[keep]
        self.in_snr = self.in_snr[keep]
        self.in_ppm = self.in_ppm[keep]
        self.ppm = float(np.mean(self.in_ppm))
        self.snr = float(np.max(self.in_snr) if self.peak_hold
                         else np.mean(self.in_snr))

    def to_wire(self) -> dict:
        """The MODEM_STATS message sent to the GUI bus."""
        return {
            "type": "MODEM_STATS",
            "snr": self.snr,
            "ppm": self.ppm,
            "fft_db": self.fft_db,
            "fft_freq": self.fft_freq,
            "fest": self.fest,
            "freq": self.freq,
            "fcentre": self.fcentre,
            "eye_diagram": self.eye,
            "time": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%SZ"),
        }


def receiver_stats_record(rx) -> dict:
    """fsk_demod-style stats record (`--stats` JSON fields) from a live
    `rx.pipeline.Receiver`, for `FSKDemodStats`; the state tensors are
    copied to the host here.  A `with_eye=True` receiver's record carries
    the eye-diagram traces of its last valid frame (fsk_demod.c:366-377);
    without it the record omits `eye_diagram`."""
    st = rx.state
    if st is None:
        return {}
    f_est = st.f_est.cpu().numpy()
    rec = {
        "secs": int(time.time()),
        "EbNodB": float(st.ebno_db),
        "ppm": int(float(st.ppm)),
        "f1_est": float(f_est[0]),
        "f2_est": float(f_est[1]),
        "samp_fft": [float(x) for x in st.fft_est.cpu().numpy()],
    }
    if getattr(rx, "last_eye", None) is not None:
        from ..ops import fsk
        f_int, high = rx.last_eye
        eye = fsk.eye_diagram(f_int, rx.cfg.P, high, rx.cfg.M)
        rec["eye_diagram"] = [[float(x) for x in row] for row in eye]
    return rec


def send_modem_stats(stats: dict, udp_port: int = WENET_IMAGE_UDP_PORT):
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(json.dumps(stats).encode("ascii"), ("127.0.0.1", udp_port))
        s.close()
    except Exception as e:
        logger.error("Error updating GUI with modem status: %s", e)
