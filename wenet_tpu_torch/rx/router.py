"""RX packet router + SSDV image assembler (rx/rx_ssdv.py equivalent).

Dispatches CRC-verified 256-byte payloads by type: telemetry types are
rebroadcast as JSON over UDP 55672 (+ GUI port in headless mode) and logged
as JSON lines; SSDV packets accumulate per (callsign, image_id) and are
decoded to JPEG on image boundaries / partial-update intervals via a
pluggable decoder (native wenet_tpu_torch.ssdv codec by default, external `ssdv`
binary if requested).

Unlike the reference (stdin loop, rx_ssdv.py:166-281), the router is a
library object fed by Receiver.push — process plumbing became function
calls; the UDP side-channels are kept for ecosystem compatibility.
"""
from __future__ import annotations

import codecs
import datetime
import json
import logging
import os
import socket

from ..core import packets as wp

logger = logging.getLogger("wenet_tpu.rx")


def _utcnow():
    return datetime.datetime.now(datetime.timezone.utc)


class UDPEmitter:
    """Reference-compatible UDP JSON side-channels (WenetPackets.py:24-25)."""

    def __init__(self, image_port: int = wp.WENET_IMAGE_UDP_PORT,
                 telemetry_port: int = wp.WENET_TELEMETRY_UDP_PORT,
                 enabled: bool = True):
        self.image_port = image_port
        self.telemetry_port = telemetry_port
        self.enabled = enabled

    def gui_update(self, filename: str, text: str = "None", metadata=None):
        if not self.enabled:
            return
        msg = {"filename": filename, "text": text, "metadata": metadata}
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(json.dumps(msg).encode("ascii"), ("127.0.0.1", self.image_port))
        s.close()

    def send_image_port(self, obj: dict):
        if not self.enabled:
            return
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(json.dumps(obj).encode("ascii"), ("127.0.0.1", self.image_port))
        s.close()

    def broadcast_telemetry(self, payload: bytes, headless: bool = False):
        if not self.enabled:
            return
        data = {"type": "WENET", "packet": list(bytearray(payload))}
        raw = json.dumps(data).encode("ascii")
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.sendto(raw, ("<broadcast>", self.telemetry_port))
        except socket.error:
            s.sendto(raw, ("127.0.0.1", self.telemetry_port))
        s.close()
        if headless:
            self.send_image_port(data)


class PacketRouter:
    """Type-dispatching packet consumer with SSDV reassembly."""

    def __init__(self, image_dir: str = "./rx_images", log_dir: str | None = None,
                 partial_update: int = 0, headless: bool = False,
                 emitter: UDPEmitter | None = None, ssdv_decoder=None,
                 callbacks: dict | None = None):
        """ssdv_decoder: callable(bin_path, jpg_path) -> bool.  Defaults to
        the native wenet_tpu_torch.ssdv decoder.  callbacks: optional
        {'image': f(jpg_path, info), 'telemetry': f(type, decoded)}."""
        os.makedirs(image_dir, exist_ok=True)
        self.image_dir = image_dir
        self.log_prefix = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.log_prefix = os.path.join(
                log_dir, _utcnow().strftime("%Y%m%d-%H%M%S"))
        self.partial_update = partial_update
        self.headless = headless
        self.emitter = emitter or UDPEmitter()
        self.callbacks = callbacks or {}
        if ssdv_decoder is None:
            from .. import ssdv as _ssdv
            ssdv_decoder = _ssdv.decode_file
        self.ssdv_decoder = ssdv_decoder

        self.current_image = -1
        self.current_callsign = ""
        self.current_packet_count = 0
        self.current_packet_time = _utcnow().strftime("%Y%m%d-%H%M%SZ")
        self._accum = bytearray()
        self.images_decoded = 0
        self.packets_seen = 0

    # ---------------------------------------------------------------- logs

    def _log_jsonl(self, suffix: str, decoded: dict):
        if self.log_prefix is None:
            return
        with open(f"{self.log_prefix}_{suffix}.log", "a") as f:
            f.write(json.dumps(decoded) + "\n")

    # ------------------------------------------------------------- dispatch

    def handle_packet(self, data: bytes):
        """Process one CRC-verified 256-byte payload (rx_ssdv.py:195-281)."""
        self.packets_seen += 1
        ptype = wp.decode_packet_type(data)
        T = wp.PacketType
        if ptype == T.IDLE:
            return
        if ptype == T.TEXT_MESSAGE:
            self._telem(data, "text", wp.decode_text_message)
        elif ptype == T.SEC_PAYLOAD_TELEMETRY:
            d = wp.sec_payload_decode(data)
            if "payload" in d:
                d = dict(d, payload=codecs.encode(d["payload"], "hex").decode())
            self.emitter.broadcast_telemetry(data)
            logger.info(wp.packet_to_string(data))
            self._log_jsonl("secondary", d)
            self._callback("telemetry", ptype, d)
        elif ptype == T.GPS_TELEMETRY:
            self._telem(data, "gps", wp.gps_telemetry_decoder)
        elif ptype == T.ORIENTATION_TELEMETRY:
            self._telem(data, "orientation", wp.orientation_telemetry_decoder)
        elif ptype == T.IMAGE_TELEMETRY:
            self._telem(data, "imagetelem", wp.image_telemetry_decoder)
        elif ptype == T.SSDV:
            self._handle_ssdv(data)
        else:
            logger.debug("Unknown Packet Format: %d", ptype)

    def _telem(self, data: bytes, suffix: str, decoder):
        self.emitter.broadcast_telemetry(data, self.headless)
        logger.info(wp.packet_to_string(data))
        decoded = decoder(data)
        self._log_jsonl(suffix, decoded)
        self._callback("telemetry", wp.decode_packet_type(data), decoded)

    def _callback(self, kind: str, *args):
        cb = self.callbacks.get(kind)
        if cb:
            try:
                cb(*args)
            except Exception:
                logger.exception("callback error")

    # ----------------------------------------------------------------- SSDV

    def _decode_accum(self, out_base: str) -> str | None:
        """Decode the accumulated packets to out_base.{bin,jpg}."""
        bin_path = out_base + ".bin"
        jpg_path = out_base + ".jpg"
        with open(bin_path, "wb") as f:
            f.write(bytes(self._accum))
        try:
            ok = self.ssdv_decoder(bin_path, jpg_path)
        except Exception:
            logger.exception("SSDV decode error")
            ok = False
        if not ok:
            logger.error("ERROR: SSDV Decode failed!")
            return None
        return jpg_path

    def _finish_image(self):
        if self.current_packet_count <= 0:
            return
        base = os.path.join(
            self.image_dir, f"{self.current_packet_time}_"
            f"{self.current_callsign}_{self.current_image}")
        jpg = self._decode_accum(base)
        if jpg:
            self.images_decoded += 1
            info = {"callsign": self.current_callsign,
                    "image_id": self.current_image,
                    "packets": self.current_packet_count}
            self.emitter.gui_update(os.path.abspath(jpg), "Image decoded", info)
            self._callback("image", jpg, info)

    def _handle_ssdv(self, data: bytes):
        info = wp.ssdv_packet_info(data)
        if info["error"] != "None":
            logger.error(info["error"])
            return
        boundary = (info["image_id"] != self.current_image or
                    info["callsign"] != self.current_callsign)
        if boundary:
            logger.info("New image - ID #%d", info["image_id"])
            self._finish_image()
            self.current_image = info["image_id"]
            self.current_callsign = info["callsign"]
            self.current_packet_count = 1
            self.current_packet_time = _utcnow().strftime("%Y%m%d-%H%M%SZ")
            self._accum = bytearray(data)
        else:
            self._accum.extend(data)
            self.current_packet_count += 1
            if self.partial_update and \
                    self.current_packet_count % self.partial_update == 0:
                base = os.path.join(self.image_dir, "rxtemp_partial")
                jpg = self._decode_accum(base)
                if jpg:
                    self.emitter.gui_update(
                        os.path.abspath(jpg), wp.ssdv_packet_string(data), info)
                    self._callback("image", jpg, info)

    def flush(self):
        """Decode any in-progress image (end-of-stream)."""
        self._finish_image()
        self.current_packet_count = 0
