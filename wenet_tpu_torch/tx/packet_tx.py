"""Packet transmit engine — framing, FEC, priority queues, telemetry
generators, idle filler, secondary-payload UDP uplink.

Behavioral mirror of tx/PacketTX.py (queues :60-62, frame_packet :123-137,
tx_thread :150-167, telemetry generators :231-476, UDP listener :503-569),
re-based on the port's core (our CRC/LDPC instead of crcmod + ctypes C);
a copy of wenet_tpu/tx/packet_tx.py.
"""
from __future__ import annotations

import datetime
import json
import logging
import socket
import struct
import threading
import queue as _queue

from ..core import framing, packets
from ..ops import ldpc

logger = logging.getLogger("wenet_tpu_torch.tx")


def get_cpu_temperature() -> float:
    """Read SoC temperature (PacketTX.py:480-489; sysfs instead of vcgencmd)."""
    try:
        with open("/sys/class/thermal/thermal_zone0/temp") as f:
            return int(f.read().strip()) / 1000.0
    except Exception:
        return -999.0


def get_cpu_speed() -> float:
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/scaling_cur_freq") as f:
            return int(f.read().strip()) / 1000.0
    except Exception:
        return 9999.0


class PacketTX:
    """Core transmitter: frames packets and drains two priority queues into
    the radio — telemetry first, then image data, idle filler otherwise."""

    def __init__(self, radio, callsign: str = "N0CALL",
                 payload_length: int = framing.PAYLOAD_BYTES, fec: bool = True,
                 udp_listener: int | None = None, log_file: str | None = None):
        self.radio = radio
        self.callsign = callsign
        self.payload_length = payload_length
        self.fec = fec
        self.ssdv_queue = _queue.Queue(4096)
        self.telemetry_queue = _queue.Queue(256)
        self.transmit_active = False
        self.text_message_count = 0
        self.image_telem_count = 0
        self.idle_message = self.frame_packet(framing.IDLE_SEQUENCE)
        self.packets_transmitted = 0

        self.log_file = open(log_file, "a") if log_file else None
        if self.log_file:
            self.log_file.write("Started Transmitting at %s\n"
                                % datetime.datetime.now(datetime.timezone.utc).isoformat())

        self._tx_thread = None
        self._udp_thread = None
        self._udp_port = udp_listener
        self._udp_running = False
        if udp_listener is not None:
            self.start_udp()

    # ------------------------------------------------------------- framing

    def frame_packet(self, packet: bytes) -> bytes:
        """preamble | UW | scramble(payload + CRC16-LE [+ 516-bit parity])
        (PacketTX.frame_packet)."""
        packet = framing.pad_payload(packet, self.payload_length)
        crc = struct.pack("<H", framing.crc16_ccitt(packet))
        body = packet + crc
        if self.fec:
            body += ldpc.encode_bytes(body)
        return framing.PREAMBLE + framing.UNIQUE_WORD + self.radio.scramble(body)

    def set_idle_message(self, message: str) -> None:
        pkt = b"\x00" + b"DE %s: \t%s" % (
            self.callsign.encode("ascii"), message.encode("ascii"))
        self.idle_message = self.frame_packet(pkt)

    # ------------------------------------------------------------ tx thread

    def start_tx(self) -> None:
        self.transmit_active = True
        self._tx_thread = threading.Thread(target=self.tx_thread, daemon=True)
        self._tx_thread.start()

    def tx_thread(self) -> None:
        while self.transmit_active:
            if self.telemetry_queue.qsize() > 0:
                self.radio.transmit_packet(self.telemetry_queue.get_nowait())
            elif self.ssdv_queue.qsize() > 0:
                self.radio.transmit_packet(self.ssdv_queue.get_nowait())
            else:
                self.radio.transmit_packet(self.idle_message)
            self.packets_transmitted += 1
        self.radio.shutdown()

    def close(self) -> None:
        self.transmit_active = False
        self._udp_running = False
        if self._tx_thread:
            self._tx_thread.join(timeout=5)

    # ------------------------------------------------------------- queueing

    def queue_image_packet(self, packet: bytes) -> None:
        self.ssdv_queue.put(self.frame_packet(packet))

    def queue_image_file(self, filename: str) -> bool:
        """Queue an SSDV file 256 bytes at a time (PacketTX.py:199-212)."""
        try:
            with open(filename, "rb") as f:
                data = f.read()
            for i in range(len(data) // 256):
                self.queue_image_packet(data[256 * i: 256 * (i + 1)])
            return True
        except Exception:
            return False

    def image_queue_empty(self) -> bool:
        return self.ssdv_queue.qsize() == 0

    def queue_telemetry_packet(self, packet: bytes, repeats: int = 1) -> None:
        for _ in range(repeats):
            self.telemetry_queue.put(self.frame_packet(packet))

    def telemetry_queue_empty(self) -> bool:
        return self.telemetry_queue.qsize() == 0

    # ------------------------------------------------- telemetry generators

    def _log(self, s: str) -> None:
        logger.info(s)
        if self.log_file:
            self.log_file.write(
                datetime.datetime.now().isoformat() + "," + s + "\n")
            self.log_file.flush()

    def transmit_text_message(self, message: str, repeats: int = 1) -> None:
        self.text_message_count = (self.text_message_count + 1) % 65536
        pkt = packets.encode_text_message(message, self.text_message_count)
        self.queue_telemetry_packet(pkt, repeats)
        self._log("TXing Text Message #%d: %s"
                  % (self.text_message_count, message))

    def transmit_gps_telemetry(self, gps_data: dict,
                               cam_metadata: dict | None = None) -> None:
        """0x01 GPS packet incl. payload-health fields
        (PacketTX.transmit_gps_telemetry, :260-344)."""
        d = dict(gps_data)
        d.setdefault("radio_temp", -999.0)
        d["cpu_temp"] = get_cpu_temperature()
        d["cpu_speed"] = get_cpu_speed()
        try:
            import os
            la = os.getloadavg()
            d["load_avg_1"], d["load_avg_5"], d["load_avg_15"] = la
            st = os.statvfs("/")
            d["disk_percent"] = 100.0 * (1 - st.f_bavail / st.f_blocks)
        except Exception:
            pass
        if cam_metadata:
            d["lens_position"] = cam_metadata.get("LensPosition", -999.0)
            d["sensor_temp"] = cam_metadata.get("SensorTemperature", -999.0)
            d["focus_fom"] = cam_metadata.get("FocusFoM", -999.0)
        self.queue_telemetry_packet(packets.encode_gps_telemetry(d))

    def transmit_orientation_telemetry(self, week, iTOW, leapS,
                                       orientation_data: dict) -> None:
        self.queue_telemetry_packet(packets.encode_orientation_telemetry(
            week, iTOW, leapS, orientation_data))

    def transmit_image_telemetry(self, gps_data: dict, orientation_data: dict,
                                 image_id: int, repeats: int = 1) -> None:
        self.image_telem_count = (self.image_telem_count + 1) % 65536
        pkt = packets.encode_image_telemetry(
            gps_data, orientation_data, image_id, self.callsign,
            self.image_telem_count)
        self.queue_telemetry_packet(pkt, repeats)

    def transmit_secondary_payload_packet(self, id: int = 0, data=None,
                                          repeats: int = 1) -> None:
        pkt = packets.encode_sec_payload(id, bytes(bytearray(data or [])))
        self.queue_telemetry_packet(pkt, repeats)

    # -------------------------------------------------------- UDP uplink

    def handle_udp_packet(self, packet: bytes) -> None:
        """WENET_TX_TEXT / WENET_TX_SEC_PAYLOAD uplink commands
        (PacketTX.handle_udp_packet, :503-537)."""
        try:
            d = json.loads(packet.decode())
            if d["type"] == "WENET_TX_TEXT":
                self.transmit_text_message(d["packet"])
            elif d["type"] == "WENET_TX_SEC_PAYLOAD":
                self.transmit_secondary_payload_packet(
                    id=int(d["id"]), data=d["packet"],
                    repeats=int(d.get("repeats", 1)))
        except Exception as e:
            logger.error("Could not parse packet: %s", e)

    def udp_rx_thread(self) -> None:
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.settimeout(1)
        self._udp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._udp.bind(("", self._udp_port))
        self._udp_running = True
        while self._udp_running:
            try:
                m = self._udp.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            self.handle_udp_packet(m[0])
        self._udp.close()

    def start_udp(self) -> None:
        if self._udp_thread is None:
            self._udp_thread = threading.Thread(
                target=self.udp_rx_thread, daemon=True)
            self._udp_thread.start()
