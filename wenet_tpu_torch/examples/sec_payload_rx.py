"""Secondary-payload receive example (rx/sec_payload_rx_example.py role):
listen on the telemetry broadcast bus and hand type-0x03 payloads to a
user callback.

    python -m wenet_tpu_torch.examples.sec_payload_rx --id 7

A copy of wenet_tpu/examples/sec_payload_rx.py.
"""
from __future__ import annotations

import argparse
import json
import socket

from ..core import packets as wp


def listen(payload_id: int | None = None,
           port: int = wp.WENET_TELEMETRY_UDP_PORT,
           callback=None, max_packets: int | None = None):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except OSError:
        pass
    s.settimeout(1)
    s.bind(("", port))
    n = 0
    try:
        while max_packets is None or n < max_packets:
            try:
                data, _ = s.recvfrom(65535)
            except socket.timeout:
                continue
            try:
                d = json.loads(data.decode())
            except ValueError:
                continue
            if d.get("type") != "WENET":
                continue
            packet = bytes(bytearray(d["packet"]))
            if wp.decode_packet_type(packet) != wp.PacketType.SEC_PAYLOAD_TELEMETRY:
                continue
            sec = wp.sec_payload_decode(packet)
            if payload_id is not None and sec.get("id") != payload_id:
                continue
            n += 1
            if callback:
                callback(sec)
            else:
                print(f"Secondary #{sec['id']}: {sec['payload'].hex()}")
    finally:
        s.close()
    return n


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, default=None)
    ap.add_argument("--port", type=int, default=wp.WENET_TELEMETRY_UDP_PORT)
    args = ap.parse_args()
    listen(args.id, args.port)
