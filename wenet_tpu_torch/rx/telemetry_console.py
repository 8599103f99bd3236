"""Telemetry console: print+log packets from the UDP 55672 broadcast bus
(rx/telemetry_console.py equivalent).  Run: python -m
wenet_tpu_torch.rx.telemetry_console [--log FILE].  A copy of
wenet_tpu/rx/telemetry_console.py."""
from __future__ import annotations

import argparse
import datetime
import json
import socket

from ..core import packets as wp


def listen(port: int = wp.WENET_TELEMETRY_UDP_PORT, log_file: str | None = None,
           max_packets: int | None = None, print_fn=print):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except OSError:
        pass
    s.settimeout(1)
    s.bind(("", port))
    logf = open(log_file, "a") if log_file else None
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
            line = "%s \t%s" % (datetime.datetime.now(datetime.timezone.utc).isoformat(),
                                wp.packet_to_string(packet))
            print_fn(line)
            if logf:
                logf.write(line + "\n")
                logf.flush()
            n += 1
    finally:
        s.close()
        if logf:
            logf.close()
    return n


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=wp.WENET_TELEMETRY_UDP_PORT)
    ap.add_argument("--log", default=None)
    args = ap.parse_args()
    listen(args.port, args.log)
