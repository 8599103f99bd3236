"""GUI/application test feeder (rx/rx_tester.py role): bypass the modem and
feed canned SSDV packet files straight into the packet router at line rate,
exercising image reassembly, UDP buses and the web GUI with zero RF.

    python -m wenet_tpu_torch.examples.rx_tester image1.bin image2.bin --rate 115200

A copy of wenet_tpu/examples/rx_tester.py.
"""
from __future__ import annotations

import argparse
import time


def feed(files, rate_baud: float = 115200, image_dir: str = "./rx_images",
         emit_udp: bool = True, partial_update: int = 16):
    from ..rx.router import PacketRouter, UDPEmitter

    router = PacketRouter(image_dir=image_dir, partial_update=partial_update,
                          emitter=UDPEmitter(enabled=emit_udp))
    # one 256-byte payload occupies (256+2+65+20)*10 bits on air in v1
    seconds_per_packet = (256 + 2 + 65 + 20) * 10 / rate_baud
    n = 0
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        for i in range(len(data) // 256):
            router.handle_packet(data[256 * i: 256 * (i + 1)])
            n += 1
            time.sleep(seconds_per_packet)
    router.flush()
    return n, router.images_decoded


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--rate", type=float, default=115200)
    ap.add_argument("--image-dir", default="./rx_images")
    args = ap.parse_args()
    n, imgs = feed(args.files, args.rate, args.image_dir)
    print(f"fed {n} packets, {imgs} images decoded")
