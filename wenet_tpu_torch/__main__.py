"""Dispatcher: python -m wenet_tpu_torch {rx,tx,flight,ber,bench,ssdv,web,
console,gui,telemetrygui}."""
import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m wenet_tpu_torch {rx,tx,flight,ber,bench,ssdv,"
              "web,console,gui,telemetrygui} [args]\n"
              "  rx           decode IQ -> packets/images/telemetry "
              "(PyTorch/CUDA)\n"
              "  tx           transmit images/text to IQ/bit/UDP sinks\n"
              "  flight       full payload loop: camera+GPS -> radio\n"
              "               (tx_picamera2_gps equivalent)\n"
              "  ber          testframe BER mode (fsk_demod -f equivalent)\n"
              "  bench        PER/throughput regression sweep\n"
              "  ssdv         standalone SSDV transcoder (fsphil/ssdv "
              "argv contract)\n"
              "  web          live web GUI (wenetserver equivalent)\n"
              "  console      print telemetry from the UDP broadcast bus\n"
              "  gui          image viewer (rx_gui equivalent; Qt if present)\n"
              "  telemetrygui GPS/IMU dashboard (TelemetryGUI equivalent)")
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "rx":
        from .cli.rx import main as m
        return m(argv)
    if cmd == "tx":
        from .cli.tx import main as m
        return m(argv)
    if cmd == "flight":
        from .cli.flight import main as m
        return m(argv)
    if cmd == "ber":
        from .cli.ber import main as m
        return m(argv)
    if cmd == "bench":
        from .cli.bench_demod import main as m
        return m(argv)
    if cmd == "ssdv":
        from .cli.ssdv_cli import main as m
        return m(argv)
    if cmd == "web":
        import argparse
        import time

        from .rx.web import WenetWebServer
        ap = argparse.ArgumentParser()
        ap.add_argument("--port", type=int, default=5003)
        ap.add_argument("--image-dir", default="./rx_images")
        ap.add_argument("--callsign", default="N0CALL")
        ap.add_argument("--horus-udp-port", type=int, default=0)
        a = ap.parse_args(argv)
        srv = WenetWebServer(host="0.0.0.0", port=a.port,
                             image_dir=a.image_dir, my_callsign=a.callsign,
                             horus_udp_port=a.horus_udp_port)
        print(f"web GUI on :{srv.port}")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            srv.close()
        return 0
    if cmd == "gui":
        from .rx.gui import run_image_gui
        run_image_gui()
        return 0
    if cmd == "telemetrygui":
        from .rx.gui import run_telemetry_gui
        run_telemetry_gui()
        return 0
    if cmd == "console":
        from .rx.telemetry_console import listen
        listen()
        return 0
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
