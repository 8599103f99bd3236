"""Dispatcher: python -m wenet_tpu_torch {rx,tx,ber,bench,ssdv}."""
import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m wenet_tpu_torch {rx,tx,ber,bench,ssdv} "
              "[args]\n"
              "  rx           decode IQ -> packets/images/telemetry "
              "(PyTorch/CUDA)\n"
              "  tx           transmit images/text to IQ/bit/UDP sinks\n"
              "  ber          testframe BER mode (fsk_demod -f equivalent)\n"
              "  bench        PER/throughput regression sweep\n"
              "  ssdv         standalone SSDV transcoder (fsphil/ssdv "
              "argv contract)")
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "rx":
        from .cli.rx import main as m
        return m(argv)
    if cmd == "tx":
        from .cli.tx import main as m
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
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
