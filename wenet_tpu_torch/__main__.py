"""Dispatcher: python -m wenet_tpu_torch {rx}."""
import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m wenet_tpu_torch rx [args]\n"
              "  rx           decode IQ -> packets/images/telemetry "
              "(PyTorch/CUDA)")
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "rx":
        from .cli.rx import main as m
        return m(argv)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
