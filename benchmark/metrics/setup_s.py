"""Process start to the first timed push or call, host clock: torch and
CUDA start-up, the traffic made on the card, the program built (the
kernels compiled on a checkout's first run) and warmed on the cell's
shapes."""


def read(run):
    return run.setup_s
