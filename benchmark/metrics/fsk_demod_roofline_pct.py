"""The demod's least time for the window's work over its device time:
the work of every demod call in the traced window (`kernels/fsk_demod.py`)
at the card's published peaks, against the profiler's time of the
kernels that file names."""
from benchmark import roofline

KERNEL = "fsk_demod"


def read(run):
    return roofline.share(run, KERNEL)
