"""The channelizer's least time for the window's work over its device
time: the work of every channelizer call in the traced window
(`kernels/channelize.py`) at the card's published peaks, against the
profiler's time of the kernels that file names."""
from benchmark import roofline

KERNEL = "channelize"


def read(run):
    return roofline.share(run, KERNEL)
