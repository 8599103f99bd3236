"""The demod's share of its roofline in the wideband cell, where each call
runs all the band's channels as lanes (L = 8): the work of every demod
call in the traced window (`kernels/fsk_demod.py`) at the card's
published peaks, against the profiler's time of the kernels that file
names."""
from benchmark import roofline

KERNEL = "fsk_demod"


def read(run):
    return roofline.share(run, KERNEL)
