"""B4's share of its roofline (counts/b4.py), in %."""

from iblb_benchmark.counts import b4 as kernel
from iblb_benchmark.metrics import roofline

COUNTERS = (kernel.COUNTER,)


def read(w):
    return roofline(w, kernel)
