"""B5's share of its roofline (counts/b5.py), in %."""

from iblb_benchmark.counts import b5 as kernel
from iblb_benchmark.metrics import roofline

COUNTERS = (kernel.COUNTER,)


def read(w):
    return roofline(w, kernel)
