"""The per-layer metrics: one reader a metric, ``<name>.py``, found by the
metric's name in BENCHMARK.json.  A reader has

    read(w) -> float | None     w a trace.TraceWindow; None where the
                                window holds nothing to read (the metric
                                is then left out of the result's line)
    COUNTERS = (...)            optional: the program's wrappers
                                ("module:function") whose ``.launches`` it
                                reads from w.counters

A kernel's share of its roofline is ``roofline(w, kernel)`` with a module
of ``counts``.
"""

from __future__ import annotations

from iblb_benchmark.peaks import bound_seconds


def roofline(w, kernel):
    """100 x the kernel's least time per call over its measured device time
    per call in the window, in %; None without calls, device time or the
    card's peaks."""
    calls = w.counters.get(kernel.COUNTER)
    if not calls or w.peaks is None:
        return None
    seconds = kernel.device_seconds(w.device_ops)
    if seconds <= 0.0:
        return None
    nbytes, nflop = kernel.counts(w.params, w.K, w.dtype)
    return 100.0 * bound_seconds(w.peaks, nbytes, nflop, w.dtype) \
        / (seconds / calls)
