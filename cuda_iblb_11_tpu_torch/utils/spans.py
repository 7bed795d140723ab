"""Host spans at the model step's layer boundaries.

``with span("iblb.B4", n=K): ...`` marks a stretch of the host's work.
With recording off (the default) ``span`` returns one shared do-nothing
context, at the cost of one check of a module flag.  Between ``start()``
and ``stop()`` each span keeps a ``Span`` in memory: its name, the index in
``records()`` of the span it runs inside (-1 at the top), its start and end
on ``time.perf_counter_ns`` and ``n``, the work it covers (steps).  Inside
an active ``torch.profiler`` a span also enters
``torch.profiler.record_function(name)`` unless ``start(annotate=False)``
said not to, so it lands on the profiler's clock beside the device's
kernels, copies and memsets, and each idle gap of such a trace can be put
down to the span the host was in.

The recorder is one per process, as the profiler is: a span is recorded
wherever it runs, so whoever starts recording stops it.  Kernel launches
are counted by the wrappers' ``.launches``; a span counts work only
through its ``n``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    parent: int             # index of the enclosing span in records(); -1
    start_ns: int
    end_ns: int
    n: int | None           # the work the span covers (steps)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()
_recording = False
_annotate = True
_records: list = []         # a Span, or None while the span is open
_open: list[int] = []       # indices of the open spans, innermost last


class _Recorded:
    __slots__ = ("name", "n", "index", "start", "annotation")

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __enter__(self):
        self.annotation = None
        if _annotate and torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = len(_records)
        _records.append(None)
        _open.append(self.index)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        _records[self.index] = Span(self.name, _open[-1] if _open else -1,
                                    self.start, end, self.n)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, n: int | None = None):
    """A context that records ``name`` while recording is on."""
    return _Recorded(name, n) if _recording else NULL


def start(annotate: bool = True) -> None:
    """Clear the records and turn recording on; ``annotate``: enter
    record_function inside an active profiler."""
    global _recording, _annotate
    _records.clear()
    _open.clear()
    _recording, _annotate = True, annotate


def stop() -> None:
    """Turn recording off; the records stay."""
    global _recording
    _recording = False


def records() -> list:
    """The spans since the last start(), in the order they opened (None for
    one still open)."""
    return list(_records)
