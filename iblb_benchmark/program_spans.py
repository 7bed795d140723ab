"""The program's host spans (cuda_iblb_11_tpu_torch/utils/spans.py) over the
device profile's intervals, for the per-layer metrics whose source is
``program_span``.

A reader's module body calls ``begin()``.  The harness loads the readers of
a ``--trace 1`` run after the warm interval and just before the window,
so the spans record from the window's first interval on, and a run
without the trace, the one that gives ``mlups`` and ``setup_s``, runs with
them off.  They record without entering ``record_function``: inside the
device profile that cost the host loop a few ms an interval on the card,
where the spans alone cost nothing measurable.  The first reader to read
turns recording off.

The window's spans are those of the first top-level ``iblb.run_chunk``
spans recorded, up to the device profile's steps (``w.steps``), with every
span inside them; the host profile's interval after them is left out,
since its recorded CPU events slow the host loop.  A reader reads None
where the run had no device profile (off the card), where the program
keeps no spans, or where they hold no ``iblb.run_chunk`` covering those
steps; a leg that did not run reads 0.
"""

from __future__ import annotations

import importlib

RUN = "iblb.run_chunk"


def _recorder():
    """The program's span recorder; None for a program without one."""
    try:
        return importlib.import_module("cuda_iblb_11_tpu_torch.utils.spans")
    except ImportError:
        return None


def begin() -> None:
    rec = _recorder()
    if rec is not None:
        rec.start(annotate=False)


def window(w):
    """([(span, its parent's name or None)] of the window, its steps), or
    None (module doc)."""
    rec = _recorder()
    if rec is None:
        return None
    rec.stop()
    if w.busy_s is None:
        return None
    records = rec.records()
    first = end = None
    steps = 0
    for i, r in enumerate(records):
        if r is None or r.parent != -1:
            continue
        if steps == w.steps:
            end = i
            break
        if r.name == RUN:
            first = i if first is None else first
            steps += r.n
    if first is None or steps != w.steps:
        return None
    spans = [(r, records[r.parent].name if r.parent >= 0 else None)
             for r in records[first:end] if r is not None]
    return spans, steps


def us_per_step(w, names, minus=()):
    """Host time in the spans named ``names``, less their children named
    ``minus``, in us per step of the window; None as window()."""
    win = window(w)
    if win is None:
        return None
    spans, steps = win
    ns = sum(s.ns for s, _ in spans if s.name in names) \
        - sum(s.ns for s, parent in spans
              if s.name in minus and parent in names)
    return ns / 1e3 / steps
