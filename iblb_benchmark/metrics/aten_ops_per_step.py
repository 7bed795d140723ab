"""Outermost aten ops (the eager ops the host issues) per step in the
host profile (trace.py)."""


def read(w):
    return w.aten_ops / w.host_steps if w.host_steps else None
