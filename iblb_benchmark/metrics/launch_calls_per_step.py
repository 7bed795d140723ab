"""CUDA launch API calls on the host (kernel and graph launches) per step
in the host profile (trace.py)."""


def read(w):
    return w.launch_calls / w.host_steps if w.host_steps else None
