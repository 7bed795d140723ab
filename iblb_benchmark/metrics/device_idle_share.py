"""The share of the device profile's intervals (trace.py) in which no
operation ran on the device: 1 - (union of device activity) / (their wall
time on the host's clock)."""


def read(w):
    if w.busy_s is None or w.window_s <= 0.0:
        return None
    return 1.0 - w.busy_s / w.window_s
