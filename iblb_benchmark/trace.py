"""The traced window: ``torch.profiler`` over whole intervals, read into
what the per-layer metrics take.

Two profiles, one after the other, each between synchronises:

- the device profile (CUDA activity alone: the device's operations, no
  host events recorded but CUPTI's own) over the cell's
  ``trace_intervals``: the device's busy time, its operations by name and
  the wrappers' launch counters, against the wall time of those same
  intervals on the host's clock;
- the host profile (CPU and CUDA activity) over one further interval
  inside the span ``WINDOW_SPAN``: the launch calls and the outermost aten
  ops the host issues a step, and the idle gaps by what the host was
  doing.  Recording every host op slows the host loop (about 2x where it
  sets the pace), so no time of this profile enters a metric.

The arithmetic follows ``cuda_iblb_11_tpu_torch/profile_step.py`` (the
union of device intervals, the outermost aten op, the launch calls), with
the device's busy time and the wall time taken from the same intervals.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WINDOW_SPAN = "iblb_benchmark.window"
TOP = 10                    # entries of each breakdown list


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float            # seconds, on the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class TraceWindow:
    """What a per-layer metric reads (metrics/<name>.py: ``read(w)``)."""
    steps: int                          # steps of the device profile
    window_s: float                     # its wall time
    busy_s: float | None                # union of device activity in it
    device_ops: list[DeviceOp]          # device operations in it, by start
    counters: dict[str, int]            # wrapper launches in it
    host_steps: int                     # steps of the host profile
    launch_calls: int                   # CUDA launch API calls in it
    aten_ops: int                       # outermost aten ops in it
    params: object                      # reference.params.Params
    K: int                              # steps one temporal call advances
    dtype: str                          # storage dtype of f
    peaks: dict | None                  # the card's peaks (peaks.py)
    idle_gaps: list = field(default_factory=list)


def union_seconds(ranges) -> float:
    """Total length of the union of [start, end) intervals."""
    total, hi = 0.0, None
    for s, e in sorted(ranges):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def merged(ranges):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_launch(name: str) -> bool:
    """A CUDA launch API call: a kernel launch or a graph launch."""
    return "LaunchKernel" in name or "GraphLaunch" in name


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver API call (cudaLaunchKernel,
    cuLaunchKernel, ...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _raw(events):
    """(start s, end s, name, on the device, thread) of each event, in
    seconds from the first event (so a float keeps nanoseconds)."""
    from torch.autograd import DeviceType

    raw = [(e.start_ns(), e.duration_ns(), e.name(),
            e.device_type() == DeviceType.CUDA,
            e.start_thread_id() if hasattr(e, "start_thread_id") else 0)
           for e in events]
    if not raw:
        raise RuntimeError("the trace holds no events")
    base = min(r[0] for r in raw)
    return [((ns - base) * 1e-9, (ns - base + dur) * 1e-9, name, dev, tid)
            for ns, dur, name, dev, tid in raw]


def read_device(events):
    """The device operations of a device profile (CUDA activity alone,
    started and stopped between synchronises, so every operation in it
    belongs to the profiled intervals), sorted by start."""
    raw = _raw(events)
    host_names = {r[2] for r in raw if not r[3]}
    return sorted((DeviceOp(n, s, t) for s, t, n, dev, _ in raw
                   if dev and n not in host_names), key=lambda o: o.start)


def read_events(events, span_name=WINDOW_SPAN):
    """From the profiler's raw events (``prof.profiler.kineto_results.
    events()``): (span start, span end, the device operations in the span,
    the launch calls in it, its outermost aten ops, the host's top-level
    activities in it as sorted (start, end, name)); seconds on the
    profiler's clock from its first event.  Device operations are kernels,
    copies and memsets: a device event named as a host event is the
    profiler's device-side copy of a host span, and is left out."""
    raw = _raw(events)
    host_names = {r[2] for r in raw if not r[3]}
    spans, dev, cpu = [], [], []
    for s, t, name, on_device, tid in raw:
        if on_device:
            if name not in host_names:
                dev.append((s, t, name))
        elif name == span_name:
            spans.append((s, t))
        else:
            cpu.append((s, t, name, tid))
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} spans "
                           f"{span_name!r}, not one")
    lo, hi = spans[0]
    ops = sorted((DeviceOp(n, max(s, lo), min(t, hi)) for s, t, n in dev
                  if min(t, hi) > max(s, lo)), key=lambda o: o.start)
    cpu = [c for c in cpu if c[0] >= lo and c[1] <= hi]
    launches = sum(is_launch(c[2]) for c in cpu)
    # outermost aten ops: on each thread, an aten op that starts after the
    # last outermost one there has ended (profile_step's rule, by time)
    aten, last_end = [], {}
    for s, t, name, tid in sorted(
            (c for c in cpu if c[2].startswith("aten::")),
            key=lambda c: (c[0], c[0] - c[1])):
        if s >= last_end.get(tid, -1.0):
            aten.append((s, t, name))
            last_end[tid] = t
    starts = [a[0] for a in aten]
    host = list(aten)
    for s, t, name, tid in cpu:
        if _is_runtime(name):
            i = bisect.bisect_right(starts, s) - 1
            if i < 0 or aten[i][1] < t:     # not inside an aten op
                host.append((s, t, name))
    host.sort()
    return lo, hi, ops, launches, len(aten), host


def idle_gaps(lo, hi, ops, host):
    """The device's idle time in [lo, hi], summed by what the host was
    doing at the middle of each gap (its outermost aten op or CUDA runtime
    call, else Python between calls): [[name, seconds], ...], largest
    first, at most TOP."""
    busy = merged((o.start, o.end) for o in ops)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    starts = [h[0] for h in host]
    by = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        name = host[i][2] if i >= 0 and host[i][1] >= mid \
            else "host: Python between calls"
        by[name] = by.get(name, 0.0) + (e - s)
    return sorted(([n, v] for n, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def top_device_ops(ops):
    """Device time by operation name (the name up to its argument list),
    largest first, at most TOP: [[name, seconds], ...]."""
    by = {}
    for o in ops:
        name = short_name(o.name)
        by[name] = by.get(name, 0.0) + o.seconds
    return sorted(([n, v] for n, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def short_name(name: str, width: int = 160) -> str:
    """A device operation's name without its argument list, at most
    ``width`` characters: ``step_kernel<float, float, float, true, true>``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            s = s[:i]
            break
    return s[:width]
