"""The traced window's arithmetic on made-up profiler events: the span,
the device operations in it (not the profiler's device copy of a host
span), the union of device time, launch calls, outermost aten ops, the
idle gaps by host activity and the top device operations."""

import pytest
from torch.autograd import DeviceType

from iblb_benchmark import trace as tr


class _E:
    def __init__(self, name, kind, start, dur, dev=DeviceType.CPU, tid=1):
        self._v = (name, kind, int(start * 1000), int(dur * 1000), dev, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


G = DeviceType.CUDA
EVENTS = [
    _E("before", "cpu_op", 0, 5),                       # outside the span
    _E(tr.WINDOW_SPAN, "user_annotation", 10, 100),
    _E(tr.WINDOW_SPAN, "gpu_user_annotation", 10, 100, G),
    _E("aten::add", "cpu_op", 12, 10),
    _E("aten::empty", "cpu_op", 13, 2),                 # nested: not counted
    _E("cudaLaunchKernel", "cuda_runtime", 15, 3),      # under aten::add
    _E("cudaLaunchKernel", "cuda_runtime", 30, 4),      # ctypes launch
    _E("cudaGraphLaunch", "cuda_runtime", 40, 2),
    _E("aten::matmul", "cpu_op", 60, 30),
    _E("cuLaunchKernel", "cuda_driver", 70, 1),
    _E("void (anonymous namespace)::k<float>(A)", "kernel", 20, 10, G),
    _E("void (anonymous namespace)::k<float>(A)", "kernel", 25, 10, G),
    _E("gemm", "kernel", 80, 20, G),
    _E("Memset (Device)", "gpu_memset", 105, 10, G),   # clipped at 110
]


def test_read_events():
    lo, hi, ops, launches, aten, host = tr.read_events(EVENTS)
    assert (lo, hi) == (pytest.approx(10e-6), pytest.approx(110e-6))
    assert [o.name for o in ops][-1] == "Memset (Device)"
    assert len(ops) == 4 and ops[-1].end == pytest.approx(110e-6)
    assert launches == 4
    assert aten == 2
    assert [h[2] for h in host] == ["aten::add", "cudaLaunchKernel",
                                    "cudaGraphLaunch", "aten::matmul"]
    busy = tr.union_seconds((o.start, o.end) for o in ops)
    assert busy == pytest.approx((15 + 20 + 5) * 1e-6)
    gaps = dict(tr.idle_gaps(lo, hi, ops, host))
    # idle: 10-20 (aten::add), 35-80 (mid 57.5: between calls),
    # 100-105 (mid 102.5: between calls)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["host: Python between calls"] == pytest.approx(50e-6)
    top = tr.top_device_ops(ops)
    assert top[0] == ["k<float>", pytest.approx(20e-6)]   # summed


def test_read_device():
    """A device profile: every device operation, by start, less the
    profiler's device copy of a host span; host events left out."""
    events = [e for e in EVENTS if e.name() != "before"]
    ops = tr.read_device(events)
    assert [o.name for o in ops] == [
        "void (anonymous namespace)::k<float>(A)",
        "void (anonymous namespace)::k<float>(A)", "gemm",
        "Memset (Device)"]
    assert ops[-1].end == pytest.approx(105e-6)       # not clipped
    assert tr.union_seconds((o.start, o.end) for o in ops) \
        == pytest.approx((15 + 20 + 10) * 1e-6)


def test_one_span_only():
    with pytest.raises(RuntimeError):
        tr.read_events(EVENTS[3:])


def test_short_name():
    assert tr.short_name("void (anonymous namespace)::step_kernel<float, "
                         "float, float, true, true>((anonymous namespace)::"
                         "StepArgs<float>)") \
        == "step_kernel<float, float, float, true, true>"
    assert tr.short_name("x" * 300) == "x" * 160
