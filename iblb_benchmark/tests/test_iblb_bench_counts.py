"""The frozen counts equal chip_smoke.py's KernelCase counts at the cells'
shapes (meta tensors: nothing is allocated), and the roofline readers'
attribution of device operations to B2, B4 and B5."""

import json
import os
import sys

import pytest
import torch

from iblb_benchmark import harness, peaks
from iblb_benchmark.counts import b4, b5, kernel_name
from iblb_benchmark.metrics import roofline
from iblb_benchmark.reference.params import Params
from iblb_benchmark.trace import DeviceOp, TraceWindow

ROOT = harness.ROOT


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _cell_shapes():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    out = []
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        out.append((w["name"], cell.config["sim"], cell.traffic["dtype"]))
    return out


@pytest.mark.parametrize("name,sim,dtype", _cell_shapes())
def test_frozen_counts_equal_chip_smoke(name, sim, dtype):
    cs = _smoke()
    from cuda_iblb_11_tpu_torch.core.config import SimConfig
    from cuda_iblb_11_tpu_torch.ops.reference import REFERENCE_WALLS
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_auto

    fields = {k: sim[k] for k in harness.SIM_FIELDS}
    cfg = SimConfig(**fields, dtype=dtype)
    p = Params(**fields)
    tdt = getattr(torch, dtype)
    storage = cfg.storage_resolved
    f = torch.empty((9, cfg.ydim, cfg.xdim), dtype=tdt, device="meta")
    aux = torch.promote_types(tdt, torch.float32)
    force = torch.empty((2, cfg.force_band, cfg.xdim), dtype=aux,
                        device="meta")
    assert p.band == cfg.force_band
    plan, _ = plan_auto(cfg, REFERENCE_WALLS, tdt, "no_mucus", "periodic")
    kc = cs.case_b4(cfg, plan, f, REFERENCE_WALLS, storage)
    assert b4.counts(p, plan.K, dtype) == (kc.nbytes, kc.nflop)
    if plan.pad_s is not None:
        assert plan.pad_s == plan.K
        assert b5.counts(p, plan.K, dtype) == cs.band_super_counts(
            cfg, plan, *cs.sizes(f))


def test_kernel_names():
    assert kernel_name("void (anonymous namespace)::step_kernel<float, "
                       "float, float, true, true>((anonymous namespace)::"
                       "StepArgs<float>)") == "step_kernel"
    assert kernel_name("void (anonymous namespace)::column_sum_kernel<"
                       "double, true>(double const*, int)") \
        == "column_sum_kernel"
    assert kernel_name("sm80_xmma_gemm_tn") == "sm80_xmma_gemm_tn"


def _ops(names):
    return [DeviceOp(f"void (anonymous namespace)::{n}<float>(Args)",
                     float(i), float(i) + 0.5) for i, n in enumerate(names)]


# two B5 calls at K = 2, a B4 call of two passes, two single steps with a
# GEMM between (neither B4's nor B5's)
SEQ = (["step_kernel", "interp_kernel", "spread_kernel"] * 2
       + ["column_sum_kernel"]) * 2 \
    + ["kstep_kernel", "kstep_kernel", "column_sum_kernel"] \
    + ["step_kernel", "gemm", "step_kernel"]


def test_attribution():
    ops = _ops(SEQ)
    assert b5.device_seconds(ops) == 0.5 * 14
    assert b4.device_seconds(ops) == 0.5 * 3


def _window(counters, ops, dtype="float32", sim=None):
    """A synthetic device window of 1,000 steps at the configuration
    ``sim`` (the first cell's by default)."""
    if sim is None:
        sim = _cell_shapes()[0][1]
    p = Params.from_sim(sim)
    return TraceWindow(steps=1000, window_s=1.0, busy_s=0.5, device_ops=ops,
                       counters=counters, host_steps=1000, launch_calls=0,
                       aten_ops=0,
                       params=p, K=16, dtype=dtype,
                       peaks=peaks.peaks_of("NVIDIA H100 80GB HBM3"))


def test_roofline_shares():
    ops = [DeviceOp("void (anonymous namespace)::kstep_kernel<float, float,"
                    " float>(KStepArgs<float>)", 0.0, 1e-3)]
    w = _window({b4.COUNTER: 2}, ops)
    nbytes, nflop = b4.counts(w.params, 16, "float32")
    bound = max(nbytes / 3.35e12, nflop / 67e12)
    assert roofline(w, b4) == pytest.approx(100 * bound / 0.5e-3)
    # no calls, no device time, or no peaks: nothing to read
    assert roofline(_window({}, ops), b4) is None
    assert roofline(_window({b4.COUNTER: 2}, []), b4) is None
    w.peaks = None
    assert roofline(w, b4) is None
    # f64 takes the f64 operation peak
    w64 = _window({b4.COUNTER: 2}, ops, "float64")
    nbytes, nflop = b4.counts(w64.params, 16, "float64")
    assert roofline(w64, b4) == pytest.approx(
        100 * max(nbytes / 3.35e12, nflop / 34e12) / 0.5e-3)


def _roofline_cells():
    """The cells that report a kernel's roofline."""
    return [name for name, _, _ in _cell_shapes()
            if any(m["name"].endswith("_roofline")
                   for m in harness.load_cell(name).per_layer)]


@pytest.mark.parametrize("name", _roofline_cells())
def test_a_metric_that_reads_nothing_on_the_device_fails_the_run(name):
    """A kernel renamed or taken off the path: its roofline reads nothing,
    and a run on the device stops naming it; on the CPU (no device) the
    metric is only left out.  The metrics read from the program's spans
    (source program_span) find no spans in a synthetic window, by design,
    and are left out of what has to read."""
    cell = harness.load_cell(name)
    readers = {m["name"]: harness.load_reader(m["name"])
               for m in cell.per_layer}
    counters = {r: 3 for r in (b4.COUNTER, b5.COUNTER)}
    w = _window(counters, _ops(["gemm"]), cell.traffic["dtype"],
                cell.config["sim"])          # no kernel of B4/B5
    rooflines = {m["name"] for m in cell.per_layer
                 if m["name"].endswith("_roofline")}
    spans = {m["name"] for m in cell.per_layer
             if m["source"] == "program_span"}
    assert rooflines
    with pytest.raises(harness.MissingMetric) as e:
        harness.read_per_layer(cell, readers, w, required=True)
    missing = str(e.value).split(": ", 1)[1].split(" (")[0].split(", ")
    assert set(missing) == rooflines | spans
    out = harness.read_per_layer(cell, readers, w, required=False)
    assert set(out) == {m["name"] for m in cell.per_layer} \
        - rooflines - spans


def test_a_counter_that_is_gone_raises():
    with pytest.raises(AttributeError):
        harness.read_counter("cuda_iblb_11_tpu_torch.ops.fused_step:gone")
    with pytest.raises(ImportError):
        harness.read_counter("cuda_iblb_11_tpu_torch.ops.gone:fused_substep")
    assert harness.read_counter(b4.COUNTER) >= 0
