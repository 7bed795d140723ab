"""One run of one cell: set-up, the measured window, the traced window, the
check and the result.

The window drives ``MucociliarySim.run_chunk`` as the runner's interval
loop calls it: one call per output interval, the flux read on the host at
each boundary (``float(state.q)``), whole intervals until the run's
seconds have passed, then a synchronise.  The rate (``mlups``) is the
grid's cells x every step of the window over the window's seconds.  With
``trace`` the window's first intervals are profiled (trace.py: the device
profile over the cell's ``trace_intervals``, then the host profile over
HOST_TRACE_INTERVALS), and the per-layer metrics are read from them.

Where each piece comes from: the configuration file (configs/<config>.json)
gives the model's parameters, the traffic file (traffic/<traffic>.json) how
it is run (temporal K, dtype, IB x-edge), the cell's file
(workloads/<cell>.json) the traced intervals, the control and the check's
limits; BENCHMARK.json names the cell's configuration, traffic and metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass

import torch

from iblb_benchmark import check, trace as tr
from iblb_benchmark.peaks import peaks_of
from iblb_benchmark.reference.inputs import first_step
from iblb_benchmark.reference.kinematics import Beat
from iblb_benchmark.reference.lbm import Reference, W
from iblb_benchmark.reference.params import Params

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in a run: JAX, and the JAX
# package with its benchmark script (cuda_iblb_11_tpu_torch is not it)
BANNED = ("jax", "jaxlib", "flax", "cuda_iblb_11_tpu", "bench")
# intervals of the host profile, after the device profile's (trace.py)
HOST_TRACE_INTERVALS = 1
SIM_FIELDS = ("c_fraction", "c_num", "c_space", "re", "t_num", "t_pow",
              "i_pow", "p_num", "length", "ydim", "flux_column_offset")


def _load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    spec: dict              # workloads/<name>.json
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of root/BENCHMARK.json with its files."""
    bench = _load_json(root, "BENCHMARK.json")
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if len(entry) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entry[0]
    config = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    return Cell(
        name=name, chips=entry["chips"],
        config=_load_json(root, config["file"]),
        traffic=_load_json(HERE, "traffic", entry["traffic"] + ".json"),
        spec=_load_json(HERE, "workloads", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_reader(name: str):
    """The module metrics/<name>.py (by path: a name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "iblb_benchmark.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_counter(ref: str) -> int:
    """``.launches`` of the program's wrapper "module:function"; a wrapper
    that is gone or counts nothing raises."""
    module, _, func = ref.partition(":")
    return int(getattr(importlib.import_module(module), func).launches)


class MissingMetric(RuntimeError):
    """A per-layer metric of the cell read nothing on the device."""


def read_per_layer(cell: Cell, readers: dict, window, required: bool):
    """{name: {value, unit}} of the cell's per-layer metrics.  A reader
    that finds nothing returns None and its metric is left out; where
    ``required`` (a run on the device, in a cell that BENCHMARK.json lists
    for every one of them) that raises MissingMetric naming it: a renamed
    kernel or wrapper would otherwise take a metric out of sight while the
    run still passed."""
    out, missing = {}, []
    for m in cell.per_layer:
        value = readers[m["name"]].read(window)
        if value is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    if missing and required:
        raise MissingMetric(
            f"read nothing in {cell.name}: {', '.join(missing)} (a kernel "
            f"or wrapper that counts/ and metrics/ name may have been "
            f"renamed or taken off the path)")
    return out


def banned_modules() -> list[str]:
    """The banned top-level modules loaded in this process, compared by
    whole top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_sim(cell: Cell, device, sim_overrides=None, dtype=None,
              temporal=None):
    """(the program's sim, Params) for the cell, as the runner builds it."""
    from cuda_iblb_11_tpu_torch.core.config import SimConfig
    from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim

    fields = {k: cell.config["sim"][k] for k in SIM_FIELDS}
    fields.update(sim_overrides or {})
    traffic = cell.traffic
    cfg = SimConfig(**fields, dtype=dtype or traffic["dtype"])
    model = cell.config["model"]
    sim = MucociliarySim(
        cfg, backend="cuda" if device.type == "cuda" else "torch",
        pattern=model["pattern"], forcing=model["forcing"],
        temporal=traffic["temporal"] if temporal is None else temporal,
        ib_x_edge=traffic["ib_x_edge"], device=device)
    return sim, Params(**fields)


def start_state(sim, p: Params, it0: int):
    """The program's FlowState at rest at iteration it0, made here: f in
    the sim's storage and dtype, no force, the cilia where step it0 - 1
    left them, no flux."""
    from cuda_iblb_11_tpu_torch.core.state import FlowState

    dev, aux = sim.device, sim.aux_dtype
    if sim.storage == "deviatoric":
        f = torch.zeros((9, p.ydim, p.xdim), dtype=sim.dtype, device=dev)
    else:
        w = torch.tensor(W, dtype=sim.dtype, device=dev)
        f = w[:, None, None].expand(9, p.ydim, p.xdim).contiguous()
    lasts = Beat(p, dev).positions(torch.tensor([max(it0 - 1, 0)]))[0]
    return FlowState(
        f=f, force=torch.zeros((2, p.band, p.xdim), dtype=aux, device=dev),
        lasts=lasts.to(aux), q=torch.zeros((), dtype=aux, device=dev),
        it=it0)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start=None,
        marks=(), device="cuda", sim_overrides=None, dtype=None,
        temporal=None, wrap=None) -> dict:
    """One run; the result's fields (run.py prints them).  ``marks``:
    (name, seconds since t_start) of set-up before this call.  The keywords
    after ``marks`` serve the tests and the control only: another
    device, configuration fields, dtype or temporal K, and ``wrap(sim)``
    to run a broken program in the sim's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    parts = list(marks) + [("start", time.perf_counter() - t_start)]
    torch.zeros(1, device=device)
    _sync(device)
    parts.append(("context", time.perf_counter() - t_start))
    sim, p = build_sim(cell, device, sim_overrides, dtype, temporal)
    if wrap is not None:
        sim = wrap(sim)
    interval = p.interval
    it0 = first_step(seed, p)
    s0 = start_state(sim, p, it0)
    _sync(device)
    parts.append(("sim", time.perf_counter() - t_start))

    # set-up: one interval of the cell's own path (the library's build or
    # load, every kernel and shape of the interval's super-steps and its
    # single-step remainder)
    s1 = sim.run_chunk(s0, interval)
    float(s1.q)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    # seconds from the start to: the marks before this call (run.py: the
    # interpreter up, torch imported, the devices counted, the program
    # imported), this call entered, the CUDA context made, the sim and
    # its start state built (the kernel library's load or build), the warm
    # interval done
    setup_parts = dict(parts + [("warm", setup_s)])

    readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer} \
        if trace else {}
    counter_refs = sorted({c for r in readers.values()
                           for c in getattr(r, "COUNTERS", ())})
    # the device profile's intervals, then the host profile's one
    n_dev = int(cell.spec["trace_intervals"]) if trace else 0
    n_traced = n_dev + HOST_TRACE_INTERVALS if trace else 0
    dev_prof = host_prof = span = None
    acts = torch.profiler.ProfilerActivity

    state, prev, intervals = s1, s1, 0
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        if intervals == 0 and n_traced:
            before = {c: read_counter(c) for c in counter_refs}
            if device.type == "cuda":
                dev_prof = torch.profiler.profile(activities=[acts.CUDA])
                dev_prof.start()
            _sync(device)
            t_dev = time.perf_counter()
        if intervals == n_dev and n_traced:
            t_host = time.perf_counter()
            host_prof = torch.profiler.profile(
                activities=[acts.CPU] + ([acts.CUDA]
                                         if device.type == "cuda" else []))
            host_prof.start()
            _sync(device)
            span = torch.profiler.record_function(tr.WINDOW_SPAN)
            span.__enter__()
        prev = state
        state = sim.run_chunk(state, interval)
        float(state.q)                      # the flux row's read
        intervals += 1
        if intervals == n_dev and n_traced:
            _sync(device)
            dev_s = time.perf_counter() - t_dev
            if dev_prof is not None:
                dev_prof.stop()
            counters = {c: read_counter(c) - before[c]
                        for c in counter_refs}
        if intervals == n_traced and n_traced:
            _sync(device)
            span.__exit__(None, None, None)
            host_s = time.perf_counter() - t_host
            host_prof.stop()
        ends.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds and intervals >= n_traced:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = intervals * interval

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    result = {"metrics": {}, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        window = _trace_window(
            dev_prof, host_prof, dev_s=dev_s, steps=n_dev * interval,
            host_steps=HOST_TRACE_INTERVALS * interval, p=p, sim=sim,
            kind=result["device"]["kind"], counters=counters)
        del dev_prof, host_prof
        result["metrics"] = read_per_layer(cell, readers, window,
                                           required=device.type == "cuda")
        if window.busy_s is not None:
            result["device"]["busy_s"] = window.busy_s
        result["device"]["window_s"] = window.window_s
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(window.device_ops),
            "idle_gaps": window.idle_gaps}
    else:
        # the cell's end-to-end metrics: its set-up, and its rate under the
        # name BENCHMARK.json gives it (MLUPS)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["unit"] == "MLUPS":
                value = p.cells * steps / window_s / 1e6
            else:
                raise ValueError(f"no measurement for {m['name']!r}")
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}

    # the check, after the window and the memory peak: the first interval
    # from the state made here, the window's last from the program's own
    t_check = time.perf_counter()
    ref = Reference(p, device, mask_dtype=sim.aux_dtype)
    first = check.interval_numbers(ref, s0, s1, sim.storage)
    del s0, s1
    last = check.interval_numbers(ref, prev, state, sim.storage)
    values = {k: max(first[k], last[k]) for k in check.NUMBERS}
    correct, checks = check.judge(values, cell.spec["limits"])
    result["correct"] = correct
    result["attempted"] = intervals
    result["failed"] = sum(not check.judge(v, cell.spec["limits"])[0]
                           for v in (first, last))
    result["run"] = {"seed": seed, "first_step": it0, "interval": interval,
                     "intervals": intervals, "steps": steps,
                     "traced_intervals": n_traced,
                     "window_s": window_s, "setup_s": setup_s,
                     "setup_parts": setup_parts,
                     # the intervals no profile covered, and the wall time
                     # of each profile's intervals (without the
                     # profiler's start and stop)
                     "interval_s": _quartiles([b - a for a, b in
                                               zip(ends, ends[1:])]
                                              [n_traced:]),
                     "device_profile_s": dev_s if trace else None,
                     "host_profile_s": host_s if trace else None,
                     "check_s": time.perf_counter() - t_check,
                     "first": first, "last": last,
                     "resolved": sim.resolved_config()}
    result["checks"] = checks
    return result


def _quartiles(values):
    """(least, first quartile, median, third quartile, most)."""
    if len(values) < 2:
        return [values[0]] * 5 if values else []
    q1, med, q3 = statistics.quantiles(values, n=4)
    return [min(values), q1, med, q3, max(values)]


def _trace_window(dev_prof, host_prof, dev_s, steps, host_steps, p, sim,
                  kind, counters):
    """The TraceWindow of the two profiles (trace.py); without a device,
    no device profile, and the wall time of its intervals alone."""
    ops = tr.read_device(dev_prof.profiler.kineto_results.events()) \
        if dev_prof is not None else []
    lo, hi, host_ops, launches, aten, host = tr.read_events(
        host_prof.profiler.kineto_results.events())
    return tr.TraceWindow(
        steps=steps, window_s=dev_s,
        busy_s=tr.union_seconds((o.start, o.end) for o in ops)
        if ops else None,
        device_ops=ops, counters=counters, host_steps=host_steps,
        launch_calls=launches, aten_ops=aten, params=p, K=sim.temporal,
        dtype=str(sim.dtype).replace("torch.", ""), peaks=peaks_of(kind),
        idle_gaps=tr.idle_gaps(lo, hi, host_ops, host))
