"""Where the time of one step goes: host wall time against device time.

    python -m cuda_iblb_11_tpu_torch.profile_step [--grids 288x192,2048x2048]
        [--steps 64] [--temporal K|auto] [--mesh Y,X]
        [--dtype float32|float64|bfloat16] [--ib-x-edge periodic|reference]
        [--out PATH]

(grids: 288x192, 2048x2048, and 8192x8192 with 64 cilia).

For each grid it builds ``MucociliarySim`` on the card (f32 unless
--dtype says, the hand kernels, temporal K as asked: 1 by default, the
single-step path; --ib-x-edge reference for the quirk mode), or with
--mesh the sharded sim the runner resolves for that mesh over the visible
cards (shards share a card when there are fewer), warms
it up with the same steps, then times ``steps`` steps from the initial
state on the host clock without the profiler, recording the model step's
host spans (utils/spans.py), and runs the same steps again under
``torch.profiler``, timed on the host clock between synchronises.  It
reports, per step:

    wall_ms            host wall time of the unprofiled run
    host_us_per_step   {span name: host time inside it, in us}, from the
                       unprofiled run's spans (a span's time includes its
                       children's)
    profiled_wall_ms   host wall time of the profiled run
    device_busy_ms     union of all device activity (kernels, memsets,
                       copies) in the profiled run; None without a card
    idle_share         1 - device_busy_ms / profiled_wall_ms: busy and
                       wall from the same run
    device_kernels     device kernels launched
    launch_calls       cudaLaunchKernel-family runtime calls
    aten_ops           outermost aten ops (the eager op count)
    top_kernels        the device kernels with the most time, ms each

The last line of standard output is the JSON record; ``--out`` writes it
to a file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu_torch.ops import probes
from cuda_iblb_11_tpu_torch.runner import _make_mesh_sim
from cuda_iblb_11_tpu_torch.utils import spans

# name -> (c_num, c_space, ydim); SimConfig's defaults otherwise
GRIDS = {"288x192": (6, 48, 192), "2048x2048": (16, 128, 2048),
         "8192x8192": (64, 128, 8192)}
TOP_KERNELS = 6


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union_us(ranges):
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


def _is_outermost_aten(evt):
    if not evt.name.startswith("aten::"):
        return False
    p = evt.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


def profile_sim(sim: MucociliarySim, steps: int) -> dict:
    """The per-step breakdown of ``steps`` steps of ``sim`` (module doc)."""
    dev = sim.device
    # warm-up: the same steps, so every kernel and every batched shape of
    # the timed run has run once
    sim.run_chunk(sim.init_state(), steps)
    _sync(dev)
    st = sim.init_state()
    spans.start()
    try:
        t0 = time.perf_counter()
        sim.run_chunk(st, steps)
        _sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    finally:
        spans.stop()
    host_us = {}
    for r in spans.records():
        host_us[r.name] = host_us.get(r.name, 0.0) + r.ns / 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        sim.run_chunk(st, steps)
        _sync(dev)
        profiled_wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    events = prof.events()
    device_evts = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = None
    top = []
    if device_evts:
        busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                             for e in device_evts]) / 1e3 / steps
        per_name = {}
        for e in device_evts:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us())
        top = [dict(name=n[:120], ms=us / 1e3 / steps) for n, us in
               sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]]
    cpu_evts = [e for e in events if e.device_type == DeviceType.CPU]
    return dict(
        steps=steps,
        wall_ms=wall_ms,
        host_us_per_step=host_us,
        profiled_wall_ms=profiled_wall_ms,
        device_busy_ms=busy_ms,
        idle_share=(None if busy_ms is None
                    else 1.0 - busy_ms / profiled_wall_ms),
        device_kernels=len(device_evts) / steps,
        launch_calls=sum("LaunchKernel" in e.name for e in cpu_evts) / steps,
        aten_ops=sum(_is_outermost_aten(e) for e in cpu_evts) / steps,
        top_kernels=top,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="288x192,2048x2048",
                    help=f"comma-separated, of {', '.join(GRIDS)}")
    ap.add_argument("--steps", type=int, default=64,
                    help="steps per run; a multiple of K keeps the temporal "
                         "path free of single-step remainders")
    ap.add_argument("--temporal", default="1",
                    help="K, or 'auto' (the CLI's default)")
    ap.add_argument("--mesh", default=None, metavar="Y,X",
                    help="profile the sharded path on a Y,X mesh")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"],
                    help="state precision (bfloat16: bf16 storage, f32 "
                         "arithmetic)")
    ap.add_argument("--ib-x-edge", default="periodic",
                    choices=["periodic", "reference"],
                    help="'reference' profiles the quirk mode")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    temporal = args.temporal if args.temporal == "auto" \
        else int(args.temporal)
    record = dict(card=probes.card_line() if torch.cuda.is_available()
                  else None, torch=torch.__version__, rows=[])
    print(f"card: {record['card']}", flush=True)
    for name in args.grids.split(","):
        c, s, y = GRIDS[name]
        cfg = SimConfig(c_num=c, c_space=s, ydim=y, dtype=args.dtype)
        if args.mesh:
            sim = _make_mesh_sim(cfg, "cuda", "trt_split", temporal,
                                 args.mesh, args.ib_x_edge, "no_mucus",
                                 torch.device("cuda"))
        else:
            sim = MucociliarySim(cfg, backend="cuda", device="cuda",
                                 temporal=temporal, ib_x_edge=args.ib_x_edge)
        rc = sim.resolved_config()
        row = dict(grid=name, mesh=rc["mesh"], temporal=rc["temporal"],
                   band_leg=rc["band_leg"], dtype=rc["dtype"],
                   ib_path=rc["ib_path"], **profile_sim(sim, args.steps))
        record["rows"].append(row)
        busy = row["device_busy_ms"]
        print(f"{name} {row['dtype']} {row['ib_path']} mesh={row['mesh']} "
              f"K={row['temporal']} {row['band_leg']}: wall "
              f"{row['wall_ms']:.4f} ms/step, device busy "
              f"{'not measured' if busy is None else f'{busy:.4f} ms'} of "
              f"{row['profiled_wall_ms']:.4f} profiled, "
              f"{row['device_kernels']:.1f} kernels, "
              f"{row['launch_calls']:.1f} launch calls, "
              f"{row['aten_ops']:.1f} aten ops per step", flush=True)
        for k in row["top_kernels"]:
            print(f"    {k['ms']:.4f} ms  {k['name']}", flush=True)
        print("    host us/step: " + ", ".join(
            f"{n} {us:.2f}" for n, us in row["host_us_per_step"].items()),
            flush=True)
        del sim
    line = json.dumps(record)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
