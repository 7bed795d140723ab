"""The band super-step's legs that a footprint budget decides between,
measured against each other on the card.

    python -m cuda_iblb_11_tpu_torch.probe_legs [--pairs NAME,...]
        [--json PATH]

Each pair runs one configuration (K = 16) on two plans: the plan without
a budget (the whole band super-step, or B8 on the whole x-shard block of
a mesh) and the plan held to the card's L2 size as a budget (the x-tiled
B6, or the per-sub-step leg of a mesh):

    8192x8192_f32       64 cilia: B5 whole against B6 (tile 1,024)
    2048x2048_f64       16 cilia: B5 whole against B6 (tile 256)
    8192x8192_f64       64 cilia: B5 whole against B6
    8192x8192_mesh2x2   64 cilia, f32, (2, 2) on the one card:
                        band_super_xsharded (B8 + B7) against
                        per_substep_tiled (B3 + B0 + the torch IB + B7)

The two legs run in turns, whole, budgeted, budgeted, whole; each turn is
profile_step.profile_sim (a warm-up, an unprofiled run for the wall time,
a profiled run for the device time), with the peak memory of the turn.
Reported per turn: wall ms/step, device-busy ms/step and per super-step
(one call of the band leg plus the bulk), the idle share, kernels per
step, the top device kernels and the peak GB; per pair, the velocity
rel-L2 between the legs after the same steps.  Where no card is visible it
raises.  Output: build/probe_legs.json by default; the last line of
standard output is the record.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu_torch.ops import probes
from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded, plan_temporal
from cuda_iblb_11_tpu_torch.parallel import ShardedTemporalSim, make_mesh
from cuda_iblb_11_tpu_torch.profile_step import profile_sim

K = 16
# name -> (c_num, ydim, dtype, mesh or None, steps); c_space 128
PAIRS = {
    "8192x8192_f32": (64, 8192, "float32", None, 32),
    "2048x2048_f64": (16, 2048, "float64", None, 64),
    "8192x8192_f64": (64, 8192, "float64", None, 32),
    "8192x8192_mesh2x2": (64, 8192, "float32", (2, 2), 32),
}
DEFAULT_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "probe_legs.json")


def leg_sims(name, device, budget, backend="cuda"):
    """{"whole": sim, "budgeted": sim} of pair `name`: one configuration
    on the plan without a budget and on the plan held to `budget`
    (backend "torch" runs the plain versions, for the CPU tests)."""
    c_num, ydim, dtype, mesh, _ = PAIRS[name]
    cfg = SimConfig(c_num=c_num, c_space=128, ydim=ydim, dtype=dtype)
    sims = {}
    for leg, b in (("whole", None), ("budgeted", budget)):
        if mesh is None:
            sim = MucociliarySim(cfg, backend=backend, device=device,
                                 temporal=K)
            sim.plan = plan_temporal(cfg, K, sim.walls, sim.dtype,
                                     budget=b)
        else:
            sim = ShardedTemporalSim(cfg, make_mesh(*mesh, devices=[device]),
                                     temporal=K, backend=backend)
            sim.plan = plan_sharded(cfg, K, *mesh, sim.walls, sim.dtype,
                                    budget=b)
            sim._kernel_path = sim.plan.band_leg
        sims[leg] = sim
    return sims


def _velocity(sim, steps):
    return sim.fields(sim.run_chunk(sim.init_state(), steps))[1]


def measure_pair(name, device, budget) -> dict:
    """The two legs of pair `name` in turns (module docstring)."""
    steps = PAIRS[name][4]
    sims = leg_sims(name, device, budget)
    plans = {leg: sim.plan for leg, sim in sims.items()}
    turns = []
    for leg in ("whole", "budgeted", "budgeted", "whole"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        row = profile_sim(sims[leg], steps)
        row.update(leg=leg, band_leg=plans[leg].band_leg,
                   device_ms_per_super_step=row["device_busy_ms"] * K,
                   peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        turns.append(row)
        print(f"  {name} {leg} ({row['band_leg']}): wall "
              f"{row['wall_ms']:.4f} ms/step, device "
              f"{row['device_busy_ms']:.4f} ms/step "
              f"({row['device_ms_per_super_step']:.4f} per super-step), "
              f"idle {row['idle_share']:.3f}, "
              f"{row['device_kernels']:.1f} kernels/step, peak "
              f"{row['peak_gb']:.2f} GB", flush=True)
    us = {leg: _velocity(sim, steps) for leg, sim in sims.items()}
    rel = float(torch.linalg.norm((us["whole"] - us["budgeted"]).double())
                / torch.linalg.norm(us["budgeted"].double()))
    print(f"  {name}: velocity rel-L2 whole vs budgeted after {steps} "
          f"steps {rel:.3e}", flush=True)
    return dict(pair=name, steps=steps, K=K, budget=budget,
                plans={leg: str(p) for leg, p in plans.items()},
                turns=turns, velocity_rel_l2=rel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", default=",".join(PAIRS),
                    help=f"comma-separated, of {', '.join(PAIRS)}")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    device = probes.require_card("probe_legs")
    budget = probes.l2_bytes(device)
    record = dict(card=probes.card_line(), torch=torch.__version__,
                  l2_bytes=budget, pairs=[])
    print(f"card: {record['card']}; L2 {budget} bytes", flush=True)
    for name in args.pairs.split(","):
        record["pairs"].append(measure_pair(name, device, budget))
        torch.cuda.empty_cache()
    line = json.dumps(record)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
