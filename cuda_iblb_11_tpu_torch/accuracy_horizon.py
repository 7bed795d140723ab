"""Long-horizon accuracy of the port — the port of
scripts/accuracy_horizon.py.

    python -m cuda_iblb_11_tpu_torch.accuracy_horizon [LEG ...]
        [--device cuda|cpu] [--json PATH]

Each leg advances its simulations in lockstep and, at every horizon,
records the velocity rel-L2 and the cumulative-flux relative difference of
every pair (each later simulation against each earlier one), then fits
err ~ a * steps^p per pair:

  192sq  192^2, 4 cilia, horizons 500 to 20,000 (the JAX ``cpu`` leg);
  full   the same grid over the reference's whole beat, 100,000 steps
         (``cpu_full``; probe_f64.py's fullbeat leg holds the f64 beat
         against the JAX golden);
  mid    384 x 192, 8 cilia, horizons 5,000 to 100,000 (``cpu_mid``);
  2048   2048^2, 16 cilia, horizons 512 to 32,768 (the JAX ``tpu`` leg):
         temporal "auto" (K = 16, the whole band super-step, B5 + B4)
         against temporal 1 (B2), both f32.

In 192sq, full and mid the reference is the f64 run in raw storage,
single-step (B2 in f64 on the card), and two f32 runs (storage "auto")
walk beside it: temporal 1 (B2, the JAX pair) and temporal "auto" (the
CLI's default path: at 192^2 the per-sub-step leg, B3 + the torch IB + B4;
at 384 x 192 the whole band super-step).  Every simulation's
resolved_config() goes into the record.

The helpers (velocity, rel_l2, fit_power, walk) are the other validation
modules' too.  The record goes to
build/validation/accuracy_horizon.json by default, one entry per leg,
merged into what the file holds; run_leg's ``horizons`` replaces a leg's
own (a shakedown run, listed under the entry's ``reduced``).  The
simulations run on the card unless --device cpu is given; without a card
the cuda device raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)
from cuda_iblb_11_tpu_torch.ops import ib_band, probes
from cuda_iblb_11_tpu_torch.ops import reference as ref

DEFAULT_JSON = os.path.join(probes.VALIDATION_DIR, "accuracy_horizon.json")

# leg -> (SimConfig keywords, horizons, label); scripts/accuracy_horizon.py
LEGS = {
    "192sq": (dict(c_num=4, c_space=48),
              (500, 1000, 2000, 4000, 8000, 12000, 20000),
              "192sq_f32_vs_f64"),
    "full": (dict(c_num=4, c_space=48),
             (500, 1000, 2000, 4000, 8000, 12000, 20000, 35000, 50000,
              70000, 100000),
             "full_192sq_f32_vs_f64"),
    "mid": (dict(c_num=8, c_space=48), (5000, 20000, 50000, 100000),
            "mid_384x192_f32_vs_f64"),
    "2048": (dict(c_num=16, c_space=128, ydim=2048),
             (512, 2048, 8192, 32768), "2048sq_auto_vs_single"),
}


def velocity(sim, state):
    """The corrected velocity [2, Y, X] in f64, from f and the padded band
    force (scripts/accuracy_horizon.py:66-75)."""
    force = ib_band.pad_band(state.force, sim.cfg.ydim)
    _, u = ref.corrected_velocity(state.f.double(), force.double(),
                                  sim.storage)
    return u


def rel_l2(u, u_ref) -> float:
    return float(torch.linalg.norm(u - u_ref) / torch.linalg.norm(u_ref))


def fit_power(horizons, errs):
    """(a, p) of err ~ a * n^p (least squares in log space)."""
    x = np.log(np.asarray(horizons, float))
    y = np.log(np.asarray(errs, float))
    p, loga = np.polyfit(x, y, 1)
    return float(np.exp(loga)), float(p)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def walk(sims, horizons, label):
    """Advance every simulation of ``sims`` (name -> sim, the reference
    first) in lockstep to each horizon; at each, one velocity row and one
    flux row per pair (each later simulation against each earlier one).
    Returns (rows, the final states by name)."""
    names = list(sims)
    states = {k: s.init_state() for k, s in sims.items()}
    rows, it = [], 0
    for n in horizons:
        t0 = time.perf_counter()
        for k, s in sims.items():
            states[k] = s.run_chunk(states[k], n - it)
        for s in sims.values():
            _sync(s.device)
        it = n
        us = {k: velocity(sims[k], states[k]) for k in names}
        qs = {k: float(states[k].q) for k in names}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                e = rel_l2(us[b], us[a])
                qd = abs(qs[b] - qs[a]) / max(abs(qs[a]), 1e-30)
                rows.append({"pair": f"{b}_vs_{a}", "steps": n,
                             "rel_l2": e, "label": label})
                rows.append({"pair": f"{b}_vs_{a}_flux", "steps": n,
                             "rel_l2": qd, "label": label})
                print(f"[{label}] n={n} {b} vs {a}: u rel-L2={e:.3e}  "
                      f"q rel={qd:.2e}", flush=True)
        print(f"[{label}] n={n} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    return rows, states


def fits(rows):
    """The power-law fit of every pair with three or more positive rows."""
    out = {}
    for pair in sorted({r["pair"] for r in rows}):
        hs = [r["steps"] for r in rows if r["pair"] == pair]
        es = [r["rel_l2"] for r in rows if r["pair"] == pair]
        if len(hs) >= 3 and min(es) > 0:
            a, p = fit_power(hs, es)
            out[pair] = {"a": a, "p": p}
            print(f"fit {pair}: err ~ {a:.3e} * n^{p:.2f}", flush=True)
    return out


def leg_sims(leg, device):
    """The simulations of ``leg``, the reference first."""
    kw = LEGS[leg][0]
    if leg == "2048":
        cfg = SimConfig(dtype="float32", **kw)
        return {"single_step_f32": MucociliarySim(cfg, device=device),
                "temporal_auto": MucociliarySim(cfg, device=device,
                                                temporal="auto")}
    cfg64 = SimConfig(dtype="float64", storage="raw", **kw)
    cfg32 = cfg64.replace(dtype="float32", storage="auto")
    return {"f64_oracle": MucociliarySim(cfg64, device=device),
            "f32": MucociliarySim(cfg32, device=device),
            "f32_auto": MucociliarySim(cfg32, device=device,
                                       temporal="auto")}


def run_leg(leg, device="cuda", horizons=None) -> dict:
    """One leg's record entry (module doc)."""
    device = resolve_device(device)
    _, default, label = LEGS[leg]
    horizons = tuple(horizons or default)
    sims = leg_sims(leg, device)
    t0 = time.perf_counter()
    rows, _ = walk(sims, horizons, label)
    entry = dict(probes.run_header(device), rows=rows, fits=fits(rows),
                 horizons=list(horizons), wall_s=time.perf_counter() - t0,
                 grid=[sims[next(iter(sims))].cfg.ydim,
                       sims[next(iter(sims))].cfg.xdim],
                 sims={k: s.resolved_config() for k, s in sims.items()},
                 reduced=[] if horizons == default else [
                     f"horizons {list(horizons)} instead of "
                     f"{list(default)}"])
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("legs", nargs="*", default=["192sq"],
                    help=f"of {', '.join(LEGS)} (default 192sq)")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    for leg in args.legs:
        if leg not in LEGS:
            ap.error(f"unknown leg {leg!r} ({', '.join(LEGS)})")
    for leg in args.legs:
        probes.write_record(args.json, leg, run_leg(leg, args.device))
        print(f"wrote {leg} to {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
