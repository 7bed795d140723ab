"""The port's f64 mode on the card: accuracy over a whole beat and rate —
the port of scripts/probe_f64_tpu.py, legs ``fullbeat`` and ``rate2048``.

    python -m cuda_iblb_11_tpu_torch.probe_f64 [fullbeat|rate2048|all]
        [--device cuda|cpu] [--out PATH] [--json PATH]

  fullbeat  the f64 run of make_fullbeat_golden.py (100,000 steps at 192^2,
            4 cilia, raw storage, single-step: B2 in f64 on the card),
            against the JAX package's f64 CPU golden
            validation/fullbeat_f64_192sq.npz: velocity rel-L2 and flux
            relative difference, gated at <= 1e-8 each
            (tests/test_f64_tpu.py:103-104); the wall time of the first
            512 steps and of the rest, and the steady MLUPS.  The run's
            own npz goes where make_fullbeat_golden.py writes it.
  rate2048  steady f64 MLUPS at 2048^2 (16 cilia, raw storage) at temporal
            "auto" and at temporal 1, and f32 auto beside them: a first
            512-step window, then the rate over three more 512-step
            windows together (each window's seconds recorded); the
            velocity rel-L2 of each f64 run against the f32 auto run at
            2,048 steps, and of f64 auto against f64 single-step.

The JAX script's ``eft`` leg is not ported: it checks that error-free
transforms survive the TPU's f32x2 emulation of f64
(docs/DESIGN.md:338-379), and the H100 computes f64 natively.

The record goes to build/validation/f64.json by default, one entry per
leg, with the card's name and power limit and every simulation's
resolved_config().  The runs are on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cuda_iblb_11_tpu_torch import make_fullbeat_golden
from cuda_iblb_11_tpu_torch.accuracy_horizon import rel_l2, velocity
from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)
from cuda_iblb_11_tpu_torch.ops.probes import (
    VALIDATION_DIR, run_header, write_record,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GOLDEN = os.path.join(REPO, "validation", "fullbeat_f64_192sq.npz")
DEFAULT_JSON = os.path.join(VALIDATION_DIR, "f64.json")
GATE = 1e-8          # tests/test_f64_tpu.py:103-104
WINDOW = 512
WINDOWS = 3


def against_jax_golden(sim, state, path=JAX_GOLDEN) -> dict:
    """The run's velocity rel-L2 and flux relative difference against an
    f64 golden of the same steps in the JAX format (by default the JAX
    package's CPU golden)."""
    gold = np.load(path)
    u = velocity(sim, state).cpu().numpy()
    return {"golden": os.path.relpath(path, REPO),
            "steps": int(gold["steps"]),
            "vel_rel_l2": float(np.linalg.norm(u - gold["u"])
                                / np.linalg.norm(gold["u"])),
            "q_rel": abs(float(state.q) - float(gold["q"]))
            / abs(float(gold["q"]))}


def leg_fullbeat(device="cuda", golden=JAX_GOLDEN,
                 out=make_fullbeat_golden.DEFAULT_OUT) -> dict:
    gold = np.load(golden)
    steps = int(gold["steps"])
    sim, st, timing = make_fullbeat_golden.run(
        steps, device, out, c_num=int(gold["c_num"]),
        c_space=int(gold["c_space"]))
    cmp = against_jax_golden(sim, st, golden)
    rel, q_rel = cmp["vel_rel_l2"], cmp["q_rel"]
    print(f"[fullbeat] vel rel-L2 vs the JAX f64 golden: {rel:.3e}  q rel: "
          f"{q_rel:.3e}  ({timing['mlups_steady']} MLUPS steady, run "
          f"{timing['wall_s_run']:.0f} s)", flush=True)
    return dict(run_header(sim.device), steps=steps,
                grid=[sim.cfg.ydim, sim.cfg.xdim],
                golden=cmp["golden"],
                vel_rel_l2_vs_jax_f64=rel, q_rel_vs_jax_f64=q_rel,
                q=float(st.q), gate=GATE,
                passed=rel <= GATE and q_rel <= GATE,
                sim=sim.resolved_config(), reduced=[], **timing)


def _windows(sim):
    """(state after 1 + WINDOWS windows, first window s, the seconds of
    each later window)."""
    st = sim.init_state()
    t0 = time.perf_counter()
    st = sim.run_chunk(st, WINDOW)
    float(st.q)
    first = time.perf_counter() - t0
    timed = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        st = sim.run_chunk(st, WINDOW)
        float(st.q)
        timed.append(time.perf_counter() - t0)
    return st, first, timed


def leg_rate2048(device="cuda") -> dict:
    device = resolve_device(device)
    cfg64 = SimConfig(c_num=16, c_space=128, ydim=2048, dtype="float64",
                      storage="raw")
    steps = WINDOW * (1 + WINDOWS)
    runs, us, sims = {}, {}, {}
    for name, cfg, temporal in (
            ("f64_auto", cfg64, "auto"), ("f64_single_step", cfg64, 1),
            ("f32_auto", cfg64.replace(dtype="float32", storage="auto"),
             "auto")):
        sim = MucociliarySim(cfg, device=device, temporal=temporal)
        st, first, timed = _windows(sim)
        us[name] = velocity(sim, st)
        sims[name] = sim.resolved_config()
        runs[name] = dict(
            mlups_steady=cfg.size * WINDOW * WINDOWS / sum(timed) / 1e6,
            ms_per_step_steady=sum(timed) * 1e3 / (WINDOW * WINDOWS),
            wall_s_first_window=first, wall_s_windows=timed,
            finite=bool(torch.isfinite(st.f).all()))
        print(f"[rate2048] {name}: {runs[name]['mlups_steady']:.1f} MLUPS "
              f"over {WINDOWS} windows of {WINDOW} steps "
              f"({runs[name]['ms_per_step_steady']:.4f} ms/step; first "
              f"window {first:.2f} s)", flush=True)
        del sim, st
    errs = {"f64_auto_vs_f32_auto": rel_l2(us["f32_auto"], us["f64_auto"]),
            "f64_single_step_vs_f32_auto": rel_l2(us["f32_auto"],
                                                  us["f64_single_step"]),
            "f64_auto_vs_f64_single_step": rel_l2(us["f64_auto"],
                                                  us["f64_single_step"])}
    print(f"[rate2048] velocity rel-L2 at {steps} steps: {errs}", flush=True)
    return dict(run_header(device), grid=[cfg64.ydim, cfg64.xdim],
                window_steps=WINDOW, windows=WINDOWS, steps=steps,
                runs=runs, velocity_rel_l2=errs, sims=sims, reduced=[])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("leg", nargs="?", default="all",
                    choices=("fullbeat", "rate2048", "all"))
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--out", default=make_fullbeat_golden.DEFAULT_OUT,
                    help="where the fullbeat leg saves its own npz")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    if args.leg in ("fullbeat", "all"):
        write_record(args.json, "fullbeat",
                     leg_fullbeat(args.device, out=args.out))
    if args.leg in ("rate2048", "all"):
        write_record(args.json, "rate2048", leg_rate2048(args.device))
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
