"""Lid-driven cavity sweep against Ghia, Ghia & Shin (1982) — the port of
scripts/validate_cavity.py.

    python -m cuda_iblb_11_tpu_torch.validate_cavity [--device cuda|cpu]
        [--json PATH]

Re 100 / 400 / 1000 on grids of 64 / 96 / 128 cells with 30,000 / 80,000 /
200,000 steps (scripts/validate_cavity.py:44), lid speed 0.1.  The cavity
runs the plain torch step of ops/reference.py (models/cavity.py: no kernel
takes its moving lid and walls in x) under ops/precision.full_f32, the
counterpart of the JAX script's "highest" matmul precision (:53), in f32:
the JAX sweep ran its default dtype without x64, that is, f32.
Recorded per Re: max |u_x - Ghia| on the vertical centreline in lid units
(``max_dev_ux``), the centreline at Ghia's y, tau, the wall time, and the
gate of the port's acceptance (0.02 / 0.02 / 0.03 lid units).
sweep's ``steps_scale`` shortens every run (a shakedown, listed under
``reduced``).  The record goes to build/validation/cavity_metrics.json by
default; the runs are on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.models.cavity import LidDrivenCavity
from cuda_iblb_11_tpu_torch.models.mucociliary import resolve_device
from cuda_iblb_11_tpu_torch.ops.probes import (
    VALIDATION_DIR, run_header, write_record,
)

DEFAULT_JSON = os.path.join(VALIDATION_DIR, "cavity_metrics.json")
U_LID = 0.1

# Ghia, Ghia & Shin (1982), u_x on the vertical centreline at y/N
GHIA = {
    100: ((0.0625, 0.1016, 0.2813, 0.4531, 0.6172, 0.7344, 0.9531),
          (-0.04192, -0.06434, -0.15662, -0.21090, -0.13641, 0.00332,
           0.68717)),
    400: ((0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609),
          (-0.09266, -0.24299, -0.32726, -0.17119, -0.11477, 0.02135,
           0.61756)),
    1000: ((0.0625, 0.1719, 0.2813, 0.4531, 0.5, 0.6172, 0.9609),
           (-0.18109, -0.38289, -0.27805, -0.10648, -0.06080, 0.05702,
            0.51117)),
}
RUNS = {100: (64, 30000), 400: (96, 80000), 1000: (128, 200000)}
GATES = {100: 0.02, 400: 0.02, 1000: 0.03}    # lid units


def run_case(re_n, n, steps, dtype=torch.float32, device="cuda") -> dict:
    """One Re: the cavity run and its centreline against Ghia."""
    cav = LidDrivenCavity(n=n, re=float(re_n), u_lid=U_LID, dtype=dtype,
                          device=device)
    t0 = time.perf_counter()
    f = cav.run(cav.init_f(), steps)
    ux, _ = cav.centreline_profiles(f)
    ux = ux.double().cpu().numpy()
    wall = time.perf_counter() - t0
    y = (np.arange(n) + 0.5) / n
    gy, gux = GHIA[re_n]
    ux_i = np.interp(gy, y, ux)
    dev = float(np.max(np.abs(ux_i - np.asarray(gux))))
    print(f"Re={re_n} (N={n}, tau={cav.tau:.4f}, {steps} steps): "
          f"max|ux - Ghia| = {dev:.4f} lid units ({wall:.0f} s)", flush=True)
    return {"grid": n, "steps": steps, "tau": cav.tau, "max_dev_ux": dev,
            "ux_centreline_at_ghia_y": [float(v) for v in ux_i],
            "finite": bool(np.isfinite(ux).all()), "wall_s": wall,
            "ms_per_step": 1e3 * wall / steps, "gate": GATES[re_n],
            "passed": dev <= GATES[re_n]}


def sweep(device="cuda", steps_scale=1.0) -> dict:
    """Every Re of RUNS in f32, each run's steps scaled by steps_scale."""
    device = resolve_device(device)
    entry = dict(run_header(device), dtype="float32", u_lid=U_LID,
                 precision="ops/precision.full_f32", cases={}, reduced=[])
    if steps_scale != 1.0:
        entry["reduced"].append(f"steps scaled by {steps_scale}")
    for re_n, (n, steps) in RUNS.items():
        steps = max(1, round(steps * steps_scale))
        entry["cases"][str(re_n)] = run_case(re_n, n, steps, torch.float32,
                                             device)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    write_record(args.json, "sweep", sweep(args.device))
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
