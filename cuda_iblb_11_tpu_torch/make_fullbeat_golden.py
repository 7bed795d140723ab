"""The full-beat f64 run of the port — the port of
scripts/make_fullbeat_golden.py.

    python -m cuda_iblb_11_tpu_torch.make_fullbeat_golden [--steps N]
        [--device cuda|cpu] [--out PATH]

Runs MucociliarySim in f64, raw storage, single-step (B2 in f64 on the
card; its plain version on the CPU) over the reference's whole beat,
100,000 steps (main.cu:300), on its smallest legal grid (192^2, 4 cilia),
and saves the final corrected velocity and the cumulative flux as an npz
with the keys and dtypes of the JAX golden
validation/fullbeat_f64_192sq.npz (u float64 [2, Y, X]; q float64; steps,
xdim, ydim, c_num, c_space int64), to
build/validation/fullbeat_f64_192sq.npz by default.  --steps shortens the
run.  probe_f64.py's fullbeat leg makes this run on the card, times it and
holds it against the JAX golden.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from cuda_iblb_11_tpu_torch.accuracy_horizon import velocity
from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim
from cuda_iblb_11_tpu_torch.ops.probes import VALIDATION_DIR

DEFAULT_OUT = os.path.join(VALIDATION_DIR, "fullbeat_f64_192sq.npz")
STEPS = 100_000
CHUNK = 10_000
WARMUP = 512     # steps timed apart: the kernel build and first launches


def save(path, sim, state):
    """The golden npz of ``state`` (the JAX golden's keys and dtypes)."""
    cfg = sim.cfg
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    u = velocity(sim, state).cpu().numpy()
    np.savez_compressed(
        path, u=np.asarray(u, np.float64), q=float(state.q),
        steps=state.it, xdim=cfg.xdim, ydim=cfg.ydim, c_num=cfg.c_num,
        c_space=cfg.c_space)
    return u


def run(steps=STEPS, device="cuda", out=DEFAULT_OUT, c_num=4, c_space=48):
    """The f64 run, saved to ``out``: returns (sim, state, timing dict).
    The first WARMUP steps (or all, if fewer) are timed apart from the
    rest, whose rate is the steady MLUPS."""
    cfg = SimConfig(c_num=c_num, c_space=c_space, dtype="float64",
                    storage="raw")
    sim = MucociliarySim(cfg, device=device)
    st = sim.init_state()
    t0 = time.perf_counter()
    st = sim.run_chunk(st, min(WARMUP, steps))
    float(st.q)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    while st.it < steps:
        st = sim.run_chunk(st, min(CHUNK, steps - st.it))
        float(st.q)
        print(f"{st.it}/{steps} steps ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    rest = time.perf_counter() - t0
    u = save(out, sim, st)
    timing = {"wall_s_first": first, "wall_s_run": rest,
              "mlups_steady": (cfg.size * (steps - WARMUP) / rest / 1e6
                               if steps > WARMUP else None)}
    print(f"wrote {out}: q={float(st.q):.9e}, |u|_2={np.linalg.norm(u):.9e}",
          flush=True)
    return sim, st, timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the npz to write")
    args = ap.parse_args(argv)
    run(args.steps, args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
