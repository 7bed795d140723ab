"""The card's float32 operation rate, and where the port's step sits on it —
the port of scripts/probe_vpu.py.

    python -m cuda_iblb_11_tpu_torch.probe_vpu [--steps N] [--json PATH]

1. P1 (ops/probes.probe_chain): a (256, 1024) f32 array, each element
   through R dependent fma / add / mul links in one thread, timed at
   R = 2000 and 6000; the rate is the slope, extra operations over extra
   time (probe_vpu.py:79-89), which cancels the launch and the memory
   traffic.  262,144 threads are one wave of the H100's 132 SMs x 2,048
   resident threads (1,024 blocks of 256 on 1,056 block slots, 97%), as
   the TPU probe's array is one VMEM-resident block; no larger array is
   needed.  An fma link counts 2 operations, an add or mul 1.
2. The collide tree's operations per cell, counted here once for the
   package (COLLIDE_FORCED, COLLIDE_FREE, MOMENTS, IB_POINT), which
   chip_smoke.py takes its bounds from.
3. The port's own MLUPS at 2048^2 (16 cilia, f32, temporal "auto"),
   measured in the same call, and the useful rate it implies (MLUPS x the
   force-free collide's operations, since the K-step bulk takes almost
   every cell) as a share of the measured fma rate.
4. The identity-collide A/B (scripts/probe_vpu.py:168-219), run by
   main() after the three above: the same 2048^2 auto path (K = 16, B5 +
   B4) from the default library and from a second build of the same
   sources with -DIBLB_IDENTITY_COLLIDE (ops/_kernels.VARIANTS, under its
   own key in build/kernels/), whose collide_cell passes f through.  Each
   build: MLUPS as the best of three timed runs of 6,144 steps after a
   warm-up of the same length (the JAX script's measure), and the device
   busy time per step from profile_step.profile_sim.  The split per site
   update: collide = full - identity, movement and glue = identity, in ps
   from the host clock and from the device's busy time (the 2048^2 step
   leaves the card idle part of the time, so the host figures are the
   upper ones).
Output: build/probe_vpu.json by default.  Where no card is visible it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import time

import torch

from cuda_iblb_11_tpu_torch.ops import probes

# --- operations per cell of the collide tree (csrc/collide.cuh) -----------
#
# Counted as scripts/probe_vpu.py:count_flops_per_elem counts the jaxpr of
# _collide_tile (each add, sub, mul, div, neg one operation; a multiply-add
# is two), on the operations collide_cell performs.  The force-free collide
# is the JAX tree's 101.  The forced collide is 163 where the JAX recount
# gives 165: the two operations of the JAX tree that collide_cell does not
# perform are named in JAX_ONLY_FORCED_OPS (pallas_step.py:728-732 builds
# c.g per pair from 0.0 and signed terms; collide.cuh:102 spells the four
# c.g values as gx, gy, gx + gy, -gx + gy, and the negation of gx is the
# sign of the add's operand, no instruction of its own).
COLLIDE_FREE = 101
COLLIDE_FORCED = 163
JAX_ONLY_FORCED_OPS = (
    "the add 0.0 + gy that forms c.g of pair (2, 4)",
    "the negation -gx in c.g of pair (6, 8)",
)
# the moments of one cell's nine post-stream values (collide.cuh:moments9):
# 8 adds for rho (one more in deviatoric storage, not counted) and 5 each
# for mom_x and mom_y
MOMENTS = 19
# The IB coupling of one point: the delta's support is 3 cells per axis
# (|r| < 1.5), so 6 delta evaluations of ~15 operations, and on each of
# the 3 x 3 cells the weight (1), 3 multiply-adds of interpolation and 2
# of spreading; plus the point's two amplitudes (~8).
IB_POINT = 6 * 15 + 9 * (1 + 3 * 2 + 2 * 2) + 8

F32_FLOP_S = 67e12           # NVIDIA H100 SXM data sheet, at 700 W
SHAPE = (256, 1024)
R1, R2 = 2000, 6000
CALLS = 100
DEFAULT_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "probe_vpu.json")


def slope_tflops(t1_ms, t2_ms, n=SHAPE[0] * SHAPE[1], op="fma",
                 r1=R1, r2=R2):
    """The chain rate from the times of the two chain lengths."""
    ops = n * probes.FLOPS_PER_LINK[op] * (r2 - r1)
    return ops / ((t2_ms - t1_ms) * 1e-3) / 1e12


def chain_rates(calls: int = CALLS) -> dict:
    """P1's slope rate for each op, with both times."""
    x = torch.full(SHAPE, 0.999999, dtype=torch.float32, device="cuda")
    out = torch.empty_like(x)
    rates = {}
    for op in probes.CHAIN_OPS:
        t = {}
        for reps in (R1, R2):
            def fn(reps=reps, op=op):
                probes.probe_chain(x, reps, op, out=out)

            fn()
            t[reps] = probes.device_ms(fn, calls)
        rates[op] = dict(ms_r1=t[R1], ms_r2=t[R2],
                         tflops=slope_tflops(t[R1], t[R2], op=op))
    return rates


def chain_sass() -> dict:
    """The instructions of the chain kernels in the built library, where
    the toolkit's cuobjdump is found: each op's kernel must hold its
    unrolled FFMA / FADD / FMUL links (no folding at compile time)."""
    from cuda_iblb_11_tpu_torch.ops import _kernels

    tool = shutil.which("cuobjdump") or os.path.join(_kernels.CUDA_ROOT,
                                                     "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    text = subprocess.run([tool, "-sass", _kernels.load().path],
                          capture_output=True, text=True, timeout=300).stdout
    counts = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        m = re.search(r"chain_kernelILi(\d)E", block.split("\n", 1)[0])
        if m:
            counts[probes.CHAIN_OPS[int(m.group(1))]] = {
                ins: len(re.findall(rf"\b{ins}\b", block))
                for ins in ("FFMA", "FADD", "FMUL")}
    return counts


def port_mlups(steps: int) -> dict:
    """MLUPS of MucociliarySim at 2048^2 (16 cilia), f32, temporal auto,
    on the card: a warm-up of one K-step chunk, then `steps` steps timed
    with the host clock around synchronised work."""
    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig

    cfg = SimConfig(c_num=16, c_space=128, ydim=2048)
    sim = MucociliarySim(cfg, temporal="auto")
    st = sim.run_chunk(sim.init_state(), sim.temporal)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run_chunk(st, steps)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    rc = sim.resolved_config()
    return dict(mlups=cfg.size * steps / sec / 1e6, steps=steps,
                ms_per_step=1e3 * sec / steps, temporal=rc["temporal"],
                band_leg=rc["band_leg"])


AB_STEPS = 6144     # scripts/probe_vpu.py:186
AB_PROFILE_STEPS = 512


def _ab_run(steps: int) -> dict:
    """One build's leg of the A/B: wall MLUPS (best of three runs of
    ``steps`` after a warm-up of the same length) and device busy ms per
    step of the 2048^2 auto path, with the kernels of the library in use
    (``_kernels.using``)."""
    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.profile_step import profile_sim

    cfg = SimConfig(c_num=16, c_space=128, ydim=2048)
    sim = MucociliarySim(cfg, temporal="auto")
    st = sim.run_chunk(sim.init_state(), steps)
    float(st.q)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        st = sim.run_chunk(st, steps)
        float(st.q)
        best = min(best, time.perf_counter() - t0)
    prof = profile_sim(sim, AB_PROFILE_STEPS)
    rc = sim.resolved_config()
    return dict(mlups=cfg.size * steps / best / 1e6,
                device_busy_ms_per_step=prof["device_busy_ms"],
                wall_ms_per_step_profiled_run=prof["wall_ms"],
                cells=cfg.size, temporal=rc["temporal"],
                band_leg=rc["band_leg"], finite=bool(torch.isfinite(
                    st.f).all()))


def identity_collide_ab(steps: int = AB_STEPS) -> dict:
    """The identity-collide A/B (module doc, 4): both builds' legs and the
    split of a site update into collide and movement plus glue."""
    from cuda_iblb_11_tpu_torch.ops import _kernels

    probes.require_card("probe_vpu")
    full = _ab_run(steps)
    with _kernels.using(_kernels.load("identity_collide")):
        ident = _ab_run(steps)
    cells = full["cells"]
    ps_full, ps_id = 1e6 / full["mlups"], 1e6 / ident["mlups"]
    dev_full = full["device_busy_ms_per_step"] * 1e9 / cells
    dev_id = ident["device_busy_ms_per_step"] * 1e9 / cells
    return {
        "case": "2048^2, 16 cilia, f32, temporal auto",
        "steps": steps, "profile_steps": AB_PROFILE_STEPS,
        "variant_flags": _kernels.VARIANTS["identity_collide"],
        "full": full, "identity": ident,
        "full_mlups": full["mlups"], "identity_mlups": ident["mlups"],
        "collide_ps_per_site": ps_full - ps_id,
        "movement_ps_per_site": ps_id,
        "device_collide_ps_per_site": dev_full - dev_id,
        "device_movement_ps_per_site": dev_id,
    }


def measure(steps: int = 512, calls: int = CALLS) -> dict:
    probes.require_card("probe_vpu")
    rates = chain_rates(calls)
    fma = rates["fma"]["tflops"]
    step = port_mlups(steps)
    useful = step["mlups"] * 1e6 * COLLIDE_FREE / 1e12
    return {
        "card": probes.card_line(),
        "device": torch.cuda.get_device_name(0),
        "method": f"slope between {R1} and {R2} dependent links, "
                  f"{list(SHAPE)} f32, one thread per element, "
                  f"{calls} calls per timing (CUDA events)",
        "tflops_by_op": {op: r["tflops"] for op, r in rates.items()},
        "chain_times_ms": rates,
        "fma_share_of_datasheet": fma * 1e12 / F32_FLOP_S,
        "peak_tflops_datasheet": F32_FLOP_S / 1e12,
        "chain_sass": chain_sass(),
        "collide_ops_per_cell_free": COLLIDE_FREE,
        "collide_ops_per_cell_forced": COLLIDE_FORCED,
        "port_2048": step,
        "useful_tflops_at_port_mlups": useful,
        "useful_share_of_measured_fma": useful / fma,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=512,
                    help="timed steps of the 2048^2 run")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    rec = measure(args.steps)
    for op, tf in rec["tflops_by_op"].items():
        print(f"{op} chain: {tf:.2f} TFLOP/s (slope)")
    print(f"port 2048^2 auto: {rec['port_2048']['mlups']:.0f} MLUPS -> "
          f"{rec['useful_tflops_at_port_mlups']:.2f} TFLOP/s useful, "
          f"{rec['useful_share_of_measured_fma']:.1%} of the fma rate")
    ab = rec["identity_collide_ab"] = identity_collide_ab()
    print(f"identity-collide A/B: full {ab['full_mlups']:.0f} MLUPS "
          f"({1e6 / ab['full_mlups']:.2f} ps/site), identity "
          f"{ab['identity_mlups']:.0f} MLUPS -> collide "
          f"{ab['collide_ps_per_site']:.2f} ps/site, movement+glue "
          f"{ab['movement_ps_per_site']:.2f} ps/site; device busy: collide "
          f"{ab['device_collide_ps_per_site']:.2f}, movement+glue "
          f"{ab['device_movement_ps_per_site']:.2f} ps/site")
    print(f"card: {rec['card']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
