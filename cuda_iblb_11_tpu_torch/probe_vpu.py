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
Output: build/probe_vpu.json by default.  Where no card is visible it
raises.  The TPU script's identity-collide A/B patches the kernels'
collide; it is no kernel of its own and stays a ROADMAP item.
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


def measure(steps: int = 512, calls: int = CALLS) -> dict:
    probes.require_card("probe_vpu")
    rates = chain_rates(calls)
    fma = rates["fma"]["tflops"]
    step = port_mlups(steps)
    useful = step["mlups"] * 1e6 * COLLIDE_FREE / 1e12
    from cuda_iblb_11_tpu_torch.probe_bw import card_line

    return {
        "card": card_line(),
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
    print(f"card: {rec['card']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
