#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases; any failure exits non-zero before the final line:
  1. environment: the card, torch, CUDA, nvcc, and the kernel build from
     the sources in this checkout;
  2. every hand kernel against its plain torch version on the card, at
     the shapes the main path gives it: each grid's K, ghost pads and
     halo come from the temporal plan that temporal "auto" resolves to
     there.  Seeded inputs, f32 deviatoric and f64 raw, both top walls, at
     288 x 192 and 2048 x 2048; the path's own case (f32 deviatoric, top
     slip) at 8192 x 8192:
       B2 fused step at all three (rel-L2 of f, q, fluxcol <= 1e-6 f32,
          1e-12 f64);
       B3 band-leg step on the extended band (band + the plan's pad) at
          288 x 192 and 2048 x 2048, flags [0,1,0] with a neighbour halo
          and [0,1,1] (f, f1 row, q, fluxcol: the same gates);
       B4 K = 16 bulk steps at all three (f and flux: the same gates);
       B5 K = 16 band super-step at 2048 x 2048 (16 cilia) and 8192 x 8192
          (64 cilia), real points (f_band and seam halos as above; force
          and flux <= 1e-5 f32, 1e-11 f64);
     then each kernel's time at 2048 x 2048 f32 beside its plain version
     (CUDA events, plain/kernel/kernel/plain), its bytes and its bound;
  3. the main path: the port's CLI ``1 6 48 1.0 1.0 5 0.02 4 0 0 --device
     cuda``, 2,000 f32 steps, twice: with --temporal 1 (one B2 launch per
     step) and with the default --temporal auto (K = 16, per-sub-step leg:
     each 500-step interval is 31 super-steps of 16 B3 launches and one B4
     launch, then 4 single B2 steps).  Each run's flux at it = 500..2000
     within 1e-3 of the f64 golden validation/flux_early_f64_c6.dat, the
     two runs within 1e-5 of each other, the launch counts exact, SimLog
     naming the leg;
  4. real size: MucociliarySim at 288 x 192 and 2048 x 2048 (16 cilia),
     512 f32 steps on backend "cuda" and "torch", velocity rel-L2 <= 1e-5;
     2048 x 2048 temporal "auto" (K = 16, band_super_whole: one B5 and one
     B4 launch per 16 steps) against temporal 1, velocity rel-L2 <= 1e-5;
     ms/step and MLUPS of each; then 32 steps at 8192 x 8192 (64 cilia),
     single-step and temporal "auto", with peak memory.

The launch counts of each path are set to 0 just before it and read just
after.  The last lines are the kernels JSON line, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.  A
detailed JSON record goes to PATH (default build/chip_smoke.json).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# (c_num, c_space, ydim) of each size; SimConfig's defaults otherwise
GRIDS = {"2048x2048": (16, 128, 2048), "288x192": (6, 48, 192)}
TIMING_GRID = "2048x2048"
K = 16                                # the temporal K of the timed calls
REAL_SIZE_STEPS = 512
BIG_GRID = ("8192x8192", (64, 128, 8192), 32)
MAIN_ARGV = ["1", "6", "48", "1.0", "1.0", "5", "0.02", "4", "0", "0"]
FLUX_ITS = (500, 1000, 1500, 2000)   # rows held against the f64 golden

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.  (Float64
# outside the tensor cores is 34 TFLOP/s; every printed bound is f32.)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# Arithmetic operations per cell, counted from csrc/collide.cuh (a
# multiply-add counts 2): collide_cell with force 163, without 101; the
# moments of one cell (moments9) 19.  The IB coupling of one point: the
# delta's support is 3 cells per axis (|r| < 1.5), so 6 delta
# evaluations of ~15 operations, and on each of the 3 x 3 cells the
# weight (1), 3 multiply-adds of interpolation and 2 of spreading; plus
# the point's two amplitudes (~8).
COLLIDE_FORCED, COLLIDE_FREE, MOMENTS = 163, 101, 19
IB_POINT = 6 * 15 + 9 * (1 + 3 * 2 + 2 * 2) + 8

CASES = [("float32", "deviatoric", "slip"), ("float32", "deviatoric",
                                               "noslip"),
         ("float64", "raw", "slip"), ("float64", "raw", "noslip")]
GATE = {"float32": 1e-6, "float64": 1e-12}
GATE_IB = {"float32": 1e-5, "float64": 1e-11}

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "B2 fused_step": ("cuda_iblb_11_tpu_torch/csrc/fused_step.cu",
                      "cuda_iblb_11_tpu/ops/pallas_step.py:542"),
    "B3 sharded_fused_step": ("cuda_iblb_11_tpu_torch/csrc/fused_step.cu",
                              "cuda_iblb_11_tpu/ops/pallas_step.py:2337"),
    "B4 temporal_bulk": ("cuda_iblb_11_tpu_torch/csrc/temporal_bulk.cu",
                         "cuda_iblb_11_tpu/ops/pallas_step.py:1045"),
    "B5 band_super": ("cuda_iblb_11_tpu_torch/csrc/band_super.cu",
                      "cuda_iblb_11_tpu/ops/pallas_step.py:1496"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version_line(nvcc):
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [ln for ln in out.stdout.splitlines() if "release" in ln][0]


def wrappers():
    """The four kernel wrappers, by kernel name."""
    from cuda_iblb_11_tpu_torch.ops.band_super import band_super
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        fused_substep, sharded_fused_substep,
    )
    from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk

    return dict(zip(KERNELS, (fused_substep, sharded_fused_substep,
                              temporal_bulk, band_super)))


def reset_launches():
    for w in wrappers().values():
        w.launches = 0


def read_launches():
    return {name: w.launches for name, w in wrappers().items()}


def rel_l2(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(got, want):
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want) if w is not None)


def cuda_ms(fn, reps):
    """Mean device ms per call over `reps` calls, from CUDA events.  A
    spin kernel ahead of the start event keeps the card busy while the
    host enqueues the calls, so a call whose wrapper takes longer on the
    host than its kernel on the card is timed by its kernel."""
    import torch

    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1 << 20)
    end.record()
    end.synchronize()
    cycles_per_s = (1 << 20) / (start.elapsed_time(end) / 1e3)
    torch.cuda._sleep(int(cycles_per_s * (1.5 * host_s * reps + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_inputs(cfg, storage, dtype, device, seed):
    """Seeded f near equilibrium (raw or deviatoric) and a band force."""
    import numpy as np
    import torch

    from cuda_iblb_11_tpu_torch.core.state import W
    from cuda_iblb_11_tpu_torch.ops import reference as ref

    g = torch.Generator(device=device).manual_seed(seed)
    y, x = cfg.ydim, cfg.xdim

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=device)

    rho = 1.0 + 0.02 * randn(y, x)
    f = ref.equilibrium(rho, 0.01 * randn(2, y, x), storage)
    del rho
    w = torch.tensor(np.asarray(W), dtype=torch.float64,
                     device=device)[:, None, None]
    f = (f + 1e-4 * randn(*f.shape) * w).to(dtype).contiguous()
    force = 1e-4 * randn(2, cfg.force_band, x)
    return f, force.to(dtype).contiguous()


# --- phase 2: every kernel against its plain version ----------------------

class KernelCase:
    """One kernel's call on one input set: ``kern()`` launches the hand
    kernel (into preallocated outputs where the main path passes them),
    ``plain()`` runs its plain version; ``nbytes`` and ``nflop`` are what
    the function must move and compute (each input read once, each output
    written once)."""

    def __init__(self, kern, plain, names, nbytes, nflop):
        self.kern, self.plain, self.names = kern, plain, names
        self.nbytes, self.nflop = nbytes, nflop


def case_b2(cfg, f, force, walls, storage):
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        fused_substep, fused_substep_reference,
    )

    out = f.new_empty(f.shape)
    y, x, band = cfg.ydim, cfg.xdim, cfg.force_band
    es = f.element_size()
    return KernelCase(
        lambda: fused_substep(f, force, cfg, walls, "trt_split", storage,
                              out=out),
        lambda: fused_substep_reference(f, force, cfg, walls, "trt_split",
                                        storage),
        ("f", "q", "fluxcol"),
        es * (18 * y * x + 2 * band * x + 3 * band * x + 2 * y),
        COLLIDE_FORCED * y * x + MOMENTS * (band * x + y))


def case_b3(cfg, plan, f, force, walls, storage, flags, thalo):
    """The band leg's call: the extended band (band + the plan's ghost
    pad) exposing row band-1 and emitting q and the flux column."""
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        sharded_fused_substep, sharded_fused_substep_reference,
    )

    band, x = cfg.force_band, cfg.xdim
    rows = band + plan.pad
    f_ext = f[:, :rows]
    out = f.new_empty((9, rows, x))
    f1out = f.new_empty((9, x))
    args = (flags, f_ext, force, None, thalo, cfg, walls, "trt_split",
            storage, band - 1, True)
    es = f.element_size()
    return KernelCase(
        lambda: sharded_fused_substep(*args, out=out, f1out=f1out),
        lambda: sharded_fused_substep_reference(*args),
        ("f", "f1row", "q", "fluxcol"),
        es * (18 * rows * x + 2 * band * x + 9 * x * (1 + (thalo is not None))
              + 3 * band * x + 2 * rows),
        COLLIDE_FORCED * rows * x + MOMENTS * (band * x + rows))


def case_b4(cfg, plan, f, walls, storage):
    import torch

    from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
        temporal_bulk, temporal_bulk_reference,
    )

    band, y, x, K = cfg.force_band, cfg.ydim, cfg.xdim, plan.K
    f_bulk = f[:, band:]
    g = torch.Generator(device="cpu").manual_seed(11)
    bhalos = (f[None, :, band - 1] * (1.0 + 1e-3 * torch.randn(
        (K, 9, x), generator=g, dtype=torch.float64).to(f))).contiguous()
    out = f.new_empty(f.shape)[:, band:]
    rows = y - band
    es = f.element_size()
    return KernelCase(
        lambda: temporal_bulk(f_bulk, bhalos, cfg, walls, "trt_split",
                              storage, out=out),
        lambda: temporal_bulk_reference(f_bulk, bhalos, cfg, walls,
                                        "trt_split", storage),
        ("f", "flux"),
        es * (18 * rows * x + 9 * K * x + K),
        K * (COLLIDE_FREE * rows * x + MOMENTS * rows))


def case_b5(cfg, plan, f, force, walls, storage, dtype):
    """The band super-step's call; its operations are the forced collide
    of the band rows, the force-free collide of only those ghost rows that
    reach the band by the last sub-step (K - s of them at sub-step s), the
    band moments, the IB coupling of every point and the flux column."""
    from cuda_iblb_11_tpu_torch import MucociliarySim
    from cuda_iblb_11_tpu_torch.models.mucociliary import (
        prep_band_super_points,
    )
    from cuda_iblb_11_tpu_torch.ops.band_super import (
        NPT, band_super, band_super_reference,
    )

    K = plan.K
    sim = MucociliarySim(cfg, backend="cuda", device=DEVICE, dtype=dtype,
                         temporal=K)
    check(sim.plan == plan, f"B5 plan {sim.plan} != {plan}")
    _, u_s, eps, anchor, frac = sim.step_kinematics(1000, K)
    xs = [p[0] for p in prep_band_super_points(
        cfg, K, plan.halo, sim.aux_dtype, u_s, eps, anchor, frac, 1)]
    band, x, c = cfg.force_band, cfg.xdim, cfg.c_num
    rows = band + plan.pad_s
    f_ext = f[:, :rows]
    out = f.new_empty((9, band, x))
    args = (f_ext, force, *xs, cfg, plan.halo, walls, "trt_split", storage)
    es = f.element_size()
    return KernelCase(
        lambda: band_super(*args, out=out),
        lambda: band_super_reference(*args),
        ("f_band", "bhalos", "force", "flux"),
        es * (9 * rows * x + 2 * band * x + K * c * NPT * 5
              + 9 * band * x + 9 * K * x + 2 * band * x + K)
        + 4 * 2 * K * c * NPT,
        K * ((COLLIDE_FORCED + MOMENTS) * band * x + IB_POINT * cfg.ns
             + 4 * band) + COLLIDE_FREE * x * K * (K + 1) // 2)


def phase_kernels(record):
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref

    print("== phase 2: every kernel vs its plain version on the card",
          flush=True)
    dev = torch.device(DEVICE)
    big_name, big_dims, _ = BIG_GRID
    # grid -> (config, input cases); the big grid takes its path's case
    grids = {name: (SimConfig(c_num=c, c_space=s, ydim=y), CASES)
             for name, (c, s, y) in {**GRIDS, big_name: big_dims}.items()}
    grids[big_name] = (grids[big_name][0], CASES[:1])
    results = []
    timed = {}   # the first (main path) case of each kernel at the timing
    worst = {}   # grid in f32; each kernel's largest max |err| over all

    def run(kname, gname, dt, storage, top, kc, gates, extra=""):
        got = kc.kern()
        want = kc.plain()
        torch.cuda.synchronize()
        errs = {}
        for n, g, w in zip(kc.names, got, want):
            check(bool(torch.isfinite(g).all()), f"{kname} {n}: not finite")
            errs[n] = rel_l2(g, w)
        err = max_abs(got, want)
        results.append(dict(kernel=kname, grid=gname, dtype=dt,
                            storage=storage, top=top, case=extra,
                            rel_l2=errs, max_abs_err=err))
        print(f"  {kname} {gname} {dt} {storage} top={top} {extra}: "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f"  max|err|={err:.3e}", flush=True)
        for n, e in errs.items():
            gate = gates.get(n, gates["*"])
            check(e <= gate, f"{kname} {gname} {dt} {top} {extra}: rel-L2 "
                             f"{n} {e} > {gate}")
        worst[kname] = max(worst.get(kname, 0.0), err)
        if gname == TIMING_GRID and dt == "float32":
            timed.setdefault(kname, kc)

    for gname, (cfg, cases) in grids.items():
        for k, (dt, storage, top) in enumerate(cases):
            dtype = getattr(torch, dt)
            walls = ref.WallSpec(top=top)
            # the K, pads and halo of the main path on this grid
            plan = MucociliarySim(cfg, walls, backend="cuda", device=DEVICE,
                                  dtype=dtype, temporal="auto").plan
            check(plan is not None and plan.K == K,
                  f"{gname} {dt}: temporal auto plan {plan}")
            f, force = random_inputs(cfg, storage, dtype, dev, seed=k)
            g = {"*": GATE[dt]}
            run("B2 fused_step", gname, dt, storage, top,
                case_b2(cfg, f, force, walls, storage), g)
            if gname != big_name:   # B3 is not on the 8192^2 path
                thalo = (f[:, cfg.force_band + plan.pad] * 1.001).contiguous()
                for flags, th in (((0, 1, 0), thalo), ((0, 1, 1), None)):
                    run("B3 sharded_fused_step", gname, dt, storage, top,
                        case_b3(cfg, plan, f, force, walls, storage, flags,
                                th), g, f"flags={list(flags)} pad={plan.pad}")
            run("B4 temporal_bulk", gname, dt, storage, top,
                case_b4(cfg, plan, f, walls, storage), g, f"K={plan.K}")
            if plan.band_leg == "band_super_whole":
                run("B5 band_super", gname, dt, storage, top,
                    case_b5(cfg, plan, f, force, walls, storage, dtype),
                    {"force": GATE_IB[dt], "flux": GATE_IB[dt], "*": g["*"]},
                    f"K={plan.K} pad_s={plan.pad_s} halo={plan.halo}")
            del f, force
            torch.cuda.empty_cache()
    check(set(worst) == set(KERNELS), f"kernels held: {sorted(worst)}")
    record["kernel_vs_plain"] = results

    # times at 2048 x 2048, f32 deviatoric, slip (the first case's inputs;
    # B3 with the band leg's flags [0, 1, 0])
    timings = {}
    for kname, kc in timed.items():
        for fn in (kc.kern, kc.plain):
            fn()
        torch.cuda.synchronize()
        reps = 50 if kname != "B4 temporal_bulk" else 10
        t = [cuda_ms(kc.plain, 3), cuda_ms(kc.kern, reps),
             cuda_ms(kc.kern, reps), cuda_ms(kc.plain, 3)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        bytes_ms = kc.nbytes / HBM_BYTES_S * 1e3
        flop_ms = kc.nflop / F32_FLOP_S * 1e3
        timings[kname] = dict(
            shape=f"{TIMING_GRID} f32 deviatoric", ms=ms, plain_ms=plain_ms,
            ms_runs=t[1:3], plain_ms_runs=[t[0], t[3]],
            bytes_per_call=kc.nbytes, flop_per_call=kc.nflop,
            bound_ms=max(bytes_ms, flop_ms),
            bound_by="bytes" if bytes_ms >= flop_ms else "operations",
            max_abs_err=worst[kname])
        print(f"  {kname} {TIMING_GRID} f32: kernel {ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms "
              f"({t[0]:.4f}, {t[3]:.4f}); {kc.nbytes / 1e6:.1f} MB, "
              f"{kc.nflop / 1e9:.3f} GFLOP per call; bound "
              f"{timings[kname]['bound_ms']:.4f} ms "
              f"({timings[kname]['bound_by']})", flush=True)
    record["kernel_timing"] = timings
    return timings


# --- phase 3: the CLI, single-step and temporal auto ----------------------

def run_cli(label, extra, gold, record):
    import numpy as np

    from cuda_iblb_11_tpu_torch import SimConfig, cli

    out_dir = os.path.join(REPO, "build", "chip_smoke", label)
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = SimConfig.from_argv(MAIN_ARGV)
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(MAIN_ARGV + ["--device", DEVICE, "--output", out_dir,
                               "--quiet"] + extra)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(rc == 0, f"port CLI ({label}) exited {rc}")
    print(f"  {label}: CLI rc=0 in {wall:.2f} s, {cfg.iterations} steps, "
          f"launches {launches}", flush=True)
    flux = np.loadtxt(os.path.join(out_dir, "Flux",
                                   "1_6_48_1_1x5-flux.dat"))
    rows = []
    for it in FLUX_ITS:
        hit = np.isclose(flux[:, 0], it * cfg.t_scale, rtol=1e-5)
        check(hit.sum() == 1, f"{label}: no flux row at it={it}")
        q = float(flux[hit, 1][0]) / cfg.x_scale
        q_ref = float(gold[gold[:, 0] == it, 1][0])
        rel = abs(q - q_ref) / abs(q_ref)
        rows.append(dict(it=it, q=q, q_golden_f64=q_ref, rel=rel))
        print(f"    it={it}: Q={q:.6e} golden={q_ref:.6e} rel={rel:.3e}",
              flush=True)
        check(rel < 1e-3, f"{label}: flux at it={it} off the f64 golden by "
                          f"{rel}")
    with open(os.path.join(out_dir, "Raw", "6", "1", "SimLog.txt")) as fh:
        simlog = fh.read()
    mlups = [ln for ln in simlog.splitlines()
             if ln.startswith("End-to-end MLUPS")]
    record[label] = dict(argv=MAIN_ARGV + extra, wall_s=wall,
                         launches=launches, flux=rows, simlog_mlups=mlups)
    print(f"    {mlups[0] if mlups else ''}", flush=True)
    return cfg, launches, simlog, {r["it"]: r["q"] for r in rows}


def phase_main_path(record):
    import numpy as np

    print("== phase 3: main path, the port's CLI on the card", flush=True)
    gold = np.loadtxt(os.path.join(REPO, "validation",
                                   "flux_early_f64_c6.dat"))
    cfg, n1, log1, q1 = run_cli("cli_temporal_1", ["--temporal", "1"], gold,
                                record)
    steps = cfg.iterations
    check(n1 == {"B2 fused_step": steps, "B3 sharded_fused_step": 0,
                 "B4 temporal_bulk": 0, "B5 band_super": 0},
          f"--temporal 1 launches {n1}, expected {steps} B2")
    check("Kernel path: single_step" in log1 and "Resolved backend: cuda"
          in log1, "SimLog does not record the single-step cuda path")

    _, na, loga, qa = run_cli("cli_temporal_auto", [], gold, record)
    interval = cfg.interval
    n_super = min(interval, 512) // K
    rest = interval - n_super * K
    want = {"B2 fused_step": rest * (steps // interval),
            "B3 sharded_fused_step": n_super * K * (steps // interval),
            "B4 temporal_bulk": n_super * (steps // interval),
            "B5 band_super": 0}
    check(na == want, f"--temporal auto launches {na}, expected {want}")
    check("Kernel path: per_substep" in loga
          and "Temporal K: 16 (auto: K=16" in loga,
          "SimLog does not record the temporal leg and K")
    for it in FLUX_ITS:
        rel = abs(qa[it] - q1[it]) / abs(q1[it])
        check(rel <= 1e-5, f"auto vs --temporal 1 flux at it={it}: {rel}")
    record["cli_auto_vs_single"] = {it: abs(qa[it] - q1[it]) / abs(q1[it])
                                    for it in FLUX_ITS}
    print(f"  auto vs --temporal 1 flux rel: "
          f"{record['cli_auto_vs_single']}", flush=True)
    return n1, na


# --- phase 4: real sizes ------------------------------------------------

def _timed_run(sim, steps):
    import torch

    st = sim.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run_chunk(st, steps)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def _report(rows, name, label, cfg, st, sec, steps, **extra):
    ms = 1e3 * sec / steps
    mlups = cfg.size * steps / sec / 1e6
    rows.append(dict(grid=name, run=label, steps=steps, ms_per_step=ms,
                     mlups=mlups, q=float(st.q), **extra))
    print(f"  {name} {label}: {ms:.4f} ms/step, {mlups:.1f} MLUPS, "
          f"Q={float(st.q):.6e}"
          + "".join(f", {k}={v}" for k, v in extra.items()), flush=True)


def phase_real_size(record):
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig

    print("== phase 4: real size on the card", flush=True)
    steps = REAL_SIZE_STEPS
    rows = []
    for name, (c, s, y) in GRIDS.items():
        cfg = SimConfig(c_num=c, c_space=s, ydim=y)
        sims = {b: MucociliarySim(cfg, backend=b, device=DEVICE)
                for b in ("cuda", "torch")}
        for sim in sims.values():   # warm-up: allocator, cuBLAS, library
            sim.run_chunk(sim.init_state(), 4)
        us = {}
        for b in ("cuda", "torch"):
            st, sec = _timed_run(sims[b], steps)
            us[b] = sims[b].fields(st)[1]
            check(bool(torch.isfinite(us[b]).all()), f"{name} {b}: non-finite")
            _report(rows, name, f"backend {b}", cfg, st, sec, steps)
        err = rel_l2(us["cuda"], us["torch"])
        print(f"  {name} velocity rel-L2 cuda vs torch: {err:.3e}",
              flush=True)
        rows.append(dict(grid=name, velocity_rel_l2_cuda_vs_torch=err))
        check(err <= 1e-5, f"{name}: cuda vs torch velocity rel-L2 {err}")
        del sims, us

    # the temporal path at 2048^2: B5 + B4 against the single step
    name = TIMING_GRID
    cfg = SimConfig(c_num=16, c_space=128, ydim=2048)
    sims = {t: MucociliarySim(cfg, backend="cuda", device=DEVICE, temporal=t)
            for t in ("auto", 1)}
    rc = sims["auto"].resolved_config()
    check(rc["temporal"] == K and rc["band_leg"] == "band_super_whole",
          f"{name} auto resolved {rc['temporal']} {rc['band_leg']}")
    for sim in sims.values():
        sim.run_chunk(sim.init_state(), K)
    us, temporal_launches = {}, None
    for t, sim in sims.items():
        reset_launches()
        st, sec = _timed_run(sim, steps)
        launches = read_launches()
        us[t] = sim.fields(st)[1]
        check(bool(torch.isfinite(us[t]).all()), f"{name} K={t}: non-finite")
        _report(rows, name, f"temporal {t}", cfg, st, sec, steps,
                launches=launches)
        if t == "auto":
            temporal_launches = launches
            want = {"B2 fused_step": 0, "B3 sharded_fused_step": 0,
                    "B4 temporal_bulk": steps // K,
                    "B5 band_super": steps // K}
            check(launches == want, f"{name} auto launches {launches}")
    err = rel_l2(us["auto"], us[1])
    print(f"  {name} velocity rel-L2 temporal auto vs 1 after {steps} "
          f"steps: {err:.3e}", flush=True)
    rows.append(dict(grid=name, velocity_rel_l2_temporal_vs_single=err))
    check(err <= 1e-5, f"{name}: temporal vs single velocity rel-L2 {err}")
    del sims, us

    name, (c, s, y), n = BIG_GRID
    cfg = SimConfig(c_num=c, c_space=s, ydim=y)
    for t in (1, "auto"):
        sim = MucociliarySim(cfg, backend="cuda", device=DEVICE, temporal=t)
        sim.run_chunk(sim.init_state(), max(2, sim.temporal))
        torch.cuda.reset_peak_memory_stats()
        st, sec = _timed_run(sim, n)
        u = sim.fields(st)[1]
        check(bool(torch.isfinite(u).all()), f"{name} K={t}: non-finite")
        rc = sim.resolved_config()
        _report(rows, name, f"temporal {t}", cfg, st, sec, n,
                K=rc["temporal"], band_leg=rc["band_leg"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del sim, st, u
    record["real_size"] = rows
    return temporal_launches


def main():
    ap = argparse.ArgumentParser(
        description="smoke run of the port on one GPU")
    ap.add_argument("--record", default=os.path.join(REPO, "build",
                                                      "chip_smoke.json"),
                    help="where to write the detailed JSON record")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cuda_iblb_11_tpu_torch.ops import _kernels

    record = {}
    print("== phase 1: environment", flush=True)
    smi = nvidia_smi_line()
    nvcc = _kernels.find_nvcc()
    env = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
               nvcc=nvcc_version_line(nvcc), python=sys.version.split()[0])
    t0 = time.perf_counter()
    lib = _kernels.load()
    env["kernel_library"] = os.path.relpath(lib.path, REPO)
    env["build_s"] = lib.build_seconds
    env["load_s"] = time.perf_counter() - t0
    env["ptxas"] = [ln for ln in lib.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]
    record["environment"] = env
    for k, v in env.items():
        print(f"  {k}: {v}", flush=True)

    timings = phase_kernels(record)
    n_single, n_auto = phase_main_path(record)
    n_super = phase_real_size(record)
    # each kernel's launches on the path that runs it: B2 on the
    # single-step CLI, B3 and B4 on the default (auto) CLI, B5 on the
    # 2048^2 temporal run
    launches = {"B2 fused_step": n_single["B2 fused_step"],
                "B3 sharded_fused_step": n_auto["B3 sharded_fused_step"],
                "B4 temporal_bulk": n_auto["B4 temporal_bulk"],
                "B5 band_super": n_super["B5 band_super"]}
    for kname, n in launches.items():
        check(n > 0, f"{kname} was not launched on its path")

    kernels = {"kernels": [dict(
        name=kname, route="cuda", source=src, replaces=rep,
        launches=launches[kname],
        max_abs_err=timings[kname]["max_abs_err"],
        ms=timings[kname]["ms"], plain_ms=timings[kname]["plain_ms"],
        bound_ms=timings[kname]["bound_ms"],
        bound_by=timings[kname]["bound_by"], library_ms=None)
        for kname, (src, rep) in KERNELS.items()]}
    record["kernels"] = kernels["kernels"]
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    with open(args.record, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(kernels))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
