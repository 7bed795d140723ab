#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases; any failure exits non-zero before the final line:
  1. environment: the card, torch, CUDA, nvcc, and the kernel build from
     the sources in this checkout;
  2. the hand kernel (csrc/fused_step.cu) against its plain torch version
     on the card, on seeded random states at 2048 x 2048 and 288 x 192:
     rel-L2 of f, q and fluxcol (gates 1e-6 in f32, 1e-12 in f64) and, at
     2048 x 2048, both times from CUDA events;
  3. the main path: the port's CLI, ``1 6 48 1.0 1.0 5 0.02 4 0 0 --device
     cuda`` (2,000 f32 steps); its flux at it = 500..2000 within 1e-3 of the
     f64 golden validation/flux_early_f64_c6.dat, and one kernel launch per
     step counted by the wrapper;
  4. real size: MucociliarySim at 288 x 192 and 2048 x 2048 (16 cilia) for
     512 f32 steps on backend "cuda" and on backend "torch" (its plain
     version), finite velocity that agrees to rel-L2 1e-5, ms/step and
     MLUPS for both; then 32 kernel steps at 8192 x 8192 (64 cilia).

The last lines are the kernels JSON line, the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": {...}}.  A detailed
JSON record goes to PATH (default build/chip_smoke.json).
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
KERNEL_GRIDS = {"2048x2048": (16, 128, 2048), "288x192": (6, 48, 192)}
TIMING_GRID = "2048x2048"
REAL_SIZE_GRIDS = {"288x192": (6, 48, 192), "2048x2048": (16, 128, 2048)}
REAL_SIZE_STEPS = 512
BIG_GRID = ("8192x8192", (64, 128, 8192), 32)
MAIN_ARGV = ["1", "6", "48", "1.0", "1.0", "5", "0.02", "4", "0", "0"]
FLUX_ITS = (500, 1000, 1500, 2000)   # rows held against the f64 golden


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


def rel_l2(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def cuda_ms(fn, reps):
    """Mean ms per call over `reps` calls, from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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

    g = torch.Generator(device="cpu").manual_seed(seed)
    y, x = cfg.ydim, cfg.xdim
    rho = (1.0 + 0.02 * torch.randn((y, x), generator=g, dtype=torch.float64))
    u = 0.01 * torch.randn((2, y, x), generator=g, dtype=torch.float64)
    f = ref.equilibrium(rho.to(device), u.to(device), storage)
    noise = torch.randn(f.shape, generator=g, dtype=torch.float64)
    w = torch.tensor(np.asarray(W), dtype=torch.float64)[:, None, None]
    f = f + (1e-4 * noise * w).to(device)
    force = 1e-4 * torch.randn((2, cfg.force_band, x), generator=g,
                               dtype=torch.float64)
    return (f.to(dtype).contiguous(),
            force.to(device=device, dtype=dtype).contiguous())


def phase_kernel(record):
    import torch

    from cuda_iblb_11_tpu_torch import SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        fused_substep, fused_substep_reference,
    )

    print("== phase 2: kernel vs plain version on the card", flush=True)
    dev = torch.device(DEVICE)
    grids = {name: SimConfig(c_num=c, c_space=s, ydim=y)
             for name, (c, s, y) in KERNEL_GRIDS.items()}
    cases = [(torch.float32, "deviatoric", "slip"),
             (torch.float32, "deviatoric", "noslip"),
             (torch.float64, "raw", "slip"),
             (torch.float64, "raw", "noslip")]
    gate = {torch.float32: 1e-6, torch.float64: 1e-12}
    results = []
    for gname, cfg in grids.items():
        for k, (dtype, storage, top) in enumerate(cases):
            walls = ref.WallSpec(top=top)
            f, force = random_inputs(cfg, storage, dtype, dev, seed=k)
            got = fused_substep(f, force, cfg, walls, "trt_split", storage)
            want = fused_substep_reference(f, force, cfg, walls,
                                           "trt_split", storage)
            torch.cuda.synchronize()
            errs = {n: rel_l2(g, w) for n, g, w in
                    zip(("f", "q", "fluxcol"), got, want)}
            max_abs = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want))
            row = dict(grid=gname, dtype=str(dtype).split(".")[-1],
                       storage=storage, forcing="trt_split", top=top,
                       rel_l2=errs, max_abs_err=max_abs)
            results.append(row)
            print(f"  {gname} {row['dtype']} {storage} trt_split top={top}: "
                  f"rel-L2 f={errs['f']:.3e} q={errs['q']:.3e} "
                  f"fluxcol={errs['fluxcol']:.3e}  max|err|={max_abs:.3e}",
                  flush=True)
            for n, e in errs.items():
                check(e <= gate[dtype] and all(
                    bool(torch.isfinite(t).all()) for t in got),
                    f"kernel vs plain {gname} {row['dtype']} {top}: "
                    f"rel-L2 {n} {e} > {gate[dtype]}")
            del f, force, got, want
    record["kernel_vs_plain"] = results

    # times at 2048 x 2048, f32 deviatoric, as the main path calls them
    cfg = grids[TIMING_GRID]
    f, force = random_inputs(cfg, "deviatoric", torch.float32, dev, seed=9)
    out = torch.empty_like(f)

    def kern():
        fused_substep(f, force, cfg, storage="deviatoric", out=out)

    def plain():
        fused_substep_reference(f, force, cfg, storage="deviatoric")

    for fn in (kern, plain):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    # plain, kernel, kernel, plain
    t = [cuda_ms(plain, 10), cuda_ms(kern, 50), cuda_ms(kern, 50),
         cuda_ms(plain, 10)]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    band, y, x = cfg.force_band, cfg.ydim, cfg.xdim
    nbytes = 4 * (18 * y * x + 5 * band * x + 2 * y)
    timing = dict(shape=f"{TIMING_GRID} f32 deviatoric", kernel_ms=ms,
                  plain_ms=plain_ms, kernel_ms_runs=t[1:3],
                  plain_ms_runs=[t[0], t[3]], bytes_per_call=nbytes,
                  kernel_gbps=nbytes / ms / 1e6)
    record["kernel_timing"] = timing
    print(f"  {TIMING_GRID} f32: kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
          f"plain {plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f}); kernel moves "
          f"{nbytes / 1e6:.1f} MB/call = {nbytes / ms / 1e6:.1f} GB/s",
          flush=True)
    main_err = max(r["max_abs_err"] for r in results
                   if r["grid"] == TIMING_GRID and r["dtype"] == "float32")
    return ms, plain_ms, main_err


def phase_main_path(record):
    import numpy as np

    from cuda_iblb_11_tpu_torch import SimConfig, cli
    from cuda_iblb_11_tpu_torch.ops.fused_step import fused_substep

    print("== phase 3: main path, port CLI on the card", flush=True)
    argv = MAIN_ARGV
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = SimConfig.from_argv(argv)
    fused_substep.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--device", DEVICE, "--output", out_dir,
                          "--quiet"])
    wall = time.perf_counter() - t0
    launches = fused_substep.launches
    check(rc == 0, f"port CLI exited {rc}")
    print(f"  CLI rc=0 in {wall:.2f} s, {cfg.iterations} steps, "
          f"kernel launches {launches}", flush=True)
    check(launches == cfg.iterations,
          f"kernel launches {launches} != steps {cfg.iterations}")
    flux = np.loadtxt(os.path.join(out_dir, "Flux",
                                   "1_6_48_1_1x5-flux.dat"))
    gold = np.loadtxt(os.path.join(REPO, "validation",
                                   "flux_early_f64_c6.dat"))
    rows = []
    for it in FLUX_ITS:
        t_it = it * cfg.t_scale
        hit = np.isclose(flux[:, 0], t_it, rtol=1e-5)
        check(hit.sum() == 1, f"no flux row at it={it}")
        q = float(flux[hit, 1][0]) / cfg.x_scale
        q_ref = float(gold[gold[:, 0] == it, 1][0])
        rel = abs(q - q_ref) / abs(q_ref)
        rows.append(dict(it=it, q=q, q_golden_f64=q_ref, rel=rel))
        print(f"  it={it}: Q={q:.6e} golden={q_ref:.6e} rel={rel:.3e}",
              flush=True)
        check(rel < 1e-3, f"flux at it={it} off the f64 golden by {rel}")
    with open(os.path.join(out_dir, "Raw", "6", "1", "SimLog.txt")) as fh:
        simlog = fh.read()
    check("Kernel path: single_step" in simlog and "Resolved backend: cuda"
          in simlog, "SimLog does not record the cuda kernel path")
    mlups_line = [ln for ln in simlog.splitlines()
                  if ln.startswith("End-to-end MLUPS")]
    record["main_path"] = dict(argv=argv, wall_s=wall, launches=launches,
                               flux=rows, simlog_mlups=mlups_line)
    print(f"  {mlups_line[0] if mlups_line else ''}", flush=True)
    return launches


def _timed_run(sim, steps):
    import torch

    st = sim.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run_chunk(st, steps)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def phase_real_size(record):
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig

    print("== phase 4: real size, both backends on the card", flush=True)
    steps = REAL_SIZE_STEPS
    rows = []
    for name, (c, s, y) in REAL_SIZE_GRIDS.items():
        cfg = SimConfig(c_num=c, c_space=s, ydim=y)
        sims = {b: MucociliarySim(cfg, backend=b, device=DEVICE)
                for b in ("cuda", "torch")}
        for sim in sims.values():   # warm-up: allocator, cuBLAS, library
            sim.run_chunk(sim.init_state(), 4)
        states = {}
        for b in ("cuda", "torch"):
            st, sec = _timed_run(sims[b], steps)
            u = sims[b].fields(st)[1]
            check(bool(torch.isfinite(u).all()), f"{name} {b}: non-finite u")
            states[b] = u
            ms = 1e3 * sec / steps
            mlups = cfg.size * steps / sec / 1e6
            rows.append(dict(grid=name, backend=b, steps=steps,
                             ms_per_step=ms, mlups=mlups, q=float(st.q)))
            print(f"  {name} {b}: {ms:.4f} ms/step, {mlups:.1f} MLUPS, "
                  f"Q={float(st.q):.6e}", flush=True)
        err = rel_l2(states["cuda"], states["torch"])
        print(f"  {name} velocity rel-L2 cuda vs torch: {err:.3e}",
              flush=True)
        rows.append(dict(grid=name, velocity_rel_l2_cuda_vs_torch=err))
        check(err <= 1e-5, f"{name}: cuda vs torch velocity rel-L2 {err}")
        del sims, states

    name, (c, s, y), n = BIG_GRID
    cfg = SimConfig(c_num=c, c_space=s, ydim=y)
    sim = MucociliarySim(cfg, backend="cuda", device=DEVICE)
    sim.run_chunk(sim.init_state(), 2)
    st, sec = _timed_run(sim, n)
    u = sim.fields(st)[1]
    check(bool(torch.isfinite(u).all()), f"{name}: non-finite velocity")
    ms = 1e3 * sec / n
    rows.append(dict(grid=name, backend="cuda", steps=n,
                     ms_per_step=ms, mlups=cfg.size * n / sec / 1e6,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    print(f"  {name} cuda: {ms:.4f} ms/step, "
          f"{cfg.size * n / sec / 1e6:.1f} MLUPS, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    record["real_size"] = rows


def main():
    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
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

    ms, plain_ms, max_err = phase_kernel(record)
    launches = phase_main_path(record)
    phase_real_size(record)

    kernels = {"kernels": [{
        "name": "fused_step (B2 _pipelined_kernel, B1 _collide_tile inlined)",
        "route": "cuda",
        "source": "cuda_iblb_11_tpu_torch/csrc/fused_step.cu",
        "replaces": "cuda_iblb_11_tpu/ops/pallas_step.py:181",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}
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
