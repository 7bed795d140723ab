"""The band super-step kernel (B5, B6 and B8, csrc/band_super.cu) against
another build of the same C entry point: bit for bit and in time, on the
shapes of chip_smoke.py's phase 2.

    python -m cuda_iblb_11_tpu_torch.probe_band_super [--against DIR]
        [--reps N] [--json PATH]

DIR is a checkout of another commit (for instance ``git archive`` of the
parent unpacked into a directory the repository ignores): its
``cuda_iblb_11_tpu_torch/csrc/`` is built beside this checkout's library
into build/kernels/probe_band_super/ and loaded with this checkout's
ctypes signatures, so the two builds run on the same inputs in one
process.  Without --against, this build alone is timed and held to
itself (two runs).

1. Each case's outputs (f_band, bhalos, force, flux) from both builds,
   torch.equal per output (the largest |difference| where not), and each
   build's time per call in turns (other, this, this, other; CUDA events
   after a spin kernel, ops/probes.device_ms).  Cases, K = 16, seeded
   inputs near equilibrium and the points of 16 real steps from it = 1000:
   B5 at 2048^2 (16 cilia) f32 deviatoric and f64 raw, both top walls,
   bf16 storage (the _bf16 entry), top slip, and at 8192^2 (64 cilia) f32
   deviatoric, top slip; B6 where the card's L2 size as a budget splits
   the band, 2048^2 f64 raw (both tops) and 8192^2 f32; B8 on both
   x-shards of the 2048^2 (2, 2) mesh, f32, f64 and bf16 storage.
2. B6 against B5 on the same inputs, torch.equal, for each build: at
   those shapes and at tests/test_torch_cuda.py's B6 shapes (384 x 192
   with 12 cilia on three tiles, K = 2 and 4, f32 and f64).
3. Registers, shared memory and spills of each kernel of band_super.cu
   and of the sources whose kernels share its step template
   (fused_step.cu: B2, B2h, B3) or its collide (collide_rows.cu: B0), for
   each build (ptxas), and torch.profiler's device ms by kernel of one B5
   call at 2048^2 f32 for each build.
Output: build/probe_band_super.json by default.  Where no card is visible
it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels, probes
from cuda_iblb_11_tpu_torch.probe_kstep import profile_call

DEFAULT_JSON = os.path.join(os.path.dirname(_kernels.BUILD_DIR),
                            "probe_band_super.json")
K = 16
OUTPUTS = ("f_band", "bhalos", "force", "flux")
MESH = (2, 2)
# name -> (c_num, c_space, ydim)
GRIDS = {"2048x2048": (16, 128, 2048), "8192x8192": (64, 128, 8192)}
TEST_TILED = dict(c_num=12, c_space=128, ydim=192)
# the sources whose kernels' resources the record holds
RESOURCE_SOURCES = ("band_super.cu", "fused_step.cu", "collide_rows.cu")


def other_library(root: str) -> _kernels.KernelLibrary:
    """The kernel library built from the csrc/ of the checkout at root,
    into build/kernels/probe_band_super/ (all compiles started
    together), its bf16 and points entries bound where it has them (a
    checkout from before bf16 storage has float32 and float64 entries
    only, one from before the overlap mask no points entries)."""
    src = os.path.join(os.path.abspath(root), "cuda_iblb_11_tpu_torch",
                       "csrc")
    if not os.path.isdir(src):
        raise FileNotFoundError(f"no kernel sources under {src}")
    nvcc = _kernels.find_nvcc()
    out = os.path.join(_kernels.BUILD_DIR, "probe_band_super")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    units = sorted(u for u in os.listdir(src) if u.endswith(".cu"))
    objs = [os.path.join(out, u + ".o") for u in units]
    log = _kernels._run([[nvcc] + _kernels.NVCC_FLAGS
                         + ["-c", os.path.join(src, u), "-o", o]
                         for u, o in zip(units, objs)])
    lib = os.path.join(out, "libiblb_kernels_other.so")
    log += _kernels._run([[nvcc] + _kernels.ARCH + ["-shared", "-o", lib]
                          + objs])
    for bf16, points in ((True, True), (True, False), (False, False)):
        try:
            return _kernels.KernelLibrary(lib, 0.0, log, bf16, points)
        except RuntimeError:
            if not bf16:
                raise


def kernel_resources(log: str, source="band_super.cu") -> dict:
    """{kernel<template arguments>: {registers, smem_bytes, spill_stores}}
    from a ptxas -v build log (ops/_kernels._build's: each compile's
    command line, then its output), for the entry functions of ``source``
    (f float, d double; Lb1E a template flag set, Lb0E one cleared)."""
    out, ours, key = {}, False, None
    for line in log.splitlines():
        if "nvcc" in line and " -c " in line:
            ours = source in line
            continue
        if not ours:
            continue
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)I"
                      r"([fd]+(?:Lb[01]E)*)E", line)
        if m:
            key = f"{m.group(1)}<{m.group(2)}>"
            out[key] = {}
            continue
        if key is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores", line)
        if sp:
            out[key]["spill_stores"] = int(sp.group(1))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            sm = re.search(r"(\d+) bytes smem", line)
            out[key].update(registers=int(r.group(1)),
                            smem_bytes=int(sm.group(1)) if sm else 0)
            key = None
    return out


def _inputs(cfg, storage, dtype, seed):
    """Seeded f near equilibrium (in dtype) and a band force (in the
    compute dtype: float32 under bf16 storage) on the card."""
    from cuda_iblb_11_tpu_torch.core.lattice import W
    from cuda_iblb_11_tpu_torch.ops import reference as ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    y, x = cfg.ydim, cfg.xdim

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    f = ref.equilibrium(1.0 + 0.02 * randn(y, x), 0.01 * randn(2, y, x),
                        storage)
    w = torch.tensor(W, dtype=torch.float64, device=dev)[:, None, None]
    f = (f + 1e-4 * randn(*f.shape) * w).to(dtype).contiguous()
    cdt = torch.promote_types(dtype, torch.float32)
    return f, (1e-4 * randn(2, cfg.force_band, x)).to(cdt).contiguous()


def _points(cfg, K_, halo, dtype, it0=1000):
    from cuda_iblb_11_tpu_torch import MucociliarySim
    from cuda_iblb_11_tpu_torch.models.mucociliary import (
        prep_band_super_points,
    )

    sim = MucociliarySim(cfg, backend="cuda", device="cuda", dtype=dtype)
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(it0, K_)
    return [p[0] for p in prep_band_super_points(
        cfg, K_, halo, sim.aux_dtype, u_s, eps, anchor, frac, 1)]


def cases(grids=GRIDS):
    """(label, {kernel: call}) per input set (B5 on temporal auto's whole
    leg, B6 where the card's L2 size as a budget splits the band, B8 on
    each x-shard at 2048^2), one set at a time so that the 8192^2 tensors
    are freed before the next is made."""
    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.band_super import band_super
    from cuda_iblb_11_tpu_torch.ops.band_super_tiled import band_super_tiled
    from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
        band_super_xsharded, shard_points,
    )
    from cuda_iblb_11_tpu_torch.ops.temporal import (
        plan_temporal, xshard_layout,
    )
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes

    sets = [("2048x2048", "float32", "deviatoric", "slip"),
            ("2048x2048", "float32", "deviatoric", "noslip"),
            ("2048x2048", "float64", "raw", "slip"),
            ("2048x2048", "float64", "raw", "noslip"),
            ("8192x8192", "float32", "deviatoric", "slip"),
            ("2048x2048", "bfloat16", "deviatoric", "slip")]
    for seed, (gname, dt, storage, top) in enumerate(sets):
        if gname not in grids:
            continue
        c, s, y = grids[gname]
        cfg = SimConfig(c_num=c, c_space=s, ydim=y)
        dtype = getattr(torch, dt)
        walls = ref.WallSpec(top=top)
        whole = MucociliarySim(cfg, walls, backend="cuda", device="cuda",
                               dtype=dtype, temporal="auto").plan
        # B6 where the card's L2 size as a budget splits the band
        plan = plan_temporal(cfg, K, walls, dtype, budget=l2_bytes("cuda"))
        f, force = _inputs(cfg, storage, dtype, seed)
        band = cfg.force_band
        f_ext = f[:, :band + whole.pad_s]
        xs = _points(cfg, K, whole.halo, dtype)
        args = (f_ext, force, *xs, cfg, whole.halo, walls, "trt_split",
                storage)
        out5 = f.new_empty((9, band, cfg.xdim))
        calls = {"B5": lambda: band_super(*args, out=out5)}
        if plan.band_leg == "band_super_xtiled":
            out6 = f.new_empty((9, band, cfg.xdim))
            targs = (f_ext, force, *xs, cfg, plan.halo, plan.tile_x,
                     plan.gx, walls, "trt_split", storage)
            calls["B6"] = lambda: band_super_tiled(*targs, out=out6)
        if gname == "2048x2048":
            n_x = MESH[1]
            xl = cfg.xdim // n_x
            lay = xshard_layout(cfg, 16, K, walls, dtype, xl, n_x)
            xs8 = _points(cfg, K, lay.halo, dtype)
            for ix in range(n_x):
                cols = torch.arange(ix * xl - lay.gx, (ix + 1) * xl + lay.gx,
                                    device=f.device) % cfg.xdim
                owned = ix * xl <= cfg.flux_x < (ix + 1) * xl
                flags = (cfg.flux_x - ix * xl + lay.gx if owned else 0,
                         int(owned))
                a8 = (flags, f[:, :band + 16][:, :, cols].contiguous(),
                      force[:, :, cols].contiguous(),
                      *shard_points(lay, xs8, cfg, ix, xl), cfg, lay, walls,
                      "trt_split", storage)
                calls[f"B8 x-shard {ix}"] = (
                    lambda a8=a8: band_super_xsharded(*a8))
        yield f"{gname} {dt} {storage} top={top}", calls
        del f, force, f_ext, xs, calls
        torch.cuda.empty_cache()


def card_test_cases():
    """B6 and B5 calls at tests/test_torch_cuda.py's B6 shapes."""
    from cuda_iblb_11_tpu_torch import SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.band_super import band_super
    from cuda_iblb_11_tpu_torch.ops.band_super_tiled import band_super_tiled
    from cuda_iblb_11_tpu_torch.ops.temporal import (
        band_super_resident, plan_temporal,
    )

    for dt, storage, top in (("float32", "deviatoric", "slip"),
                             ("float64", "raw", "noslip")):
        dtype = getattr(torch, dt)
        cfg = SimConfig(dtype=dt, **TEST_TILED)
        walls = ref.WallSpec(top=top)
        for k in (2, 4):
            whole = plan_temporal(cfg, k, walls, dtype)
            fp = band_super_resident(cfg.xdim, cfg.force_band + whole.pad_s,
                                     cfg.force_band, 2 * whole.halo, dtype)
            plan = plan_temporal(cfg, k, walls, dtype, budget=fp - 1)
            f, force = _inputs(cfg, storage, dtype, 4)
            f_ext = f[:, :cfg.force_band + plan.pad_s]
            xs = _points(cfg, k, plan.halo, dtype, it0=137)
            a = (f_ext, force, *xs, cfg, plan.halo)
            yield (f"test shapes {dt} K={k}",
                   lambda a=a, w=walls, s=storage: band_super_tiled(
                       *a, plan.tile_x, plan.gx, w, "trt_split", s),
                   lambda a=a, w=walls, s=storage: band_super(
                       *a, w, "trt_split", s))


class Builds:
    """This checkout's library and, optionally, another's; ``run(name,
    fn)`` calls fn with that build's library loaded."""

    def __init__(self, against=None):
        self.libs = {"this": _kernels.load()}
        if against:
            self.libs["other"] = other_library(against)

    def run(self, name, fn):
        with _kernels.using(self.libs[name]):
            return fn()


def _outputs(res):
    return [t.clone() for t in res if t is not None]


def _compare(a, b) -> dict:
    same = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
    diff = [float((x.double() - y.double()).abs().max()) if x.numel()
            else 0.0 for x, y in zip(a, b)]
    return dict(bit_identical=all(same) and len(a) == len(b),
                per_output=dict(zip(OUTPUTS, same)),
                max_abs=dict(zip(OUTPUTS, diff)))


def measure(against=None, reps=10, grids=GRIDS) -> dict:
    probes.require_card("probe_band_super")
    builds = Builds(against)
    other = "other" if against else "this"
    rec = {"card": probes.card_line(), "device": torch.cuda.get_device_name(0),
           "against": against, "cases": {}, "b6_vs_b5": {},
           "resources": {n: {src: kernel_resources(lib.build_log, src)
                             for src in RESOURCE_SOURCES}
                         for n, lib in builds.libs.items()}}
    for label, calls in cases(grids):
        b6b5 = {}
        for kname, fn in calls.items():
            outs = {n: builds.run(n, lambda: _outputs(fn()))
                    for n in ("this", other)}
            torch.cuda.synchronize()
            row = _compare(outs["this"], outs[other])
            if kname in ("B5", "B6"):
                b6b5[kname] = outs
            t = [builds.run(other, lambda: probes.device_ms(fn, reps)),
                 builds.run("this", lambda: probes.device_ms(fn, reps)),
                 builds.run("this", lambda: probes.device_ms(fn, reps)),
                 builds.run(other, lambda: probes.device_ms(fn, reps))]
            row.update(ms=(t[1] + t[2]) / 2, ms_other=(t[0] + t[3]) / 2,
                       ms_runs=t[1:3], ms_other_runs=[t[0], t[3]])
            rec["cases"][f"{kname} {label}"] = row
            print(f"{kname} {label}: bit-identical {row['bit_identical']} "
                  f"{row['max_abs']}; this {row['ms']:.4f} ms "
                  f"({t[1]:.4f}, {t[2]:.4f}), other {row['ms_other']:.4f} "
                  f"ms ({t[0]:.4f}, {t[3]:.4f})", flush=True)
        if "B6" in b6b5:
            for n in ("this", other):
                rec["b6_vs_b5"][f"{label} {n}"] = _compare(b6b5["B6"][n],
                                                           b6b5["B5"][n])
        del b6b5, outs
        torch.cuda.empty_cache()
    for label, b6, b5 in card_test_cases():
        for n in ("this", other):
            rec["b6_vs_b5"][f"{label} {n}"] = _compare(
                builds.run(n, lambda: _outputs(b6())),
                builds.run(n, lambda: _outputs(b5())))
    for key, row in rec["b6_vs_b5"].items():
        print(f"B6 vs B5 {key}: bit-identical {row['bit_identical']} "
              f"{row['max_abs']}", flush=True)
    first = next(iter(cases({"2048x2048": GRIDS["2048x2048"]})))[1]["B5"]
    rec["profile_b5_2048_f32_ms"] = {
        n: builds.run(n, lambda: profile_call(first)) for n in ("this", other)}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="a checkout of another commit to hold this "
                         "build against")
    ap.add_argument("--reps", type=int, default=10, help="calls per timing")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    rec = measure(args.against, args.reps)
    for n, by_source in rec["resources"].items():
        for src, kernels in by_source.items():
            for key, row in kernels.items():
                print(f"resources {n} {src} {key}: {row}")
    for n, rows in rec["profile_b5_2048_f32_ms"].items():
        for name, ms in rows.items():
            print(f"profile {n}: {name}: {ms:.4f} ms per call")
    print(f"card: {rec['card']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
