#!/usr/bin/env python3
"""The kernels' timer: each hand kernel of the PyTorch/CUDA port on one
NVIDIA GPU against its plain version and its bound.

    python3 chip_smoke.py [--record PATH] [--against DIR]

Whether the port's paths are right on the card (the CLI against the f64
golden, whole runs and meshes at the benchmark's sizes, the quirk mode,
the validation models, bf16 storage, ranks on the card) is the card
suite's to say: ``python -m pytest --noconftest -p no:cacheprovider -m
cuda tests/test_torch_cuda.py``.  This script holds each kernel against
its plain version at the main path's shapes, which no card test runs, and
times it there.  Phases; any failure exits non-zero before the final
line:
  1. environment: the card, torch, CUDA, nvcc, and the kernel build from
     the sources in this checkout;
  2. every hand kernel against its plain torch version on the card, at
     the shapes the main path gives it: each grid's K, ghost pads and halo
     come from the temporal plan that temporal "auto" resolves to there
     (the whole band super-step: no device holds it to a budget).
     Seeded inputs, f32 deviatoric and f64 raw, both top walls, at
     288 x 192 and 2048 x 2048; the path's own case (f32 deviatoric, top
     slip) at 8192 x 8192:
       B2 fused step at all three (rel-L2 of f, q, fluxcol <= 1e-6 f32,
          1e-12 f64);
       B2h the step without emission at all three, with the force band
          and with the force over the whole height (the channel's), both
          top walls (on the 8192 x 8192 case too; the same gates);
       B3 band-leg step on the extended band (band + the plan's pad) at
          288 x 192 and 2048 x 2048, flags [0,1,0] with a neighbour halo
          and [0,1,1] (f, f1 row, q, fluxcol: the same gates); at the
          shard width of the mesh legs: the 8192 x 8192 (2, 2)
          per-sub-step leg's band block of x-column 1 (band + pad_b rows,
          4,096 columns, row band-1 exposed; the plan held to the card's
          L2 size) and the 288 x 192 (2, 1) top shard's per-step block;
       B4 K = 16 bulk steps at all three (f and flux: the same gates),
          and at 8192 x 8192 in f64 raw too; at 2048 x 2048 its f against
          16 launches of B3 (flags [band, 0, 1], the seam halo as the
          bottom halo row), bit for bit;
       B5 K = 16 band super-step at 2048 x 2048 (16 cilia) and 8192 x 8192
          (64 cilia), real points (f_band and seam halos as above; force
          and flux <= 1e-5 f32, 1e-11 f64);
       B6 the x-tiled band super-step on the plan held to the card's L2
          size as a budget, where that splits the band: 2048 x 2048 f64
          (tile 256, gx 512) and 8192 x 8192 f32 (tile 1,024, gx 512), the
          same gates, and against B5 on the same inputs, bit for bit;
       B0 one call on one exchange, every slab read in place, each with
          its own force slab (the same gates; f32 and f64): the 288 x 192
          (2, 1) mesh's 4 edge rows and the 2048 x 2048 (2, 2) mesh's 16
          edge rows and columns (per-step exchanges), and the 8192 x 8192
          (2, 2) per-sub-step leg's 4 seam columns of the x-columns' band
          blocks (band + pad_b rows), each table bit for bit against the
          same slabs one call each;
       B7 K = 16 ghost steps of (2, 2) shards at 2048 x 2048, x-extended
          by 128 columns: the inject shard that owns the flux column and
          the top shard (its rows above the seam and its flux: the same
          gates); the inject shard also at 8192 x 8192;
       B8 the x-sharded band super-step of both x-shards of the (2, 2)
          mesh at 2048 x 2048 (xl 1,024, gx 512, 14 point blocks), and of
          x-shard 1 at 8192 x 8192 (xl 4,096: the 5,120-column block),
          real points (B5's gates);
       M1 the cilia's overlap mask of a 512-step chunk at 12288 x 192
          (256 cilia 48 apart: three neighbours a node), f32 and f64, on
          the beat's placed points and on points moved by up to a spacing
          (the beat there switches no node off), bit for bit;
     then each kernel's time at 2048 x 2048 f32 beside its plain version
     (CUDA events after a spin kernel, plain/kernel/kernel/plain), its
     bytes and its bound; B4-B8 also at 8192 x 8192 f32, B4-B7 at 2048 x
     2048 f64 (B5 and B6 both against B5's bound there, the same
     function), B4 at 8192 x 8192 f64; for B4 and B7 the K-step driver's
     HBM passes per call, its redundancy and the arithmetic bound with
     it; B0's one call against the same 16 slabs one launch each, in
     turns, beside the launch floor (an empty kernel, back to back); M1 at
     its 512-step f32 chunk;
  3. the bf16 entries (f in bf16, everything else f32) against their
     plain versions on seeded inputs, into outputs filled with NaN: B2,
     B2h, B3 (the band leg's extended band, flags [0, 1, 0]: at 288 x 192
     without halos as the per-sub-step leg calls it and with a neighbour
     halo) and B4 (K = 16) at 288 x 192 and 2048 x 2048, B5 at 2048 x 2048
     (K = 16), B6 at 8192 x 8192 on the plan held to the card's L2 size (4
     tiles of 2,048), B0 on phase 2's three tables (288 x 192 (2, 1), 2048
     x 2048 (2, 2), the 8192 x 8192 (2, 2) seam columns of the budgeted
     plan), B7 and B8 on phase 2's mesh cases (2048 x 2048 both shards,
     8192 x 8192 one): f at least 99.9% bit-equal (ops/precision.
     bf16_agreement; the share and the ulps printed; B7's and B8's every
     element within two floored ulps), the f32 outputs at the f32 gates
     (B5's, B6's and B8's force and flux at B5's), and every output bit
     for bit the f32 entry's on the same values widened, f rounded to
     nearest even; B0 one launch a table; B6 bit for bit with B5; each
     timed in turns with that f32 entry (f32, bf16, bf16, f32) beside its
     plain version and its bound (f at 2 B a value), at 2048 x 2048 (B6
     at 8192 x 8192).

The last lines are the kernels JSON line (each kernel and each bf16 entry,
as "<kernel> bf16": its source, the TPU kernel it replaces, its largest
|err| against its plain version, its time, its plain version's and its
bound), the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.  A detailed JSON record goes to PATH
(default build/chip_smoke.json).  With --against DIR (another checkout,
e.g. the parent commit's ``git archive`` unpacked under build/), phase 2
also builds DIR's csrc/ and holds every f32 and f64 case's kernel outputs
bit for bit against that build's (M1's where that build has it).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# (c_num, c_space, ydim) of each size; SimConfig's defaults otherwise
GRIDS = {"2048x2048": (16, 128, 2048), "288x192": (6, 48, 192)}
TIMING_GRID = "2048x2048"
K = 16                                # the temporal K of the timed calls
BIG_GRID = ("8192x8192", (64, 128, 8192))
MESH = (2, 2)     # the mesh of phase 2's B0, B7 and B8 cases
# M1's grid (the benchmark's carpet12288_c256) and its timed chunk, the
# auto plan's first of an interval
MASK_GRID = ("12288x192", dict(c_fraction=16, c_num=256, c_space=48,
                               ydim=192))
MASK_STEPS = 512

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s, and float32 and float64 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F64_FLOP_S = 34e12

# Arithmetic operations per cell (collide with and without force, the
# moments of one cell) and per IB point: the package's one count
# (probe_vpu.py).  Outside a checkout this import fails, and the script
# exits non-zero before printing anything.
sys.path.insert(0, REPO)
from cuda_iblb_11_tpu_torch.ops.probes import card_line  # noqa: E402
from cuda_iblb_11_tpu_torch.probe_vpu import (  # noqa: E402
    COLLIDE_FORCED, COLLIDE_FREE, IB_POINT, MOMENTS,
)

KSTEP = ("B4 temporal_bulk", "B7 ghost_temporal")   # the K-step driver

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
    "B4 temporal_bulk": ("cuda_iblb_11_tpu_torch/csrc/ghost_temporal.cu",
                         "cuda_iblb_11_tpu/ops/pallas_step.py:1045"),
    "B5 band_super": ("cuda_iblb_11_tpu_torch/csrc/band_super.cu",
                      "cuda_iblb_11_tpu/ops/pallas_step.py:1496"),
    "B6 band_super_tiled": ("cuda_iblb_11_tpu_torch/csrc/band_super.cu",
                            "cuda_iblb_11_tpu/ops/pallas_step.py:1582"),
    "B0 collide_slabs": ("cuda_iblb_11_tpu_torch/csrc/collide_rows.cu",
                        "cuda_iblb_11_tpu/ops/pallas_step.py:775"),
    "B7 ghost_temporal": ("cuda_iblb_11_tpu_torch/csrc/ghost_temporal.cu",
                          "cuda_iblb_11_tpu/ops/pallas_step.py:2189"),
    "B8 band_super_xsharded": ("cuda_iblb_11_tpu_torch/csrc/band_super.cu",
                               "cuda_iblb_11_tpu/ops/pallas_step.py:1482"),
    "B2h collide_stream": ("cuda_iblb_11_tpu_torch/csrc/fused_step.cu",
                           "cuda_iblb_11_tpu/ops/pallas_step.py:583"),
    "M1 overlap_mask": ("cuda_iblb_11_tpu_torch/csrc/overlap_mask.cu",
                        "none (cuda_iblb_11_tpu/models/cilia.py masks in "
                        "jnp)"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def nvcc_version_line(nvcc):
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [ln for ln in out.stdout.splitlines() if "release" in ln][0]


def rel_l2(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def max_abs(got, want):
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want) if w is not None)


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


def sizes(f):
    """(bytes of one f value, bytes of one value of everything else): the
    storage and the compute type (f32 under bf16 storage)."""
    from cuda_iblb_11_tpu_torch.core.state import aux_dtype

    return f.element_size(), aux_dtype(f.dtype).itemsize


def nan_like(f, shape, dtype=None):
    """An output buffer filled with NaN, so that a value the kernel does
    not write shows."""
    return f.new_full(shape, float("nan"), dtype=dtype)


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

    out = nan_like(f, f.shape)
    y, x, band = cfg.ydim, cfg.xdim, cfg.force_band
    es, cs = sizes(f)
    return KernelCase(
        lambda: fused_substep(f, force, cfg, walls, "trt_split", storage,
                              out=out),
        lambda: fused_substep_reference(f, force, cfg, walls, "trt_split",
                                        storage),
        ("f", "q", "fluxcol"),
        es * 18 * y * x + cs * (2 * band * x + 3 * band * x + 2 * y),
        COLLIDE_FORCED * y * x + MOMENTS * (band * x + y))


def case_b2h(cfg, f, force, walls, storage, band):
    """B2h, the step without emission, with the force over `band` rows:
    the force band of the quirk mode's step, or the whole height as the
    channel's body force (a seeded force of its own)."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.collide_stream import (
        collide_stream, collide_stream_reference,
    )

    y, x = cfg.ydim, cfg.xdim
    if band != force.shape[1]:
        g = torch.Generator(device=f.device).manual_seed(band)
        force = 1e-4 * torch.randn((2, band, x), generator=g,
                                   dtype=force.dtype, device=f.device)
    out = nan_like(f, f.shape)
    args = (f, force, cfg.tau, cfg.tau2, walls, "trt_split", storage)
    es, cs = sizes(f)
    return KernelCase(
        lambda: (collide_stream(*args, out=out),),
        lambda: (collide_stream_reference(*args),), ("f",),
        es * 18 * y * x + cs * 2 * band * x,
        x * (COLLIDE_FORCED * band + COLLIDE_FREE * (y - band)))


def case_b3(cfg, plan, f, force, walls, storage, flags, thalo):
    """The band leg's call: the extended band (band + the plan's ghost
    pad) exposing row band-1 and emitting q and the flux column."""
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        sharded_fused_substep, sharded_fused_substep_reference,
    )

    band, x = cfg.force_band, cfg.xdim
    rows = band + plan.pad
    f_ext = f[:, :rows]
    out = nan_like(f, (9, rows, x))
    f1out = nan_like(force, (9, x))
    args = (flags, f_ext, force, None, thalo, cfg, walls, "trt_split",
            storage, band - 1, True)
    es, cs = sizes(f)
    return KernelCase(
        lambda: sharded_fused_substep(*args, out=out, f1out=f1out),
        lambda: sharded_fused_substep_reference(*args),
        ("f", "f1row", "q", "fluxcol"),
        es * 18 * rows * x + cs * (2 * band * x + 9 * x * (
            1 + (thalo is not None)) + 3 * band * x + 2 * rows),
        COLLIDE_FORCED * rows * x + MOMENTS * (band * x + rows))


def case_b4(cfg, plan, f, walls, storage):
    import torch

    from cuda_iblb_11_tpu_torch.core.state import aux_dtype
    from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
        temporal_bulk, temporal_bulk_reference,
    )

    band, y, x, K = cfg.force_band, cfg.ydim, cfg.xdim, plan.K
    f_bulk = f[:, band:]
    g = torch.Generator(device="cpu").manual_seed(11)
    cdt = aux_dtype(f.dtype)
    bhalos = (f[None, :, band - 1].to(cdt) * (1.0 + 1e-3 * torch.randn(
        (K, 9, x), generator=g, dtype=torch.float64).to(
            f.device, cdt))).contiguous()
    out = nan_like(f, f.shape)[:, band:]
    rows = y - band
    es, cs = sizes(f)
    kc = KernelCase(
        lambda: temporal_bulk(f_bulk, bhalos, cfg, walls, "trt_split",
                              storage, out=out),
        lambda: temporal_bulk_reference(f_bulk, bhalos, cfg, walls,
                                        "trt_split", storage),
        ("f", "flux"),
        es * 18 * rows * x + cs * (9 * K * x + K),
        K * (COLLIDE_FREE * rows * x + MOMENTS * rows))
    kc.inputs = (f_bulk, bhalos, walls, storage)
    kc.block = (rows, 0, x, K, f.dtype)   # (yl, pad, width, K, dtype)
    return kc


def super_points(cfg, plan, dtype):
    """The points of K real steps from it = 1000 in the band super-step's
    layout (the same for B5 and B6)."""
    from cuda_iblb_11_tpu_torch import MucociliarySim
    from cuda_iblb_11_tpu_torch.models.mucociliary import (
        prep_band_super_points,
    )

    sim = MucociliarySim(cfg, backend="cuda", device=DEVICE, dtype=dtype)
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(1000, plan.K)
    return [p[0] for p in prep_band_super_points(
        cfg, plan.K, plan.halo, sim.aux_dtype, u_s, eps, anchor, frac, 1)]


def band_super_counts(cfg, plan, es, cs=None):
    """(bytes, operations) of one band super-step call: the forced collide
    of the band rows, the force-free collide of only those ghost rows that
    reach the band by the last sub-step (K - s of them at sub-step s), the
    band moments, the IB coupling of every point and the flux column; B5's
    and B6's (the same function: a tile's ghost columns are the design's
    cost, not the function's).  es: bytes of an f value, cs: of every
    other value (es unless given)."""
    from cuda_iblb_11_tpu_torch.ops.band_super import NPT

    K, band, x, c = plan.K, cfg.force_band, cfg.xdim, cfg.c_num
    rows = band + plan.pad_s
    cs = es if cs is None else cs
    return (es * (9 * rows * x + 9 * band * x)
            + cs * (2 * band * x + K * c * NPT * 5 + 9 * K * x
                    + 2 * band * x + K)
            + 4 * 2 * K * c * NPT,
            K * ((COLLIDE_FORCED + MOMENTS) * band * x + IB_POINT * cfg.ns
                 + 4 * band) + COLLIDE_FREE * x * K * (K + 1) // 2)


def case_b5(cfg, plan, f, force, walls, storage, xs):
    """The whole-domain band super-step's call (plan: the whole leg)."""
    from cuda_iblb_11_tpu_torch.ops.band_super import (
        band_super, band_super_reference,
    )

    f_ext = f[:, :cfg.force_band + plan.pad_s]
    out = nan_like(f, (9, cfg.force_band, cfg.xdim))
    args = (f_ext, force, *xs, cfg, plan.halo, walls, "trt_split", storage)
    return KernelCase(
        lambda: band_super(*args, out=out),
        lambda: band_super_reference(*args),
        ("f_band", "bhalos", "force", "flux"),
        *band_super_counts(cfg, plan, *sizes(f)))


def case_b6(cfg, plan, f, force, walls, storage, xs):
    """The x-tiled band super-step's call (plan: the x-tiled leg), with
    the bytes its per-tile gathers and interior copies move (each read
    and written once) in ``copy_bytes``."""
    from cuda_iblb_11_tpu_torch.ops.band_super_tiled import (
        band_super_tiled, band_super_tiled_reference,
    )

    band, x, K = cfg.force_band, cfg.xdim, plan.K
    rows = band + plan.pad_s
    f_ext = f[:, :rows]
    out = nan_like(f, (9, band, x))
    args = (f_ext, force, *xs, cfg, plan.halo, plan.tile_x, plan.gx, walls,
            "trt_split", storage)
    es, cs = sizes(f)
    kc = KernelCase(
        lambda: band_super_tiled(*args, out=out),
        lambda: band_super_tiled_reference(*args),
        ("f_band", "bhalos", "force", "flux"),
        *band_super_counts(cfg, plan, es, cs))
    n_tiles, txe = x // plan.tile_x, plan.tile_x + 2 * plan.gx
    kc.copy_bytes = 2 * n_tiles * (
        (9 * rows * es + 2 * band * cs) * txe
        + (9 * band * es + (9 * K + 2 * band) * cs) * plan.tile_x)
    return kc


def case_b3_mesh(cfg, f, force, walls, storage, mesh, shard, rows=None):
    """B3 as the sharded path calls it on shard (iy, ix) of `mesh`, at the
    shard's width, on a contiguous copy of its block: with `rows`, the
    per-sub-step leg's band block of x-column ix (the shard's first rows
    rows, bottom wall, row band-1 exposed); else the per-step leg's whole
    shard with its flags and halo rows (the neighbours' edge rows, here the
    state's rows scaled by 1.001; none at a wall)."""
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        sharded_fused_substep, sharded_fused_substep_reference,
    )

    iy, ix = shard
    yl, xl, band = cfg.ydim // mesh[0], cfg.xdim // mesh[1], cfg.force_band
    y0, xs = iy * yl, slice(ix * xl, (ix + 1) * xl)
    f_loc = f[:, y0:y0 + yl, xs].contiguous()
    fo = force[:, :, xs].contiguous()
    if rows is not None:
        blk, flags, expose = f_loc[:, :rows], (0, 1, 0), band - 1
        halos = (None, None)
    else:
        blk, expose = f_loc, None
        flags = (y0, int(iy == 0), int(iy == mesh[0] - 1))
        halos = tuple(None if wall else (f[:, r, xs] * 1.001).contiguous()
                      for wall, r in ((flags[1], y0 - 1),
                                      (flags[2], (y0 + yl) % cfg.ydim)))
    n = blk.shape[1]
    out = f.new_empty(blk.shape)
    f1out = None if expose is None else f.new_empty((9, xl))
    names = ("f",) if expose is None else ("f", "f1row")
    args = (flags, blk, fo, *halos, cfg, walls, "trt_split", storage, expose)
    forced = min(max(band - y0, 0), n)
    return KernelCase(
        lambda: sharded_fused_substep(*args, out=out,
                                      f1out=f1out)[:len(names)],
        lambda: sharded_fused_substep_reference(*args)[:len(names)], names,
        f.element_size() * xl * (18 * n + 2 * band
                                 + 9 * (len(names) - 1 + sum(
                                     h is not None for h in halos))),
        xl * (COLLIDE_FORCED * forced + COLLIDE_FREE * (n - forced)))


def case_b0(cfg, f, force, storage, mesh, rows=None):
    """One exchange of `mesh`, read in place from contiguous copies of the
    shards' blocks, each slab with the force of its cells (zero above the
    band) in a tensor of its own, as parallel/sharded.py builds them: one
    B0 call.  Without `rows`, the per-step leg's: every shard's edge lines
    (bottom and top rows, and on x-sharded meshes the west and east
    columns); with it, the per-sub-step leg's: both seam columns of every
    x-column's band block (global rows [0, rows)).  ``per_slab`` is the
    same table as single-slab calls, one launch each."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.collide_rows import (
        collide_rows, collide_slabs, collide_slabs_reference,
    )

    from cuda_iblb_11_tpu_torch.core.state import aux_dtype

    n_y, n_x = mesh
    yl, xl, band = cfg.ydim // n_y, cfg.xdim // n_x, cfg.force_band
    n = yl if rows is None else rows
    cuts = [] if rows is not None else [(slice(None), slice(0, 1)),
                                        (slice(None), slice(yl - 1, yl))]
    if n_x > 1:
        cuts += [(slice(None), slice(None), slice(0, 1)),
                 (slice(None), slice(None), slice(xl - 1, xl))]
    slabs = []
    for iy in range(n_y if rows is None else 1):
        for ix in range(n_x):
            y0, xs = iy * yl, slice(ix * xl, (ix + 1) * xl)
            blk = f[:, y0:y0 + max(n, yl), xs].contiguous()[:, :n]
            fo = torch.zeros((2, n, xl), dtype=aux_dtype(f.dtype),
                             device=f.device)
            nb = min(max(band - y0, 0), n)
            fo[:, :nb] = force[:, y0:y0 + nb, xs]
            slabs += [(blk[c], fo[c].contiguous()) for c in cuts]
    cells = sum(a.shape[1] * a.shape[2] for a, _ in slabs)
    es, cs = sizes(f)
    kc = KernelCase(
        lambda: tuple(collide_slabs(slabs, cfg, "trt_split", storage)),
        lambda: tuple(collide_slabs_reference(slabs, cfg, "trt_split",
                                              storage)),
        tuple(f"f1[{i}]" for i in range(len(slabs))),
        (9 * es + 11 * cs) * cells, COLLIDE_FORCED * cells)
    kc.per_slab = lambda: tuple(collide_rows(a, b, cfg, "trt_split", storage)
                                for a, b in slabs)
    return kc


def case_b7(cfg, f, walls, storage, iy, ix, K):
    """Shard (iy, ix) of the (2, 2) mesh: its block x-extended by 128
    columns, its 16 ghost rows a side and K seam halos; the kernel's and
    the plain version's rows above the seam and columns of the shard (and
    the flux where it owns the flux column)."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
        ghost_temporal, ghost_temporal_reference,
    )

    pad, xpad, band = 16, 128, cfg.force_band
    yl, xl = cfg.ydim // MESH[0], cfg.xdim // MESH[1]
    y0, x0, dev = iy * yl, ix * xl, f.device
    cols = torch.arange(x0 - xpad, x0 + xl + xpad, device=dev) % cfg.xdim
    rows = torch.arange(y0 - pad, y0 + yl + pad, device=dev) % cfg.ydim
    blk = f[:, rows][:, :, cols]
    width = blk.shape[2]
    g = torch.Generator(device="cpu").manual_seed(12)
    es, cs = sizes(f)
    cdt = f.dtype if es == cs else torch.float32   # the seam halos' type
    noise = torch.randn((K, 9, width), generator=g, dtype=torch.float64)
    bh = (f[None, :, band - 1][:, :, cols].to(cdt) * (1.0 + 1e-3 * noise.to(
        device=f.device, dtype=cdt))).contiguous()
    lb = min(max(band - y0, 0), yl)
    owned = x0 <= cfg.flux_x < x0 + xl
    flags = (int(y0 <= band < y0 + yl), int(iy == MESH[0] - 1), pad + lb,
             xpad + min(max(cfg.flux_x - x0, 0), xl - 1), int(owned))
    args = (flags, blk[:, pad:pad + yl], blk[:, :pad], blk[:, pad + yl:], bh,
            cfg, walls, "trt_split", storage)
    out = f.new_empty(blk.shape)
    own = (slice(None), slice(pad + lb, pad + yl), slice(xpad, xpad + xl))

    def pick(res):
        return (res[0][own], res[1]) if owned else (res[0][own],)

    cells = blk.shape[1] * width
    kc = KernelCase(
        lambda: pick(ghost_temporal(*args, out=out)),
        lambda: pick(ghost_temporal_reference(*args)),
        ("f", "flux")[:1 + owned],
        es * 18 * cells + cs * (9 * K * width + K),
        K * (COLLIDE_FREE * cells + MOMENTS * (yl - lb)))
    kc.block = (yl, pad, width, K, f.dtype)
    return kc


def case_b8(cfg, f, force, walls, storage, ix, K, dtype):
    """x-shard ix of the (2, 2) mesh's band super-step: its band block
    widened by gx ghost columns a side and its point blocks; the bound is
    B5's count on the shard's own columns and cilia."""
    import types

    import torch

    from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
        band_super_xsharded, band_super_xsharded_reference, shard_points,
    )
    from cuda_iblb_11_tpu_torch.ops.temporal import xshard_layout

    n_x, band = MESH[1], cfg.force_band
    xl = cfg.xdim // n_x
    lay = xshard_layout(cfg, 16, K, walls, dtype, xl, n_x)
    xs = super_points(cfg, types.SimpleNamespace(K=K, halo=lay.halo), dtype)
    cols = torch.arange(ix * xl - lay.gx, (ix + 1) * xl + lay.gx,
                        device=f.device) % cfg.xdim
    f_ext = f[:, :band + 16][:, :, cols].contiguous()
    fo = force[:, :, cols].contiguous()
    pts = shard_points(lay, xs, cfg, ix, xl)
    owned = ix * xl <= cfg.flux_x < (ix + 1) * xl
    flags = (cfg.flux_x - ix * xl + lay.gx if owned else 0, int(owned))
    args = (flags, f_ext, fo, *pts, cfg, lay, walls, "trt_split", storage)
    out = f.new_empty((9, band, lay.width))
    n = 4 if owned else 3       # a shard without the flux column: zeros
    shard = types.SimpleNamespace(xdim=xl, c_num=cfg.c_num // n_x,
                                  force_band=band,
                                  ns=cfg.ns * xl // cfg.xdim)
    return KernelCase(
        lambda: band_super_xsharded(*args, out=out)[:n],
        lambda: band_super_xsharded_reference(*args)[:n],
        ("f_band", "bhalos", "force", "flux")[:n],
        *band_super_counts(shard, types.SimpleNamespace(K=K, pad_s=16),
                           *sizes(f)))


def case_m1(cfg, dtype, moved):
    """The overlap mask of MASK_STEPS steps: the points placed as the
    model places them, in dtype, or with every x moved by up to a spacing
    each way first (seeded), so that many pairs meet."""
    import torch

    from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
    from cuda_iblb_11_tpu_torch.ops.overlap_mask import (
        overlap_mask, overlap_mask_reference,
    )

    cilia = CiliaModel(cfg, dtype=dtype, device=DEVICE)
    pos, vel = cilia.kinematics(torch.arange(137, 137 + MASK_STEPS,
                                             device=DEVICE))
    if moved:
        g = torch.Generator(device=DEVICE).manual_seed(5)
        pos[..., 0] += (torch.rand(pos.shape[:-1], generator=g,
                                   dtype=pos.dtype, device=DEVICE)
                        - 0.5) * 2 * cfg.c_space
    cilia.r_max, r_max = 0, cilia.r_max   # placement only
    s = cilia.place_and_mask(pos, vel)[0]
    shape = (MASK_STEPS, cfg.c_num, cfg.length)
    x = s[..., 0].reshape(shape).contiguous()
    y = s[..., 1].reshape(shape).contiguous()
    pts = cfg.c_num * cfg.length
    return KernelCase(
        lambda: (overlap_mask(x, y, r_max),),
        lambda: (overlap_mask_reference(x, y, r_max),), ("eps",),
        MASK_STEPS * pts * (2 * x.element_size() + 4),
        MASK_STEPS * 4 * pts * (r_max - 1) * cfg.length)


def mask_cases(results, worst, other):
    """M1 against its plain version (and the other build's, where it has
    the kernel), bit for bit; the f32 beat case, for the timing."""
    import torch

    from cuda_iblb_11_tpu_torch import SimConfig
    from cuda_iblb_11_tpu_torch.ops import _kernels

    gname, kw = MASK_GRID
    cfg = SimConfig(**kw)
    theirs_has = other is not None and hasattr(other.lib,
                                               "iblb_overlap_mask_f32")
    timed = None
    for dt in ("float32", "float64"):
        for moved in (False, True):
            kc = case_m1(cfg, getattr(torch, dt), moved)
            got, want = kc.kern()[0], kc.plain()[0]
            same = torch.equal(got, want)
            if theirs_has:
                with _kernels.using(other):
                    same = same and torch.equal(kc.kern()[0], got)
            off = int((got == 0).sum())
            case = ("moved points" if moved else "the beat") + \
                f", {MASK_STEPS} steps"
            results.append(dict(kernel="M1 overlap_mask", grid=gname,
                                dtype=dt, case=case, bit_identical=same,
                                nodes_off=off))
            print(f"  M1 overlap_mask {gname} {dt} {case}: bit-identical "
                  f"{same}, nodes off {off} of {got.numel()}", flush=True)
            check(same, f"M1 {gname} {dt} {case}: not the plain mask")
            check(not moved or off > 0, f"M1 {gname} {dt} {case}: no "
                                        "node off")
            if timed is None:
                timed = kc
    worst["M1 overlap_mask"] = 0.0
    return timed


def phase_kernels(record, other=None):
    """Phase 2; with ``other`` (another checkout's kernel library), every
    case's kernel outputs also bit for bit against that build's."""
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops import _kernels
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.probes import device_ms, launch_floor_ms
    from cuda_iblb_11_tpu_torch.ops.temporal import (
        plan_sharded, plan_temporal,
    )
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes

    print("== phase 2: every kernel vs its plain version on the card",
          flush=True)
    dev = torch.device(DEVICE)
    # B6's plans and the (2, 2) mesh's per-sub-step leg: the card's L2
    # size as a footprint budget (the simulations plan none; this builds
    # the legs that split the band)
    l2 = l2_bytes(dev)
    big_name, big_dims = BIG_GRID
    # grid -> (config, input cases); the big grid takes its path's case
    grids = {name: (SimConfig(c_num=c, c_space=s, ydim=y), CASES)
             for name, (c, s, y) in {**GRIDS, big_name: big_dims}.items()}
    grids[big_name] = (grids[big_name][0], CASES[:1])
    results = []
    timed = {}   # the first (main path) case of each kernel at the timing
    worst = {}   # grid in f32; each kernel's largest max |err| over all
    timed_big = {}   # B4-B8 on the big grid's path case
    timed_f64 = {}   # and B4-B7 at the timing grid in f64
    b6_vs_b5 = []
    b4_vs_b3 = []
    b0_vs_single = []
    vs_other = []

    def run(kname, gname, dt, storage, top, kc, gates, extra=""):
        got = kc.kern()
        if other is not None:
            mine = [t.clone() for t in got]   # the call writes into out
            with _kernels.using(other):
                theirs = kc.kern()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            vs_other.append(dict(kernel=kname, grid=gname, dtype=dt,
                                 top=top, case=extra, bit_identical=same))
            check(same, f"{kname} {gname} {dt} {top} {extra}: not the "
                        f"other build's outputs bit for bit")
            # free the copy before the plain version runs (8192^2 f64 B4
            # fills the card), and hold this build's outputs again
            del mine, theirs
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
        shown = errs if len(errs) <= 4 else {"max over slabs":
                                             max(errs.values())}
        print(f"  {kname} {gname} {dt} {storage} top={top} {extra}: "
              + " ".join(f"{n}={e:.3e}" for n, e in shown.items())
              + f"  max|err|={err:.3e}", flush=True)
        for n, e in errs.items():
            gate = gates.get(n, gates["*"])
            check(e <= gate, f"{kname} {gname} {dt} {top} {extra}: rel-L2 "
                             f"{n} {e} > {gate}")
        worst[kname] = max(worst.get(kname, 0.0), err)
        if gname == TIMING_GRID and dt == "float32":
            timed.setdefault(kname, kc)
        if gname == TIMING_GRID and dt == "float64" and kname in KSTEP:
            timed_f64.setdefault(kname, kc)
        return got

    def b0_table(gname, dt, storage, top, mesh, g, rows=None):
        """B0 on one exchange's table, against its plain version, and
        bit for bit against the same slabs one call each."""
        kc = case_b0(cfg, f, force, storage, mesh, rows)
        leg = ("per-step exchange" if rows is None
               else f"per-sub-step seam columns, {rows} rows")
        got = run("B0 collide_slabs", gname, dt, storage, top, kc, g,
                  f"{mesh} {leg}, {len(kc.names)} slabs")
        one = kc.per_slab()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, one))
        b0_vs_single.append(dict(grid=gname, dtype=dt, top=top,
                                 mesh=list(mesh), slabs=len(one),
                                 bit_identical=same))
        print(f"  B0 table vs {len(one)} single-slab calls {gname} {dt} "
              f"top={top}: bit-identical {same}", flush=True)
        check(same, f"B0 table {gname} {dt} {top}: not the single-slab "
                    "calls' f1 bit for bit")
        return kc

    for gname, (cfg, cases) in grids.items():
        for k, (dt, storage, top) in enumerate(cases):
            dtype = getattr(torch, dt)
            walls = ref.WallSpec(top=top)
            # the K, pads and halo of the main path on this grid
            plan = MucociliarySim(cfg, walls, backend="cuda", device=DEVICE,
                                  dtype=dtype, temporal="auto").plan
            check(plan is not None and plan.K == K,
                  f"{gname} {dt}: temporal auto plan {plan}")
            check((plan.band_leg == "per_substep") == (gname == "288x192")
                  and plan.band_leg != "band_super_xtiled",
                  f"{gname} {dt}: auto took {plan.band_leg}")
            f, force = random_inputs(cfg, storage, dtype, dev, seed=k)
            g = {"*": GATE[dt]}
            gi = {"force": GATE_IB[dt], "flux": GATE_IB[dt], "*": g["*"]}
            run("B2 fused_step", gname, dt, storage, top,
                case_b2(cfg, f, force, walls, storage), g)
            # B2h at the quirk step's band and the channel's whole height;
            # both top walls on the big grid's one input set
            for top_h in (top,) if gname != big_name else ("slip", "noslip"):
                for band in (cfg.force_band, cfg.ydim):
                    run("B2h collide_stream", gname, dt, storage, top_h,
                        case_b2h(cfg, f, force, ref.WallSpec(top=top_h),
                                 storage, band), g, f"band={band}")
            if gname != big_name:
                thalo = (f[:, cfg.force_band + plan.pad] * 1.001).contiguous()
                for flags, th in (((0, 1, 0), thalo), ((0, 1, 1), None)):
                    run("B3 sharded_fused_step", gname, dt, storage, top,
                        case_b3(cfg, plan, f, force, walls, storage, flags,
                                th), g, f"flags={list(flags)} pad={plan.pad}")
            else:
                # auto's (2, 2) mesh takes B8 here; on the plan held to the
                # card's L2 size it takes the per-sub-step leg:
                # B3 at the x-shard width on each x-column's band block,
                # and B0 on every x-column's seam columns in one call
                sp = plan_sharded(cfg, K, *MESH, walls, dtype, budget=l2)
                check(sp.band_leg == "per_substep_tiled",
                      f"{gname} {MESH} budgeted plan {sp}")
                rows = cfg.force_band + sp.pad_b
                run("B3 sharded_fused_step", gname, dt, storage, top,
                    case_b3_mesh(cfg, f, force, walls, storage, MESH, (0, 1),
                                 rows), g,
                    f"{MESH} x-column 1 band block, pad_b={sp.pad_b}")
                b0_table(gname, dt, storage, top, MESH, g, rows)
            if gname == "288x192":
                # the per-step leg of the CLI's --mesh 2,1: the top
                # shard's block and one exchange's edge rows
                run("B3 sharded_fused_step", gname, dt, storage, top,
                    case_b3_mesh(cfg, f, force, walls, storage, (2, 1),
                                 (1, 0)), g, "(2, 1) top shard, per step")
                b0_table(gname, dt, storage, top, (2, 1), g)
            b4 = case_b4(cfg, plan, f, walls, storage)
            run("B4 temporal_bulk", gname, dt, storage, top, b4, g,
                f"K={plan.K}")
            if gname == TIMING_GRID:
                b4_vs_b3.append(b4_is_b3_composed(cfg, b4, gname, dt, top))
            if gname == big_name:
                timed_big["B4 temporal_bulk"] = b4
            del b4
            if plan.pad_s is not None:   # auto's whole band super-step
                xs = super_points(cfg, plan, dtype)
                b5 = case_b5(cfg, plan, f, force, walls, storage, xs)
                got5 = run("B5 band_super", gname, dt, storage, top, b5, gi,
                           f"K={plan.K} pad_s={plan.pad_s} "
                           f"halo={plan.halo}")
                # B6 on the plan held to the card's L2 size, where that
                # splits the band (2048^2 f64, 8192^2 f32)
                xt = plan_temporal(cfg, plan.K, walls, dtype, budget=l2)
                if xt.band_leg == "band_super_xtiled":
                    b6 = case_b6(cfg, xt, f, force, walls, storage, xs)
                    got6 = run("B6 band_super_tiled", gname, dt, storage,
                               top, b6, gi, f"K={xt.K} tile={xt.tile_x} "
                               f"gx={xt.gx} (budget {l2} B)")
                    same = all(torch.equal(a, b) for a, b in zip(got6, got5))
                    errs = {n: rel_l2(a, b)
                            for n, a, b in zip(b6.names, got6, got5)}
                    b6_vs_b5.append(dict(grid=gname, dtype=dt,
                                         storage=storage, top=top,
                                         bit_identical=same, rel_l2=errs,
                                         max_abs=max_abs(got6, got5)))
                    print(f"  B6 vs B5 {gname} {dt} top={top}: "
                          f"bit-identical {same}; " + " ".join(
                              f"{n}={e:.3e}" for n, e in errs.items()),
                          flush=True)
                    check(same, f"B6 vs B5 {gname} {dt} {top}: not bit "
                                f"for bit, rel-L2 {errs}")
                    if gname == big_name:
                        timed_big.update({"B5 band_super": b5,
                                          "B6 band_super_tiled": b6})
                    elif "B5 band_super" not in timed_f64:
                        timed_f64.update({"B5 band_super": b5,
                                          "B6 band_super_tiled": b6})
                    del b6, got6
                del b5, got5, xs
            # the sharded path's kernels on (2, 2) shards: at 2048^2 every
            # case (B0 on the per-step exchange, B8 on both x-shards, B7),
            # at 8192^2 B8 and B7 on its path's case
            if gname == TIMING_GRID:
                b0_table(gname, dt, storage, top, MESH, g)
            if gname in (TIMING_GRID, big_name):
                for ix in (1, 0) if gname == TIMING_GRID else (1,):
                    b8 = case_b8(cfg, f, force, walls, storage, ix, K, dtype)
                    run("B8 band_super_xsharded", gname, dt, storage, top,
                        b8, gi, f"{MESH} x-shard {ix}, K={K}")
                if gname == big_name:
                    timed_big["B8 band_super_xsharded"] = b8
                del b8
                for iy, ix in ((0, 1), (1, 0)) if gname == TIMING_GRID \
                        else ((0, 1),):
                    b7 = case_b7(cfg, f, walls, storage, iy, ix, K)
                    run("B7 ghost_temporal", gname, dt, storage, top, b7, g,
                        f"{MESH} shard ({iy}, {ix}), K={K}")
                if gname == big_name:
                    timed_big["B7 ghost_temporal"] = b7
                del b7
            del f, force
            torch.cuda.empty_cache()
    m1 = mask_cases(results, worst, other)
    check(set(worst) == set(KERNELS),
          f"kernels held: {sorted(worst)}")
    check(set(timed_big) == {"B4 temporal_bulk", "B5 band_super",
                             "B6 band_super_tiled", "B7 ghost_temporal",
                             "B8 band_super_xsharded"}
          and len(timed_f64) == 4,
          "B4-B8 were not held at 8192^2 f32, B4-B7 at 2048^2 f64")
    check(len(b6_vs_b5) == 3, f"B6 cases (2048^2 f64 both tops, 8192^2 "
                              f"f32): {len(b6_vs_b5)}")
    check(len(b4_vs_b3) == len(CASES) and all(
        r["bit_identical"] for r in b4_vs_b3),
        f"B4 against K launches of B3: {b4_vs_b3}")
    record["kernel_vs_plain"] = results
    record["b6_vs_b5"] = b6_vs_b5
    record["b4_vs_k_launches_of_b3"] = b4_vs_b3
    record["b0_table_vs_single_slab_calls"] = b0_vs_single
    if other is not None:
        record["kernel_vs_other_build"] = vs_other
        print(f"  every case of every kernel bit for bit with the build of "
              f"{other.path}: {len(vs_other)} cases", flush=True)

    # times at 2048 x 2048, f32 deviatoric, slip (the first case's inputs;
    # B3 with the band leg's flags [0, 1, 0]; B0 on the (2, 2) exchange);
    # B4-B8 also at the big grid's path case and B4-B7 at 2048 x 2048 f64
    # raw slip, where each plain version takes a second or two
    f32 = f"{TIMING_GRID} f32 deviatoric"
    slow = ("B4 temporal_bulk", "B7 ghost_temporal",
            "B8 band_super_xsharded")
    timings = {kname: time_case(kname, kc, f32,
                                10 if kname in slow else 50, 3, worst)
               for kname, kc in timed.items()}
    timings["M1 overlap_mask"] = time_case(
        "M1 overlap_mask", m1, f"{MASK_GRID[0]} f32, {MASK_STEPS} steps",
        50, 3, worst)
    del m1
    timings_big = {kname: time_case(kname, kc, f"{big_name} f32 deviatoric",
                                    10, 1, worst)
                   for kname, kc in timed_big.items()}
    timings_f64 = {kname: time_case(kname, kc, f"{TIMING_GRID} f64 raw", 10,
                                    1, worst, F64_FLOP_S)
                   for kname, kc in timed_f64.items()}
    # B0's one call against the same slabs one launch each, in turns, and
    # the launch floor beside them; 50 calls of 16 launches stay within the
    # launches the card queues behind the timer's spin kernel
    b0 = timed["B0 collide_slabs"]
    t = [device_ms(b0.kern, 50), device_ms(b0.per_slab, 50),
         device_ms(b0.per_slab, 50), device_ms(b0.kern, 50)]
    floor = [launch_floor_ms(), launch_floor_ms()]
    n_slabs = len(b0.names)
    timings["B0 collide_slabs"].update(
        per_slab_calls_ms=(t[1] + t[2]) / 2, per_slab_calls_ms_runs=t[1:3],
        table_ms_runs_beside=[t[0], t[3]], slabs=n_slabs,
        launch_floor_ms=sum(floor) / 2, launch_floor_ms_runs=floor)
    print(f"  B0 {f32} exchange of {n_slabs} slabs: one call "
          f"{t[0]:.4f}, {t[3]:.4f} ms; {n_slabs} single-slab calls "
          f"{t[1]:.4f}, {t[2]:.4f} ms; launch floor (an empty kernel, back "
          f"to back) {floor[0]:.4f}, {floor[1]:.4f} ms; byte bound "
          f"{timings['B0 collide_slabs']['bound_ms']:.7f} ms", flush=True)
    timed_big.clear()
    torch.cuda.empty_cache()
    # B4 at 8192^2 in f64, its path's case in f64 raw slip, alone on the
    # card (its plain version holds about 30 GB)
    cfg = grids[big_name][0]
    f, _ = random_inputs(cfg, "raw", torch.float64, dev, seed=0)
    b4_big_f64 = case_b4(cfg, types.SimpleNamespace(K=K), f,
                         ref.WallSpec(top="slip"), "raw")
    run("B4 temporal_bulk", big_name, "float64", "raw", "slip", b4_big_f64,
        {"*": GATE["float64"]}, f"K={K}")
    timing_b4_big_f64 = time_case("B4 temporal_bulk", b4_big_f64,
                                  f"{big_name} f64 raw", 3, 1, worst,
                                  F64_FLOP_S)
    del f, b4_big_f64
    torch.cuda.empty_cache()
    record["kernel_timing"] = timings
    record["kernel_timing_8192"] = timings_big
    record["kernel_timing_2048_f64"] = timings_f64
    record["kernel_timing_8192_f64"] = {"B4 temporal_bulk": timing_b4_big_f64}
    # each kernel's time at the shapes of its main path: B6's is 8192^2
    # (on the budgeted plan)
    timings["B6 band_super_tiled"] = timings_big["B6 band_super_tiled"]
    return timings


def b4_is_b3_composed(cfg, kc, gname, dt, top):
    """B4's f on its case's inputs against K launches of B3 with flags
    (band, 0, 1) and the seam halo as the bottom halo row: the arithmetic
    of the first K-step driver, bit for bit."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.fused_step import sharded_fused_substep

    f_bulk, bhalos, walls, storage = kc.inputs
    cur = f_bulk
    for s in range(bhalos.shape[0]):
        cur = sharded_fused_substep((cfg.force_band, 0, 1), cur, None,
                                    bhalos[s], None, cfg, walls, "trt_split",
                                    storage)[0]
    got = kc.kern()[0]
    torch.cuda.synchronize()
    same = torch.equal(got, cur)
    err = float((got.double() - cur.double()).abs().max())
    print(f"  B4 vs {bhalos.shape[0]} launches of B3 {gname} {dt} top={top}: "
          f"bit-identical {same}, max|d| {err:.3e}", flush=True)
    return dict(grid=gname, dtype=dt, top=top, bit_identical=same,
                max_abs=err)


def kstep_line(kname, kc, shape):
    """The K-step driver's passes through device memory for a timed B4 or
    B7 case, its redundancy (cells collided over cells kept) and the
    arithmetic bound with the redundant work."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
        _sm_count, kstep_geometry,
    )

    yl, pad, width, K, dtype = kc.block
    geo = kstep_geometry(yl, pad, width, K, dtype,
                         _sm_count(torch.device(DEVICE)))
    p = geo.passes[0]
    flop_s = F32_FLOP_S if dtype == torch.float32 else F64_FLOP_S
    row = dict(hbm_passes_per_call=geo.hbm_passes,
               redundancy=geo.redundancy, depth=[q.kp for q in geo.passes],
               wc=p.wc, wt=p.wt, ly=p.ly, threads=p.threads,
               smem_bytes=p.smem_bytes, blocks=p.n_strips * p.n_seg,
               bound_with_redundancy_ms=kc.nflop * geo.redundancy / flop_s
               * 1e3)
    print(f"  {kname} {shape}: {geo.hbm_passes} HBM passes per call "
          f"(depths {row['depth']}), strips of {p.wt} of {p.wc} columns, "
          f"segments of {p.ly} rows, {row['blocks']} CUDA blocks of "
          f"{p.threads} threads and {p.smem_bytes} B of shared memory; "
          f"redundancy {geo.redundancy:.4f}, arithmetic bound with it "
          f"{row['bound_with_redundancy_ms']:.4f} ms", flush=True)
    return row


def time_case(kname, kc, shape, reps, plain_reps, worst, flop_s=F32_FLOP_S):
    """A kernel's mean time per call on the card, in turns with its plain
    version (plain, kernel, kernel, plain), beside its bytes and bound
    (operations over flop_s, the peak of the inputs' type)."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.probes import device_ms

    for fn in (kc.kern, kc.plain):
        fn()
    torch.cuda.synchronize()
    t = [device_ms(kc.plain, plain_reps), device_ms(kc.kern, reps),
         device_ms(kc.kern, reps), device_ms(kc.plain, plain_reps)]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    bytes_ms = kc.nbytes / HBM_BYTES_S * 1e3
    flop_ms = kc.nflop / flop_s * 1e3
    row = dict(shape=shape, ms=ms, plain_ms=plain_ms,
               ms_runs=t[1:3], plain_ms_runs=[t[0], t[3]],
               bytes_per_call=kc.nbytes, flop_per_call=kc.nflop,
               bound_ms=max(bytes_ms, flop_ms),
               bound_by="bytes" if bytes_ms >= flop_ms else "operations",
               max_abs_err=worst[kname])
    copies = getattr(kc, "copy_bytes", None)
    if copies is not None:
        row["tile_copy_bytes_per_call"] = copies
    if kname in KSTEP:
        row.update(kstep_line(kname, kc, shape))
    print(f"  {kname} {shape}: kernel {ms:.4f} ms "
          f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms "
          f"({t[0]:.4f}, {t[3]:.4f}); {kc.nbytes / 1e6:.1f} MB, "
          f"{kc.nflop / 1e9:.3f} GFLOP per call; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
          + ("" if copies is None else
             f"; tile gathers and copies {copies / 1e6:.1f} MB"),
          flush=True)
    return row



# --- phase 3: the bf16 entries ---------------------------------------------

# The bf16 entries (f in bf16, everything else f32), each named after its
# f32 kernel in KERNELS (source and TPU kernel are the same).
BF16_KERNELS = ("B2 fused_step", "B2h collide_stream",
                "B3 sharded_fused_step", "B4 temporal_bulk",
                "B5 band_super", "B6 band_super_tiled", "B0 collide_slabs",
                "B7 ghost_temporal", "B8 band_super_xsharded")
BF16_SHARE = 0.999   # of f bit-equal (ops/precision.bf16_agreement)
# floored ulps (ops/precision.bf16_agreement): B7's and B8's 16 contracted
# sub-steps part from their eager plain versions' by up to about 5e-7 of a
# plane's scale, two bf16 ulps at the 2^-14 floor (their f equals the f32
# entry's rounded, bit for bit, which pins the rounding point)
ULPS_GATE_KSTEP = 2.0


def bf16_inputs(cfg, dev, seed):
    """Seeded deviatoric f rounded to bf16 and an f32 band force, from the
    same draws as random_inputs' f32 case."""
    import torch

    f, force = random_inputs(cfg, "deviatoric", torch.float32, dev, seed)
    return f.to(torch.bfloat16), force


def run_bf16_case(kname, gname, kc, twin, gates, results, worst, extra="",
                  max_ulps=None):
    """A bf16 kernel against its plain version on the same inputs (each
    bf16 output at least BF16_SHARE bit-equal, its ulps printed, and with
    ``max_ulps`` every element within that many floored ulps; each f32
    output at its rel-L2 gate), and bit for bit against ``twin``, the f32
    entry on the same values widened, its f rounded to nearest even: the
    same f32 arithmetic, rounded where the TPU kernel rounds."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.precision import bf16_agreement

    got = kc.kern()
    want = kc.plain()
    same = twin.kern()
    torch.cuda.synchronize()
    errs = {}
    for n, g, w, t in zip(kc.names, got, want, same):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{kname} bf16 {n}: {g.dtype} {tuple(g.shape)} against "
              f"{w.dtype} {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{kname} bf16 {n}: not finite")
        check(t.dtype == torch.float32 and torch.equal(g, t.to(g.dtype)),
              f"{kname} bf16 {gname} {n}: not the f32 entry's result "
              f"rounded, bit for bit")
        if g.dtype == torch.bfloat16:
            share, ulps, floored = bf16_agreement(g, w)
            errs[n] = dict(bit_equal=share, max_ulps=ulps,
                           max_ulps_floored=floored)
            check(share >= BF16_SHARE, f"{kname} bf16 {gname} {n}: "
                  f"{share:.6f} bit-equal")
            check(max_ulps is None or floored <= max_ulps,
                  f"{kname} bf16 {gname} {n}: {floored} floored ulps")
        else:
            check(g.dtype == torch.float32, f"{kname} bf16 {n}: {g.dtype}")
            errs[n] = dict(rel_l2=rel_l2(g, w))
            gate = gates.get(n, gates["*"])
            check(errs[n]["rel_l2"] <= gate, f"{kname} bf16 {gname} {n}: "
                  f"rel-L2 {errs[n]['rel_l2']} > {gate}")
    err = max_abs(got, want)
    worst[kname] = max(worst.get(kname, 0.0), err)
    results.append(dict(kernel=kname, grid=gname, dtype="bfloat16",
                        case=extra, errors=errs, max_abs_err=err,
                        equals_f32_entry_rounded=True))
    print(f"  {kname} bf16 {gname} {extra}: " + " ".join(
        f"{n}=" + (f"{e['bit_equal']:.6%} bit-equal, {e['max_ulps']:.0f} "
                   f"ulps ({e['max_ulps_floored']:.0f} floored)"
                   if "bit_equal" in e else f"{e['rel_l2']:.3e}")
        for n, e in errs.items()) + f"  max|err|={err:.3e}; = the f32 "
        "entry rounded, bit for bit", flush=True)
    return got


def time_bf16(kname, kc16, kc32, shape, reps, plain_reps, worst):
    """The bf16 entry and the f32 entry on the same values widened, in
    turns (f32, bf16, bf16, f32), the bf16 plain version twice; the bf16
    call's bytes (f at 2 B a value) and bound."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.probes import device_ms

    for fn in (kc32.kern, kc16.kern, kc16.plain):
        fn()
    torch.cuda.synchronize()
    t = [device_ms(kc32.kern, reps), device_ms(kc16.kern, reps),
         device_ms(kc16.kern, reps), device_ms(kc32.kern, reps)]
    p = [device_ms(kc16.plain, plain_reps), device_ms(kc16.plain, plain_reps)]
    bytes_ms = kc16.nbytes / HBM_BYTES_S * 1e3
    flop_ms = kc16.nflop / F32_FLOP_S * 1e3
    row = dict(shape=shape, ms=(t[1] + t[2]) / 2, ms_runs=t[1:3],
               f32_ms=(t[0] + t[3]) / 2, f32_ms_runs=[t[0], t[3]],
               plain_ms=sum(p) / 2, plain_ms_runs=p,
               bytes_per_call=kc16.nbytes, f32_bytes_per_call=kc32.nbytes,
               flop_per_call=kc16.nflop, bound_ms=max(bytes_ms, flop_ms),
               bound_by="bytes" if bytes_ms >= flop_ms else "operations",
               f32_bound_ms=max(kc32.nbytes / HBM_BYTES_S,
                                kc32.nflop / F32_FLOP_S) * 1e3,
               max_abs_err=worst[kname])
    print(f"  {kname} bf16 {shape}: kernel {row['ms']:.4f} ms ({t[1]:.4f}, "
          f"{t[2]:.4f}), f32 kernel in turns {row['f32_ms']:.4f} ms "
          f"({t[0]:.4f}, {t[3]:.4f}), plain {row['plain_ms']:.4f} ms; "
          f"{kc16.nbytes / 1e6:.1f} MB (f32 {kc32.nbytes / 1e6:.1f} MB), "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 "
          f"{row['f32_bound_ms']:.4f})", flush=True)
    return row


def phase_bf16(record):
    """Phase 3: each bf16 entry against its plain version at its main
    path's shapes and bit for bit against its f32 entry on the same values
    widened, timed in turns with it at 2048^2 (B6 at 8192^2).  Returns
    each entry's timing row."""
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.collide_rows import collide_slabs
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes
    from cuda_iblb_11_tpu_torch.ops.temporal import (
        plan_sharded, plan_temporal,
    )

    print("== phase 3: the bf16 entries vs their plain versions on the card",
          flush=True)
    dev = torch.device(DEVICE)
    l2 = l2_bytes(dev)
    walls = ref.WallSpec(top="slip")
    st = "deviatoric"
    results, worst, timings = [], {}, {}
    g = {"*": GATE["float32"]}
    gi = {"force": GATE_IB["float32"], "flux": GATE_IB["float32"], "*": g["*"]}
    big_name, big_dims = BIG_GRID

    def bf16_cfg(gname):
        c, sp, y = {**GRIDS, big_name: big_dims}[gname]
        return SimConfig(c_num=c, c_space=sp, ydim=y, dtype="bfloat16")

    # the kernels at the shapes of their bf16 paths, each beside the f32
    # entry on the same values: at 288 x 192 the CLI's (B2 on the whole
    # grid, B2h at the quirk step's band, B3 on the per-sub-step leg's band
    # block, flags [0, 1, 0] without halos as the model calls it and with
    # a neighbour halo, B4 on the bulk at K = 16); at 2048^2 (auto: the
    # whole band super-step) the same and B5, timed there
    for gname, leg in (("288x192", "per_substep"),
                       (TIMING_GRID, "band_super_whole")):
        cfg = bf16_cfg(gname)
        plan = MucociliarySim(cfg, walls, backend="cuda", device=DEVICE,
                              temporal="auto").plan
        check(plan.K == K and plan.band_leg == leg,
              f"{gname} bf16: auto plan {plan}")
        f16, force = bf16_inputs(cfg, dev, seed=0)
        thalo = (f16[:, cfg.force_band + plan.pad].float()
                 * 1.001).contiguous()
        xs = super_points(cfg, plan, torch.bfloat16) \
            if plan.pad_s is not None else None
        cases = {}   # dtype -> [(kernel, case label, KernelCase)]
        for f in (f16, f16.float()):
            cs = [("B2 fused_step", "", case_b2(cfg, f, force, walls, st)),
                  ("B2h collide_stream", f"band={cfg.force_band}",
                   case_b2h(cfg, f, force, walls, st, cfg.force_band))]
            cs += [("B3 sharded_fused_step", f"flags=[0, 1, 0] pad="
                    f"{plan.pad} " + ("halo" if th is not None else
                                      "no halo (the model's call)"),
                    case_b3(cfg, plan, f, force, walls, st, (0, 1, 0), th))
                   for th in ((thalo, None) if gname == "288x192"
                              else (thalo,))]
            cs.append(("B4 temporal_bulk", f"K={K}",
                       case_b4(cfg, plan, f, walls, st)))
            if xs is not None:
                cs.append(("B5 band_super", f"K={K}",
                           case_b5(cfg, plan, f, force, walls, st, xs)))
            cases[f.dtype] = cs
        c16, c32 = cases[torch.bfloat16], cases[torch.float32]
        for (kname, extra, kc), (_, _, twin) in zip(c16, c32):
            run_bf16_case(kname, gname, kc, twin,
                          gi if kname == "B5 band_super" else g, results,
                          worst, extra)
        if gname == TIMING_GRID:
            for (kname, _, kc), (_, _, twin) in zip(c16, c32):
                slow = kname in ("B4 temporal_bulk", "B5 band_super")
                timings[kname] = time_bf16(kname, kc, twin,
                                           f"{gname} bf16 deviatoric",
                                           10 if slow else 50, 2, worst)
        del cases, c16, c32, f, f16, force, xs
        torch.cuda.empty_cache()

    # B6 at 8192^2 on the plan held to the card's L2 size, against its
    # plain version, the f32 entry at the same tiling, and bit for bit
    # against B5 on the same inputs
    cfg = bf16_cfg(big_name)
    whole = plan_temporal(cfg, K, walls, torch.bfloat16)
    xt = plan_temporal(cfg, K, walls, torch.bfloat16, budget=l2)
    check(xt.band_leg == "band_super_xtiled",
          f"{big_name} bf16: the budgeted plan took {xt.band_leg}")
    f16, force = bf16_inputs(cfg, dev, seed=0)
    xs = super_points(cfg, whole, torch.bfloat16)
    b6 = {f.dtype: case_b6(cfg, xt, f, force, walls, st, xs)
          for f in (f16, f16.float())}
    got6 = run_bf16_case("B6 band_super_tiled", big_name, b6[torch.bfloat16],
                         b6[torch.float32], gi, results, worst,
                         f"K={K} tile={xt.tile_x} gx={xt.gx} "
                         f"(budget {l2} B)")
    got5 = case_b5(cfg, whole, f16, force, walls, st, xs).kern()
    same = all(torch.equal(a, b) for a, b in zip(got6, got5))
    print(f"  B6 vs B5 {big_name} bf16: bit-identical {same}", flush=True)
    check(same, f"B6 vs B5 {big_name} bf16: not bit for bit")
    record["bf16_b6_vs_b5_bit_identical"] = same
    del got5, got6
    timings["B6 band_super_tiled"] = time_bf16(
        "B6 band_super_tiled", b6[torch.bfloat16], b6[torch.float32],
        f"{big_name} bf16 deviatoric, tile {xt.tile_x}", 10, 1, worst)
    del b6, f16, force, xs
    torch.cuda.empty_cache()

    # the mesh kernels: B0 on phase 2's three tables, B7 and B8 on its mesh
    # cases, timed at 2048^2 (B0's f1 is f32 in both entries)
    timed = {}
    for gname, mesh in (("288x192", (2, 1)), (TIMING_GRID, MESH),
                        (big_name, "seam")):
        cfg = bf16_cfg(gname)
        f16, force = bf16_inputs(cfg, dev, seed=0)
        f32 = f16.float()
        rows = None
        if mesh == "seam":   # the budgeted plan's per-sub-step leg
            sp = plan_sharded(cfg, K, *MESH, walls, torch.bfloat16,
                              budget=l2)
            check(sp.band_leg == "per_substep_tiled",
                  f"{gname} bf16 {MESH} budgeted plan {sp}")
            mesh, rows = MESH, cfg.force_band + sp.pad_b
        kc = case_b0(cfg, f16, force, st, mesh, rows)
        twin = case_b0(cfg, f32, force, st, mesh, rows)
        n0 = collide_slabs.launches
        run_bf16_case("B0 collide_slabs", gname, kc, twin, g, results,
                      worst, f"{mesh} {len(kc.names)} slabs"
                      + ("" if rows is None else f", {rows} rows"))
        check(collide_slabs.launches == n0 + 2,
              f"B0 bf16 {gname}: {collide_slabs.launches - n0} launches "
              "for the table and its twin, expected 2")
        if gname == TIMING_GRID:
            timed["B0 collide_slabs"] = (kc, twin)
        if gname != "288x192":
            shards = ((0, 1), (1, 0)) if gname == TIMING_GRID else ((0, 1),)
            for iy, ix in shards:
                kc, twin = (case_b7(cfg, x, walls, st, iy, ix, K)
                            for x in (f16, f32))
                run_bf16_case("B7 ghost_temporal", gname, kc, twin, g,
                              results, worst, f"{MESH} shard ({iy}, {ix}), "
                              f"K={K}", max_ulps=ULPS_GATE_KSTEP)
                if gname == TIMING_GRID:
                    timed.setdefault("B7 ghost_temporal", (kc, twin))
            for ix in (1, 0) if gname == TIMING_GRID else (1,):
                kc, twin = (case_b8(cfg, x, force, walls, st, ix, K,
                                    torch.bfloat16) for x in (f16, f32))
                run_bf16_case("B8 band_super_xsharded", gname, kc, twin, gi,
                              results, worst, f"{MESH} x-shard {ix}, K={K}",
                              max_ulps=ULPS_GATE_KSTEP)
                if gname == TIMING_GRID:
                    timed.setdefault("B8 band_super_xsharded", (kc, twin))
        if gname == TIMING_GRID:
            timings.update({kname: time_bf16(
                kname, kc, twin, f"{gname} bf16 deviatoric",
                50 if kname.startswith("B0") else 10, 2, worst)
                for kname, (kc, twin) in timed.items()})
            timed.clear()
        del f16, f32, force
        torch.cuda.empty_cache()
    check(set(timings) == set(BF16_KERNELS), f"bf16 entries timed: "
                                             f"{sorted(timings)}")
    record["bf16_kernel_vs_plain"] = results
    record["bf16_kernel_timing"] = timings
    return timings


def main():
    ap = argparse.ArgumentParser(
        description="the kernels' timer of the port on one GPU")
    ap.add_argument("--record", default=os.path.join(REPO, "build",
                                                      "chip_smoke.json"),
                    help="where to write the detailed JSON record")
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="another checkout (e.g. the parent commit's "
                         "git archive under build/): phase 2 also holds "
                         "every f32 and f64 case bit for bit against the "
                         "build of its csrc/")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from cuda_iblb_11_tpu_torch.ops import _kernels

    record = {}
    print("== phase 1: environment", flush=True)
    smi = card_line()
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
    other = None
    if args.against:
        from cuda_iblb_11_tpu_torch.probe_band_super import other_library

        other = other_library(args.against)
        env["against"] = os.path.abspath(args.against)
    for k, v in env.items():
        print(f"  {k}: {v}", flush=True)

    timings = phase_kernels(record, other)
    timings.update({f"{k} bf16": row
                    for k, row in phase_bf16(record).items()})
    kernels = {"kernels": [dict(
        name=kname, route="cuda", source=src, replaces=rep,
        max_abs_err=timings[kname]["max_abs_err"],
        ms=timings[kname]["ms"], plain_ms=timings[kname]["plain_ms"],
        bound_ms=timings[kname]["bound_ms"],
        bound_by=timings[kname]["bound_by"])
        for kname, (src, rep) in list(KERNELS.items()) + [
            (f"{k} bf16", KERNELS[k]) for k in BF16_KERNELS]]}
    record["kernels"] = kernels["kernels"]
    os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
    with open(args.record, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(kernels))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
