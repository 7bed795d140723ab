#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH] [--against DIR]

Phases; any failure exits non-zero before the final line:
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
          shard width of the mesh legs of phase 5: the 8192 x 8192 (2, 2)
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
     then each kernel's time at 2048 x 2048 f32 beside its plain version
     (CUDA events after a spin kernel, plain/kernel/kernel/plain), its
     bytes and its bound; B4-B8 also at 8192 x 8192 f32, B4-B7 at 2048 x
     2048 f64 (B5 and B6 both against B5's bound there, the same
     function), B4 at 8192 x 8192 f64; for B4 and B7 the K-step driver's
     HBM passes per call, its redundancy and the arithmetic bound with
     it; B0's one call against the same 16 slabs one launch each, in
     turns, beside the launch floor (an empty kernel, back to back);
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
     ms/step and MLUPS of each; the band super-step's accuracy gate: 384
     x 256 (3 cilia), 500 steps on backend "cuda" in f32 at temporal 4
     (band_super_whole) against backend "torch" in f64 raw, velocity
     rel-L2 < 1e-5; then 32 steps at 8192 x 8192 (64 cilia),
     single-step, temporal "auto" (K = 16, band_super_whole: one B5 and
     one B4 launch per 16 steps) and the x-tiled leg (the plan held to the
     card's L2 size: 8 B6 tile launches and one B4 launch per 16 steps),
     each twice in turns, with peak memory; velocity rel-L2 of the auto
     run against single-step <= 1e-5, the x-tiled run equal to it bit for
     bit, and the two legs' ms/step side by side;
  5. the mesh on the card, every shard on the one card (f32, through the
     runner's mesh resolution): at temporal "auto", 2048 x 2048 on (2, 2)
     (B8 + B7) and (2, 1) (B5 + B7), 64 steps, and 8192 x 8192 on (2, 2)
     (B8 on the 5,120-column block + B7), 32 steps, and again on the plan
     held to the card's L2 size (per_substep_tiled: B3 per x-column and
     one B0 call per sub-step, the torch IB, B7), 32 steps; at temporal 1,
     2048 x 2048 on (2, 2), 64 steps (B3 per shard and one B0 call per
     step);
     each against the single-device run at the same temporal: velocity
     rel-L2 and flux rel <= 1e-5, exact launch counts, ms/step, MLUPS and
     peak memory; then the CLI with --mesh 2,1, 2,000 steps at 288 x 192
     (one B0 call per per-step exchange): flux within 2e-5 of the f64
     golden and within 1e-5 of phase 3's unsharded auto run;
  6. the quirk path: the CLI of phase 3 with --ib-x-edge reference, with
     --temporal 1 (one B2h launch per step), with auto (K = 16, the
     per-sub-step leg with the stencil IB: 1,984 B3, 124 B4 and 16 B2h
     launches), twice, and with --backend torch: each kernel run's flux
     within 1e-5 of the torch run's and of the other's, the two auto runs'
     Flux files equal byte for byte, SimLog naming stencil_quirk; then
     2048 x 2048 (16 cilia) 512 steps cuda against torch backend, velocity
     rel-L2 <= 1e-5, ms/step and MLUPS, and the same in f64 over 64 steps,
     velocity rel-L2 <= 1e-12;
  7. the validation models: the Poiseuille channel 16 x 32 (8,000 steps,
     f64 raw and f32 deviatoric, every step a B2h launch) within 3e-3 of
     its analytic profile; a 2048 x 2048 channel, 512 steps: B2h against
     the plain version in f64 raw (f rel-L2 <= 1e-12), and in f32
     deviatoric each against B2h in f64 (B2h no further from it than the
     plain version) and against each other (velocity rel-L2 <= 1e-5),
     ms/step and MLUPS; the lid-driven cavity 64 x 64 at Re 100, 30,000
     plain torch steps on the card, within 0.025 lid units of Ghia;
  8. the card's ceilings: P2, P3 and P1 (6,000 links) against their plain
     versions, bit for bit, on seeded data that differs from element to
     element (P2 and P3 into outputs filled with NaN; the plain fma link
     rounds once, as fmaf does), then probe_bw (3 reps) and probe_vpu,
     their GB/s and TFLOP/s and shares of the data sheet's peaks, P3's
     time at 32 KiB depth 2 over copy_'s from the same run, and P3's rate
     at each run length a block streams;
  9. accuracy on the card: at 192 x 192 with 4 cilia, the f64 raw
     single-step run (B2 in f64) against f32 single-step (B2) and f32
     temporal "auto" (K = 16, the per-sub-step leg: B3 + the torch IB +
     B4), 4,000 steps read at 500 / 2,000 / 4,000: velocity rel-L2 of each
     f32 run < 1e-5 / 3e-5 / 8e-5 and the 4,000-step error < 12 x the
     500-step one (tests/test_accuracy_horizon.py:50-73), exact launch
     counts of each run; then 2048 x 2048 (16 cilia) temporal "auto" (B5 +
     B4) against temporal 1 (B2) after 2,048 steps, velocity rel-L2
     <= 1e-5, exact launch counts;
 10. the reference's experiments on the card: two metachrony sweep points
     (sweep_metachrony.run_point: 2048 x 2048, 16 cilia, c_fraction 4 and
     16), 4,000 steps in 2 chunks, in f32 and f64: exactly 250 B5 and 250
     B4 launches and no B2 a run on band_super_whole at K = 16, every
     chunk finite, f32 Q within 2e-4 of f64 (the runs read 1.1e-5 and
     3.0e-5), the two c_fractions' Q apart by more than that, ms/step and
     MLUPS; then validate_flux.run_leg at
     the reference channel (288 x 192, 6 cilia, temporal 1), 2,000 steps
     in 20 samples: 2,000 B2 launches, every 100-step sample within 1e-9
     (f64) and 2e-5 (f32) of validation/flux_early_f64_c6.dat, in lattice
     units;
 11. bf16 storage on the card (f in bf16, everything else f32): each
     _bf16 entry against its plain version on seeded inputs, into outputs
     filled with NaN: B2, B2h, B3 (the band leg's extended band, flags
     [0, 1, 0]: at 288 x 192 without halos as the per-sub-step leg calls
     it and with a neighbour halo) and B4 (K = 16) at 288 x 192 and 2048 x
     2048, B5 at 2048 x 2048 (K = 16) and B6 at 8192 x 8192 on the plan
     held to the card's L2 size (4 tiles of 2,048): f at least 99.9%
     bit-equal
     (ops/precision.bf16_agreement; the share and the ulps printed), the
     f32 outputs at the f32 gates, and every output bit for bit the f32
     entry's on the same values widened, f rounded to nearest even; B6
     bit for bit with B5; each timed in turns with that f32 entry (f32,
     bf16, bf16, f32) beside its plain version and its bound (f at 2 B a
     value); then the CLI of phase 3 with --dtype bfloat16 at --temporal
     1 and auto (the f32 runs' launch counts, final Q within 2% of
     theirs), 2048 x 2048 auto over 24,576 steps in bf16 against f32 in
     turns (velocity rel-L2 and Q within 1e-2), 8192 x 8192 bf16 on the
     x-tiled leg (B6) against the whole leg (B5), bit for bit, and the
     2048 x 2048 quirk: 512 B2h steps in bf16, then one step from that
     state on the cuda and the torch backend in bf16 less than half as
     far apart (f and velocity) as the torch backend's bf16 from its f32;
 12. the rest of the mesh on the card (every shard on the one card): (a)
     the quirk IB on a mesh: the CLI of phase 6 with --mesh 2,1 at
     --temporal 1 (2 B3 and one B0 call a step) and auto (K = 16,
     per_substep_tiled with the stencil IB: B3 per sub-step, B7; the
     remainder per step), exact launches, SimLog naming stencil_quirk and
     the leg, flux within 1e-5 of phase 6's unsharded run at the same
     temporal; 2048 x 2048 on (2, 2) at temporal 1 and auto, 64 steps,
     against the single-device quirk (velocity rel-L2 and flux rel <=
     1e-5; ms/step, MLUPS, peak memory; exact launches), and in f64 at
     temporal 1 over 16 steps (<= 1e-12); (b) B0's bf16 entry on phase 2's
     three tables (288 x 192 (2, 1), 2048 x 2048 (2, 2), the 8192 x 8192
     (2, 2) seam columns of the budgeted plan), B7 and B8 in bf16 on phase
     2's mesh cases (2048 x 2048 both shards, 8192 x 8192 one), each
     against its plain version (at least 99.9% of f bit-equal, every
     element within one floored ulp; f32 outputs at the f32 gates, B8's
     force and flux at B5's) and bit for bit the f32 entry on the same
     values widened, one launch a call, timed in turns with it at 2048 x
     2048; (c) bf16 meshes: 2048 x 2048 on (2, 2) auto (B8 + B7), (2, 1)
     auto (B5 + B7) and (2, 2) temporal 1 (B3 + B0), 64 steps, and 8192 x
     8192 on (2, 2) auto, 32 steps, each timed in turns with the f32 mesh
     (f32, bf16, bf16, f32; exact launches), one call from the
     single-device bf16 run's end at least 99.9% bit-equal to that run's
     and within one floored ulp, and its velocity after the run less than
     half as far from the single-device bf16 run as that is from f32 (at
     temporal 1, whose IB reads the stored bf16 f as JAX's mesh does where
     the single-device step reads B2's f32 planes, within twice that
     distance); then the quirk CLI in bf16 on (2, 1), whose final Q lies
     nearer the unsharded bf16 quirk run's than phase 6's f32 run's does.

The launch counts of each path are set to 0 just before it and read just
after.  The kernels line lists each kernel, then each bf16 entry as
"<kernel> bf16" with its launches on its bf16 path (B2 on the bf16 CLI at
--temporal 1, B3 and B4 on its auto run, B5 on 2048 x 2048 auto, B6 on
the 8192 x 8192 x-tiled leg, B2h on the 2048 x 2048 quirk run, B0 on the
2048 x 2048 (2, 2) bf16 mesh at temporal 1, B7 and B8 on its auto run).
The last lines are the kernels JSON line, the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": {...}}.  A
detailed JSON record goes to PATH (default build/chip_smoke.json).  With
--against DIR (another checkout, e.g. the parent commit's ``git archive``
unpacked under build/), phase 2 also builds DIR's csrc/ and holds every
f32 and f64 case's kernel outputs bit for bit against that build's.
"""

import argparse
import json
import os
import shutil
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
REAL_SIZE_STEPS = 512
ACCURACY_STEPS = 500                  # the band super-step accuracy gate
BIG_GRID = ("8192x8192", (64, 128, 8192), 32)
BIG_TILE = (1024, 512)   # (tile_x, gx) of auto's x-tiled leg there
MAIN_ARGV = ["1", "6", "48", "1.0", "1.0", "5", "0.02", "4", "0", "0"]
MESH = (2, 2)     # the mesh of phase 2's B0, B7 and B8 cases
# phase 5: (grid, mesh, temporal, the plan held to the card's L2 size,
# steps, band leg, launches per exchange (a super-step, or a step at
# temporal 1) by kernel: per x-column for the band leg and the per-sub-step
# B3, per shard for B7 and the per-step B3, one B0 call for every slab of
# an exchange)
MESH_RUNS = (
    ("2048x2048", (2, 2), "auto", False, 64, "band_super_xsharded",
     {"B8 band_super_xsharded": 2, "B7 ghost_temporal": 4}),
    ("2048x2048", (2, 1), "auto", False, 64, "band_super_whole",
     {"B5 band_super": 1, "B7 ghost_temporal": 2}),
    ("8192x8192", (2, 2), "auto", False, 32, "band_super_xsharded",
     {"B8 band_super_xsharded": 2, "B7 ghost_temporal": 4}),
    ("8192x8192", (2, 2), "auto", True, 32, "per_substep_tiled",
     {"B3 sharded_fused_step": 2 * K, "B0 collide_slabs": K,
      "B7 ghost_temporal": 4}),
    ("2048x2048", (2, 2), 1, False, 64, "sharded_per_step",
     {"B3 sharded_fused_step": 4, "B0 collide_slabs": 1}),
)
FLUX_ITS = (500, 1000, 1500, 2000)   # rows held against the f64 golden
# phase 9: velocity rel-L2 gates of f32 against f64 at 192^2 by horizon,
# and the most the error may grow from the first horizon to the last
# (tests/test_accuracy_horizon.py:50-73); the 2048^2 horizon
ACCURACY_GATES = {500: 1e-5, 2000: 3e-5, 4000: 8e-5}
ACCURACY_GROWTH = 12.0
LONG_STEPS = 2048
# phase 10: the sweep's points, steps and chunks, its f32-vs-f64 gate; the
# flux curve's steps, samples and gates against the early f64 golden
SWEEP_POINTS = (4, 16)
SWEEP_STEPS, SWEEP_CHUNKS = 4000, 2
SWEEP_GATE = 2e-4
FLUX_STEPS, FLUX_SAMPLES = 2000, 20
FLUX_GATES = {"float64": 1e-9, "float32": 2e-5}

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

PROBES = ("P1 probe_chain", "P2 probe_copy", "P3 probe_ring_copy")
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
    "P1 probe_chain": ("cuda_iblb_11_tpu_torch/csrc/probes.cu",
                       "scripts/probe_vpu.py:59"),
    "P2 probe_copy": ("cuda_iblb_11_tpu_torch/csrc/probes.cu",
                      "scripts/probe_bw.py:72"),
    "P3 probe_ring_copy": ("cuda_iblb_11_tpu_torch/csrc/probes.cu",
                           "scripts/probe_bw.py:117"),
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


def wrappers():
    """The kernel wrappers, by kernel name."""
    from cuda_iblb_11_tpu_torch.ops.band_super import band_super
    from cuda_iblb_11_tpu_torch.ops.band_super_tiled import band_super_tiled
    from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
        band_super_xsharded,
    )
    from cuda_iblb_11_tpu_torch.ops import probes
    from cuda_iblb_11_tpu_torch.ops.collide_rows import collide_slabs
    from cuda_iblb_11_tpu_torch.ops.collide_stream import collide_stream
    from cuda_iblb_11_tpu_torch.ops.fused_step import (
        fused_substep, sharded_fused_substep,
    )
    from cuda_iblb_11_tpu_torch.ops.ghost_temporal import ghost_temporal
    from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk

    return dict(zip(KERNELS, (fused_substep, sharded_fused_substep,
                              temporal_bulk, band_super, band_super_tiled,
                              collide_slabs, ghost_temporal,
                              band_super_xsharded, collide_stream,
                              probes.probe_chain, probes.probe_copy,
                              probes.probe_ring_copy)))


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
    big_name, big_dims, _ = BIG_GRID
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
                # card's L2 size (phase 5) it takes the per-sub-step leg:
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
                # the per-step leg of the CLI's --mesh 2,1 (phase 5): the
                # top shard's block and one exchange's edge rows
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
    check(set(worst) == set(KERNELS) - set(PROBES),
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


# --- phase 3: the CLI, single-step and temporal auto ----------------------

def run_cli(label, extra, gold, record):
    """The port's CLI at MAIN_ARGV with `extra` flags: its launches, SimLog
    and flux at FLUX_ITS, each held within 1e-3 of the f64 golden `gold`
    (None: recorded only)."""
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
        if gold is None:
            rows.append(dict(it=it, q=q))
            continue
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


def flux_bytes(label):
    with open(os.path.join(REPO, "build", "chip_smoke", label, "Flux",
                           "1_6_48_1_1x5-flux.dat"), "rb") as fh:
        return fh.read()


def phase_main_path(record):
    import numpy as np

    print("== phase 3: main path, the port's CLI on the card", flush=True)
    gold = np.loadtxt(os.path.join(REPO, "validation",
                                   "flux_early_f64_c6.dat"))
    cfg, n1, log1, q1 = run_cli("cli_temporal_1", ["--temporal", "1"], gold,
                                record)
    steps = cfg.iterations
    zero = dict.fromkeys(KERNELS, 0)
    check(n1 == {**zero, "B2 fused_step": steps},
          f"--temporal 1 launches {n1}, expected {steps} B2")
    check("Kernel path: single_step" in log1 and "Resolved backend: cuda"
          in log1, "SimLog does not record the single-step cuda path")

    _, na, loga, qa = run_cli("cli_temporal_auto", [], gold, record)
    interval = cfg.interval
    n_super = min(interval, 512) // K
    rest = interval - n_super * K
    want = {**zero, "B2 fused_step": rest * (steps // interval),
            "B3 sharded_fused_step": n_super * K * (steps // interval),
            "B4 temporal_bulk": n_super * (steps // interval)}
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
    return n1, na, qa


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
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_temporal
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes

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
    c, s, y = GRIDS[name]
    cfg = SimConfig(c_num=c, c_space=s, ydim=y)
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
            want = {**dict.fromkeys(KERNELS, 0),
                    "B4 temporal_bulk": steps // K,
                    "B5 band_super": steps // K}
            check(launches == want, f"{name} auto launches {launches}")
    err = rel_l2(us["auto"], us[1])
    print(f"  {name} velocity rel-L2 temporal auto vs 1 after {steps} "
          f"steps: {err:.3e}", flush=True)
    rows.append(dict(grid=name, velocity_rel_l2_temporal_vs_single=err))
    check(err <= 1e-5, f"{name}: temporal vs single velocity rel-L2 {err}")
    del sims, us

    # the band super-step's accuracy gate (tests/test_accuracy_horizon.py
    # :87-104 on the card): f32 (storage auto) at temporal 4 against the
    # torch backend in f64 raw, 500 steps at 384 x 256 with 3 cilia
    cfg64 = SimConfig(c_num=3, c_space=128, ydim=256, dtype="float64",
                      storage="raw")
    s64 = MucociliarySim(cfg64, backend="torch", device=DEVICE)
    ssup = MucociliarySim(cfg64.replace(dtype="float32", storage="auto"),
                          backend="cuda", device=DEVICE, temporal=4)
    check(ssup.resolved_config()["band_leg"] == "band_super_whole",
          f"accuracy gate plan {ssup.plan}")
    u64 = s64.fields(s64.run_chunk(s64.init_state(), ACCURACY_STEPS))[1]
    u32 = ssup.fields(ssup.run_chunk(ssup.init_state(), ACCURACY_STEPS))[1]
    err = rel_l2(u32, u64)
    print(f"  384x256 band super-step f32 vs torch f64 velocity rel-L2 "
          f"after {ACCURACY_STEPS} steps: {err:.3e}", flush=True)
    rows.append(dict(grid="384x256", steps=ACCURACY_STEPS,
                     velocity_rel_l2_band_super_f32_vs_f64=err))
    check(err < 1e-5, f"band super-step accuracy gate: velocity rel-L2 "
                      f"{err} >= 1e-5")
    del s64, ssup, u64, u32

    name, (c, s, y), n = BIG_GRID
    cfg = SimConfig(c_num=c, c_space=s, ydim=y)
    l2 = l2_bytes(DEVICE)
    sims = {}
    for label in ("temporal 1", "temporal auto", "x-tiled leg"):
        sim = MucociliarySim(cfg, backend="cuda", device=DEVICE,
                             temporal=1 if label == "temporal 1" else "auto")
        if label == "temporal auto":
            check((sim.plan.K, sim.plan.band_leg) == (K, "band_super_whole"),
                  f"{name} auto resolved {sim.plan}")
        elif label == "x-tiled leg":
            # the same K-step path on the plan held to the card's L2 size
            # as a budget
            sim.plan = plan_temporal(cfg, K, sim.walls, sim.dtype, budget=l2)
            p = sim.plan
            check((p.band_leg, p.tile_x, p.gx) == ("band_super_xtiled",
                                                   *BIG_TILE),
                  f"{name} x-tiled plan {p}")
        sim.run_chunk(sim.init_state(), max(2, sim.temporal))
        sims[label] = sim
    zero = dict.fromkeys(KERNELS, 0)
    n_super = n // K
    want = {"temporal 1": {**zero, "B2 fused_step": n},
            "temporal auto": {**zero, "B4 temporal_bulk": n_super,
                              "B5 band_super": n_super},
            "x-tiled leg": {**zero, "B4 temporal_bulk": n_super,
                            "B6 band_super_tiled": n_super * (
                                cfg.xdim // BIG_TILE[0])}}
    # each leg twice, in turns (single, auto, x-tiled, x-tiled, auto,
    # single): one 32-step run is short enough for a host hiccup to show
    us, launched = {}, {}
    for label in list(sims) + list(sims)[::-1]:
        sim = sims[label]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        st, sec = _timed_run(sim, n)
        launches = read_launches()
        check(launches == want[label], f"{name} {label} launches "
                                       f"{launches}, expected {want[label]}")
        launched[label] = launches
        if label not in us:
            us[label] = sim.fields(st)[1]
            check(bool(torch.isfinite(us[label]).all()),
                  f"{name} {label}: non-finite")
        rc = sim.resolved_config()
        _report(rows, name, label, cfg, st, sec, n, K=rc["temporal"],
                band_leg=rc["band_leg"], launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del st
    del sims
    errs = {f"{a} vs {b}": rel_l2(us[a], us[b]) for a, b in (
        ("temporal auto", "temporal 1"), ("x-tiled leg", "temporal 1"),
        ("x-tiled leg", "temporal auto"))}
    same = torch.equal(us["x-tiled leg"], us["temporal auto"])
    print(f"  {name} velocity rel-L2 after {n} steps: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; x-tiled leg = auto bit for bit: {same}", flush=True)
    rows.append(dict(grid=name, velocity_rel_l2=errs,
                     xtiled_equals_auto_bit_for_bit=same))
    err = errs["temporal auto vs temporal 1"]
    check(err <= 1e-5, f"{name}: auto vs single velocity rel-L2 {err}")
    check(same, f"{name}: the x-tiled leg (B6) is not the whole leg (B5) "
                "bit for bit")
    # the two legs side by side: the whole one auto takes (B5) and the
    # x-tiled one of the budgeted plan (B6), each turn's ms/step
    legs = {label: [r["ms_per_step"] for r in rows
                    if r.get("grid") == name and r.get("run") == label]
            for label in ("temporal auto", "x-tiled leg")}
    print(f"  {name} band legs, ms/step in turns: whole (auto) "
          + ", ".join(f"{v:.4f}" for v in legs["temporal auto"])
          + "; x-tiled (budgeted) "
          + ", ".join(f"{v:.4f}" for v in legs["x-tiled leg"]), flush=True)
    rows.append(dict(grid=name, band_legs_ms_per_step=legs))
    record["real_size"] = rows
    return temporal_launches, launched["x-tiled leg"]


# --- phase 5: the mesh on the card --------------------------------------

def phase_mesh(record, q_auto):
    """Each MESH_RUNS run through the runner's mesh resolution (at its
    temporal), every shard on the one card, against the single-device run
    at the same temporal; then the CLI with --mesh 2,1.  Returns each
    run's launches."""
    import numpy as np
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded
    from cuda_iblb_11_tpu_torch.runner import _make_mesh_sim

    print("== phase 5: the mesh on the card (shards share it)", flush=True)
    rows, launched = [], {}
    for name, mesh, temporal, budgeted, n, leg, per_exchange in MESH_RUNS:
        c, s, y = {**GRIDS, BIG_GRID[0]: BIG_GRID[1]}[name]
        cfg = SimConfig(c_num=c, c_space=s, ydim=y)
        label = f"{name} mesh {mesh[0]},{mesh[1]}" + (
            "" if temporal == "auto" else f" temporal {temporal}") + (
            " budgeted" if budgeted else "")
        msim = _make_mesh_sim(cfg, "auto", "trt_split", temporal,
                              f"{mesh[0]},{mesh[1]}", "periodic",
                              "no_mucus", torch.device(DEVICE))
        if budgeted:
            # the leg of the plan held to the card's L2 size (auto plans
            # no budget and takes B8 here)
            msim.plan = plan_sharded(cfg, K, *mesh, msim.walls, msim.dtype,
                                     budget=l2_bytes(DEVICE))
            msim._kernel_path = msim.plan.band_leg
        rc = msim.resolved_config()
        k_run = K if temporal == "auto" else temporal
        check(rc["temporal"] == k_run and rc["band_leg"] == leg
              and rc["backend"] == "cuda", f"{label} resolved {rc}")
        single = MucociliarySim(cfg, backend="cuda", device=DEVICE,
                                temporal=temporal)
        us = {}
        for run_label, sim in (("mesh", msim), ("single", single)):
            sim.run_chunk(sim.init_state(), K)            # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            st, sec = _timed_run(sim, n)
            launches = read_launches()
            us[run_label] = (sim.fields(st)[1], float(st.q))
            check(bool(torch.isfinite(us[run_label][0]).all()),
                  f"{label} {run_label}: non-finite")
            rc = sim.resolved_config()
            _report(rows, name, f"{run_label} {rc['mesh'] or 'unsharded'} "
                    f"temporal {temporal}"
                    + (" budgeted" if budgeted and run_label == "mesh"
                       else ""),
                    cfg, st, sec, n, K=rc["temporal"],
                    band_leg=rc["band_leg"], launches=launches,
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if run_label == "mesh":
                want = {**dict.fromkeys(KERNELS, 0),
                        **{k: v * (n // k_run)
                           for k, v in per_exchange.items()}}
                check(launches == want, f"{label} launches {launches}, "
                                        f"expected {want}")
                launched[label] = launches
            del st
        err = rel_l2(us["mesh"][0], us["single"][0])
        qrel = abs(us["mesh"][1] - us["single"][1]) / abs(us["single"][1])
        same = torch.equal(us["mesh"][0], us["single"][0])
        print(f"  {label} vs single-device after {n} steps: velocity "
              f"rel-L2 {err:.3e}, flux rel {qrel:.3e}, bit-identical "
              f"{same}", flush=True)
        rows.append(dict(grid=name, mesh=list(mesh), temporal=temporal,
                         budgeted=budgeted, band_leg=leg,
                         velocity_rel_l2_mesh_vs_single=err,
                         flux_rel_mesh_vs_single=qrel,
                         velocity_bit_identical=same))
        check(err <= 1e-5 and qrel <= 1e-5,
              f"{label}: mesh vs single velocity {err}, flux {qrel}")
        del msim, single, us
        torch.cuda.empty_cache()
    record["mesh"] = rows

    gold = np.loadtxt(os.path.join(REPO, "validation",
                                   "flux_early_f64_c6.dat"))
    cfg, nm, logm, qm = run_cli("cli_mesh_2x1", ["--mesh", "2,1"], gold,
                                record)
    interval, steps = cfg.interval, cfg.iterations
    n_super = min(interval, 512) // K
    rest = (interval - n_super * K) * (steps // interval)
    n_super *= steps // interval
    want = {**dict.fromkeys(KERNELS, 0),
            "B3 sharded_fused_step": n_super * K + 2 * rest,
            "B7 ghost_temporal": 2 * n_super, "B0 collide_slabs": rest}
    check(nm == want, f"--mesh 2,1 launches {nm}, expected {want}")
    check("Mesh: 2,1 over 1 device(s)" in logm
          and "Kernel path: per_substep_tiled" in logm
          and "Temporal K: 16 (auto: K=16" in logm,
          "SimLog does not record the mesh, its leg and K")
    for r in record["cli_mesh_2x1"]["flux"]:
        check(r["rel"] <= 2e-5, f"--mesh 2,1 flux at it={r['it']} off the "
                                f"f64 golden by {r['rel']}")
    rel = {it: abs(qm[it] - q_auto[it]) / abs(q_auto[it]) for it in FLUX_ITS}
    record["cli_mesh_vs_unsharded"] = rel
    print(f"  --mesh 2,1 vs unsharded auto flux rel: {rel}", flush=True)
    check(max(rel.values()) <= 1e-5, f"--mesh 2,1 vs unsharded flux {rel}")
    launched["cli_mesh_2x1"] = nm
    return launched


# --- phase 6: the quirk path ----------------------------------------------

QUIRK = ["--ib-x-edge", "reference"]


def phase_quirk(record):
    """The CLI in the strict-parity quirk mode three ways (B2h per step,
    auto's per-sub-step leg, the plain versions), auto twice; then 2048^2
    with 16 cilia, cuda against torch backend.  Returns the launches of
    the --temporal 1 run."""
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig

    print("== phase 6: the quirk path (--ib-x-edge reference)", flush=True)
    runs = {}
    for label, extra in (("quirk_temporal_1", ["--temporal", "1"]),
                         ("quirk_auto", []), ("quirk_auto_again", []),
                         ("quirk_torch", ["--backend", "torch"])):
        cfg, n, log, q = run_cli(label, QUIRK + extra, None, record)
        check("IB path: stencil_quirk" in log,
              f"{label}: SimLog does not name the stencil_quirk IB path")
        runs[label] = (n, log, q)
    steps, interval = cfg.iterations, cfg.interval
    n_super = min(interval, 512) // K
    rest = (interval - n_super * K) * (steps // interval)
    n_super *= steps // interval
    zero = dict.fromkeys(KERNELS, 0)
    want = {"quirk_temporal_1": {**zero, "B2h collide_stream": steps},
            "quirk_auto": {**zero, "B3 sharded_fused_step": n_super * K,
                           "B4 temporal_bulk": n_super,
                           "B2h collide_stream": rest},
            "quirk_torch": zero}
    want["quirk_auto_again"] = want["quirk_auto"]
    for label, (n, log, _) in runs.items():
        check(n == want[label], f"{label} launches {n}, expected "
                                f"{want[label]}")
    check("Kernel path: single_step" in runs["quirk_temporal_1"][1]
          and "Kernel path: per_substep" in runs["quirk_auto"][1]
          and "Temporal K: 16 (auto: K=16" in runs["quirk_auto"][1],
          "SimLog does not record the quirk legs")
    q_torch = runs["quirk_torch"][2]
    rel = {}
    for label in ("quirk_temporal_1", "quirk_auto"):
        rel[label] = {it: abs(runs[label][2][it] - q_torch[it])
                      / abs(q_torch[it]) for it in FLUX_ITS}
    rel["auto_vs_temporal_1"] = {
        it: abs(runs["quirk_auto"][2][it] - runs["quirk_temporal_1"][2][it])
        / abs(runs["quirk_temporal_1"][2][it]) for it in FLUX_ITS}
    same = flux_bytes("quirk_auto") == flux_bytes("quirk_auto_again")
    record["quirk_flux_rel"] = rel
    record["quirk_auto_runs_byte_identical"] = same
    print(f"  flux rel: {rel}; two auto runs byte-identical: {same}",
          flush=True)
    for label, r in rel.items():
        check(max(r.values()) <= 1e-5, f"quirk flux {label}: {r}")
    check(same, "two quirk auto runs wrote different Flux files")

    name = TIMING_GRID
    c, sp, y = GRIDS[name]
    cfg = SimConfig(c_num=c, c_space=sp, ydim=y)
    rows, us = [], {}
    for b in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=b, device=DEVICE,
                             ib_x_edge="reference")
        sim.run_chunk(sim.init_state(), 4)
        reset_launches()
        st, sec = _timed_run(sim, REAL_SIZE_STEPS)
        launches = {k: v for k, v in read_launches().items() if v}
        us[b] = sim.fields(st)[1]
        check(bool(torch.isfinite(us[b]).all()), f"quirk {name} {b}: "
                                                 "non-finite")
        _report(rows, name, f"quirk backend {b}", cfg, st, sec,
                REAL_SIZE_STEPS, launches=launches)
    err = rel_l2(us["cuda"], us["torch"])
    print(f"  quirk {name} velocity rel-L2 cuda vs torch: {err:.3e}",
          flush=True)
    rows.append(dict(grid=name, velocity_rel_l2_cuda_vs_torch=err))
    check(err <= 1e-5, f"quirk {name}: cuda vs torch velocity rel-L2 {err}")
    # the f64 witness: the same run in f64, 64 steps, where round-off
    # alone leaves the two backends about 1e-15 apart
    cfg = SimConfig(c_num=c, c_space=sp, ydim=y, dtype="float64")
    for b in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=b, device=DEVICE, temporal=1,
                             ib_x_edge="reference")
        us[b] = sim.fields(sim.run_chunk(sim.init_state(), 64))[1]
    err64 = rel_l2(us["cuda"], us["torch"])
    print(f"  quirk {name} f64, 64 steps: velocity rel-L2 cuda vs torch "
          f"{err64:.3e}", flush=True)
    rows.append(dict(grid=name, dtype="float64", steps=64,
                     velocity_rel_l2_cuda_vs_torch=err64))
    check(bool(torch.isfinite(us["cuda"]).all()) and err64 <= 1e-12,
          f"quirk {name} f64: cuda vs torch velocity rel-L2 {err64}")
    record["quirk_real_size"] = rows
    return runs["quirk_temporal_1"][0]


# --- phase 7: the validation models ---------------------------------------

GHIA_Y = (0.0625, 0.1016, 0.2813, 0.4531, 0.6172, 0.7344, 0.9531)
GHIA_UX = (-0.04192, -0.06434, -0.15662, -0.21090, -0.13641, 0.00332,
           0.68717)
GHIA_X = (0.0703, 0.2344, 0.5000, 0.8047, 0.9063, 0.9453)
GHIA_UY = (0.10091, 0.17527, 0.05454, -0.24533, -0.16914, -0.10313)


def phase_models(record):
    """The Poiseuille channel through B2h against its analytic profile
    (f64 raw and f32 deviatoric), a 2048^2 channel through B2h against the
    plain version (f64 raw and f32 deviatoric), and the cavity against
    Ghia."""
    import numpy as np
    import torch

    from cuda_iblb_11_tpu_torch.models import channel
    from cuda_iblb_11_tpu_torch.models.cavity import LidDrivenCavity
    from cuda_iblb_11_tpu_torch.models.channel import PoiseuilleChannel
    from cuda_iblb_11_tpu_torch.ops.collide_stream import (
        collide_stream_reference,
    )

    print("== phase 7: the validation models on the card", flush=True)
    rows = []
    for dtype, storage in ((torch.float64, "raw"),
                           (torch.float32, "deviatoric")):
        ch = PoiseuilleChannel(16, 32, tau=1.0, dtype=dtype, device=DEVICE,
                               storage=storage)
        reset_launches()
        t0 = time.perf_counter()
        f = ch.run(ch.init_f(), 8000)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        got = ch.profile(f).double().cpu().numpy()
        want = ch.analytic_profile()
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        rows.append(dict(model="channel 16x32", dtype=str(dtype),
                         storage=storage, steps=8000, rel_l2_analytic=err,
                         ms_per_step=1e3 * sec / 8000, launches=launches))
        print(f"  channel 16x32 {dtype} {storage}: rel-L2 vs analytic "
              f"{err:.3e}, {1e3 * sec / 8000:.4f} ms/step, {launches}",
              flush=True)
        check(err < 3e-3, f"channel {dtype}: {err} off the analytic profile")
        check(launches == {"B2h collide_stream": 8000},
              f"channel {dtype} launches {launches}")

    # 2048^2, band = ydim: B2h against the plain version in f64 raw, f at
    # 1e-12 after 512 steps (the gate that fails a wrong force row or wall
    # at band = ydim), and the same pair in f32 deviatoric, each against
    # B2h in f64.  The flow is the same in every column and grows steadily
    # from rest, so f32 round-off accumulates coherently over the steps
    # instead of averaging out (1.5e-5 to 2.2e-5 against f64 after 512
    # steps): in f32 B2h must be no further from the f64 run than the
    # plain version is, and within 1e-5 of it.
    n = REAL_SIZE_STEPS
    cells = 2048 * 2048
    runs, f64 = {}, {}
    for label, dtype, storage in (("B2h", torch.float32, "deviatoric"),
                                  ("plain", torch.float32, "deviatoric"),
                                  ("B2h f64", torch.float64, "raw"),
                                  ("plain f64", torch.float64, "raw")):
        ch = PoiseuilleChannel(2048, 2048, tau=1.0, body_force=1e-6,
                               dtype=dtype, device=DEVICE, storage=storage)
        f = ch.init_f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label.startswith("plain"):
            for _ in range(n):
                f = collide_stream_reference(f, ch.force, ch.tau, ch.tau2,
                                             ch.walls, channel.FORCING,
                                             ch.storage)
        else:
            f = ch.run(f, n)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs[label] = (ch.profile(f).double(), 1e3 * sec / n,
                       cells * n / sec / 1e6)
        if dtype == torch.float64:
            f64[label] = f
        del f, ch
    ref64 = runs["B2h f64"][0]
    err = {"B2h vs f64": rel_l2(runs["B2h"][0], ref64),
           "plain vs f64": rel_l2(runs["plain"][0], ref64),
           "B2h vs plain": rel_l2(runs["B2h"][0], runs["plain"][0]),
           "B2h f64 vs plain f64": rel_l2(ref64, runs["plain f64"][0])}
    f64_err = rel_l2(f64["B2h f64"], f64["plain f64"])
    rows.append(dict(model="channel 2048x2048", steps=n,
                     velocity_rel_l2=err, f_rel_l2_b2h_vs_plain_f64=f64_err,
                     ms_per_step={k: v[1] for k, v in runs.items()},
                     mlups={k: v[2] for k, v in runs.items()}))
    print(f"  channel 2048^2, {n} steps: f rel-L2 B2h f64 vs plain f64 "
          f"{f64_err:.3e}; velocity rel-L2 "
          + ", ".join(f"{k} {e:.3e}" for k, e in err.items()) + "; "
          + ", ".join(f"{k} {v[1]:.4f} ms/step ({v[2]:.0f} MLUPS)"
                      for k, v in runs.items()), flush=True)
    check(f64_err <= 1e-12, f"channel 2048^2 f64: B2h vs plain {f64_err}")
    check(err["B2h vs f64"] <= err["plain vs f64"]
          and err["B2h vs plain"] <= 1e-5, f"channel 2048^2: {err}")
    del runs, ref64, f64

    cav = LidDrivenCavity(64, 100.0, 0.1, device=DEVICE)
    t0 = time.perf_counter()
    f = cav.run(cav.init_f(), 30000)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ux, uy = (u.cpu().numpy() for u in cav.centreline_profiles(f))
    pos = (np.arange(cav.n) + 0.5) / cav.n
    dev = max(float(np.abs(np.interp(GHIA_Y, pos, ux) - GHIA_UX).max()),
              float(np.abs(np.interp(GHIA_X, pos, uy) - GHIA_UY).max()))
    rows.append(dict(model="cavity 64 Re 100", steps=30000,
                     max_dev_ghia=dev, ms_per_step=1e3 * sec / 30000))
    print(f"  cavity 64^2 Re 100, 30,000 steps (plain torch on the card): "
          f"max |dev| from Ghia {dev:.4f} lid units, "
          f"{1e3 * sec / 30000:.4f} ms/step", flush=True)
    check(dev <= 0.025, f"cavity: {dev} lid units off Ghia")
    record["models"] = rows


# --- phase 8: the card's ceilings ------------------------------------------

def phase_probes(record):
    """probe_bw (P2, P3) and probe_vpu (P1), each kernel against its plain
    version first; returns (launches, the kernels-line rows of P1-P3)."""
    import torch

    from cuda_iblb_11_tpu_torch import probe_bw, probe_vpu
    from cuda_iblb_11_tpu_torch.ops import probes

    print("== phase 8: the card's ceilings (P1-P3)", flush=True)
    # each kernel against its plain version (these launches do not count),
    # on seeded data that differs from element to element, into NaN
    xb = probe_bw.seeded_input(8)
    copy_err = probe_bw.check_against_plain(xb, torch.empty_like(xb))
    g = torch.Generator(device=DEVICE).manual_seed(8)
    x = 0.5 + torch.rand(probe_vpu.SHAPE, generator=g, device=DEVICE)
    chain_err, chain_abs = {}, {}
    for op in probes.CHAIN_OPS:
        got = probes.probe_chain(x, probe_vpu.R2, op)
        want = probes.probe_chain_reference(x, probe_vpu.R2, op)
        chain_err[op] = rel_l2(got, want)
        chain_abs[op] = float((got - want).abs().max())
    # the probes' own runs, counted
    reset_launches()
    bw = probe_bw.measure(reps=3, check=False)
    vpu = probe_vpu.measure(steps=REAL_SIZE_STEPS)
    launches = {k: v for k, v in read_launches().items() if k in PROBES}
    bw["max_abs_err_vs_plain"] = copy_err
    record["probe_bw"], record["probe_vpu"] = bw, vpu
    record["probe_chain_rel_l2_vs_plain"] = chain_err
    for name, e in copy_err.items():
        check(e == 0.0, f"{name}: not bit for bit with its plain version "
                        f"({e})")
    check(max(chain_abs.values()) == 0.0, f"P1 vs plain: {chain_err}")
    pat = bw["patterns"]
    for name in ("P2 copy threads=256 grid=vec",
                 "P3 ring copy tile=32KiB depth=2", "copy_ (library)",
                 bw["best_kernel_pattern"],
                 "B2 step kernel (implied at 72 B/cell)"):
        print(f"  {name}: {pat[name]['median_gbs']:.1f} GB/s median, "
              f"{pat[name]['share_of_peak']:.3f} of the data sheet's "
              f"3,350 GB/s", flush=True)
    for op, tf in vpu["tflops_by_op"].items():
        print(f"  P1 {op} chain: {tf:.2f} TFLOP/s, {tf / 67:.3f} of the "
              "data sheet's 67 TFLOP/s", flush=True)
    print(f"  P1 vs plain rel-L2: {chain_err}; chain SASS "
          f"{vpu['chain_sass']}", flush=True)
    print(f"  port 2048^2 auto: {vpu['port_2048']['mlups']:.0f} MLUPS, "
          f"{vpu['useful_share_of_measured_fma']:.3f} of the measured fma "
          f"rate", flush=True)

    # the kernels-line rows: each probe's time on its default shape
    nbytes = 2 * xb.numel() * 4
    ms = {k: nbytes / (pat[k]["median_gbs"] * 1e9) * 1e3
          for k in ("P2 copy threads=256 grid=vec",
                    "P3 ring copy tile=32KiB depth=2", "copy_ (library)")}
    p3, lib = ms["P3 ring copy tile=32KiB depth=2"], ms["copy_ (library)"]
    print(f"  P3 ring copy, 32 KiB tiles at depth 2: {p3:.4f} ms "
          f"({pat['P3 ring copy tile=32KiB depth=2']['median_gbs']:.1f} "
          f"GB/s); copy_ in the same run {lib:.4f} ms "
          f"({pat['copy_ (library)']['median_gbs']:.1f} GB/s); P3 / copy_ "
          f"time {p3 / lib:.4f}", flush=True)
    record["p3_over_copy_time"] = p3 / lib
    runs = {name: pat[name]["median_gbs"] for name in pat
            if name.startswith("P3 ring copy tile=32KiB")}
    print("  P3 at 32 KiB by run length (tiles a block streams; "
          f"{probes.RING_RUN} where unnamed), GB/s median: "
          + "; ".join(f"{k[13:]} {v:.1f}" for k, v in runs.items()),
          flush=True)
    record["p3_gbs_by_run"] = runs
    copy_plain = probes.device_ms(lambda: probes.probe_copy_reference(xb),
                                  20)
    ring_plain = probes.device_ms(
        lambda: probes.probe_ring_copy_reference(xb), 20)
    chain_plain = probes.device_ms(
        lambda: probes.probe_chain_reference(x, probe_vpu.R2, "fma"), 1)
    fma_ops = x.numel() * 2 * probe_vpu.R2
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    rows = {
        "P1 probe_chain": dict(
            ms=vpu["chain_times_ms"]["fma"]["ms_r2"], plain_ms=chain_plain,
            bound_ms=fma_ops / F32_FLOP_S * 1e3, bound_by="operations",
            library_ms=None, max_abs_err=chain_abs["fma"]),
        "P2 probe_copy": dict(
            ms=ms["P2 copy threads=256 grid=vec"], plain_ms=copy_plain,
            bound_ms=bytes_ms, bound_by="bytes",
            library_ms=ms["copy_ (library)"],
            max_abs_err=max(v for k, v in copy_err.items()
                            if k.startswith("P2"))),
        "P3 probe_ring_copy": dict(
            ms=ms["P3 ring copy tile=32KiB depth=2"], plain_ms=ring_plain,
            bound_ms=bytes_ms, bound_by="bytes",
            library_ms=ms["copy_ (library)"],
            max_abs_err=max(v for k, v in copy_err.items()
                            if k.startswith("P3"))),
    }
    record["probe_kernel_rows"] = rows
    return launches, rows


# --- phase 9: accuracy on the card ----------------------------------------

def chunk_launches(K, chunks):
    """The launches of run_chunk on the single-device sim over consecutive
    calls of `chunks` steps: each call runs pieces of at most 512 steps,
    the largest multiple of K of each as super-steps (with the per-sub-step
    leg: K B3 launches and one B4 each) and the rest one B2 a step."""
    n = dict.fromkeys(KERNELS, 0)
    for steps in chunks:
        while steps > 0:
            k = min(steps, 512)
            if K > 1 and k >= K:
                k -= k % K
                n["B3 sharded_fused_step"] += k
                n["B4 temporal_bulk"] += k // K
            else:
                n["B2 fused_step"] += k
            steps -= k
    return n


class _Counted:
    """A sim whose run_chunk counts the launches it makes: set to 0 just
    before each call, read just after, summed over its calls."""

    def __init__(self, sim):
        self.sim, self.launches = sim, dict.fromkeys(KERNELS, 0)

    def __getattr__(self, name):
        return getattr(self.sim, name)

    def run_chunk(self, state, n):
        reset_launches()
        state = self.sim.run_chunk(state, n)
        for name, v in read_launches().items():
            self.launches[name] += v
        return state


def _walk_counted(sims, horizons, label):
    """accuracy_horizon.walk over `sims` with each sim's launches counted:
    (velocity rel-L2 and flux rel by (pair, horizon), launches by sim)."""
    import torch

    from cuda_iblb_11_tpu_torch.accuracy_horizon import velocity, walk

    sims = {k: _Counted(s) for k, s in sims.items()}
    rows, states = walk(sims, horizons, label)
    for k, st in states.items():
        check(bool(torch.isfinite(velocity(sims[k], st)).all()),
              f"{label} {k}: non-finite")
    return ({(r["pair"], r["steps"]): r["rel_l2"] for r in rows},
            {k: s.launches for k, s in sims.items()})


def phase_accuracy(record):
    """192^2 f32 single-step and auto against f64 at 500 / 2,000 / 4,000
    steps, and 2048^2 auto against single-step after LONG_STEPS."""
    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.accuracy_horizon import leg_sims

    print("== phase 9: accuracy on the card", flush=True)
    rows = {}
    sims = leg_sims("192sq", DEVICE)
    rc = {k: s.resolved_config() for k, s in sims.items()}
    check((rc["f32_auto"]["temporal"], rc["f32_auto"]["band_leg"])
          == (K, "per_substep"), f"192^2 auto resolved {rc['f32_auto']}")
    horizons = tuple(ACCURACY_GATES)
    t0 = time.perf_counter()
    errs, launches = _walk_counted(sims, horizons, "phase 9, 192^2")
    chunks = [b - a for a, b in zip((0,) + horizons, horizons)]
    steps = horizons[-1]
    zero = dict.fromkeys(KERNELS, 0)
    want = {"f64_oracle": {**zero, "B2 fused_step": steps},
            "f32": {**zero, "B2 fused_step": steps},
            "f32_auto": chunk_launches(K, chunks)}
    for k in sims:
        check(launches[k] == want[k], f"192^2 {k} launches {launches[k]}, "
                                      f"expected {want[k]}")
    launched = {k: {n: v for n, v in c.items() if v}
                for k, c in launches.items()}
    print(f"  192^2 launches {launched} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for k in ("f32", "f32_auto"):
        e = {n: errs[(f"{k}_vs_f64_oracle", n)] for n in horizons}
        for n, gate in ACCURACY_GATES.items():
            check(e[n] < gate, f"192^2 {k} at {n} steps: velocity rel-L2 "
                               f"{e[n]} >= {gate}")
        check(e[steps] < ACCURACY_GROWTH * e[horizons[0]],
              f"192^2 {k}: error grew {e[steps] / e[horizons[0]]}x from "
              f"{horizons[0]} to {steps} steps")
    rows["192x192"] = dict(resolved=rc, launches=launches,
                           rel=[dict(pair=p, steps=n, rel=v)
                                for (p, n), v in errs.items()])
    del sims

    c, s, y = GRIDS[TIMING_GRID]
    cfg = SimConfig(c_num=c, c_space=s, ydim=y)
    sims = {"temporal 1": MucociliarySim(cfg, backend="cuda", device=DEVICE),
            "temporal auto": MucociliarySim(cfg, backend="cuda",
                                            device=DEVICE,
                                            temporal="auto")}
    errs, launches = _walk_counted(sims, (LONG_STEPS,),
                                   f"phase 9, {TIMING_GRID}")
    want = {"temporal 1": {**zero, "B2 fused_step": LONG_STEPS},
            "temporal auto": {**zero, "B4 temporal_bulk": LONG_STEPS // K,
                              "B5 band_super": LONG_STEPS // K}}
    for k in sims:
        check(launches[k] == want[k], f"{TIMING_GRID} {k} launches "
                                      f"{launches[k]}, expected {want[k]}")
    err = errs[("temporal auto_vs_temporal 1", LONG_STEPS)]
    check(err <= 1e-5, f"{TIMING_GRID}: auto vs single velocity rel-L2 {err} "
                       f"after {LONG_STEPS} steps")
    rows[TIMING_GRID] = dict(steps=LONG_STEPS, velocity_rel_l2=err,
                             launches=launches)
    record["accuracy"] = rows


# --- phase 10: the reference's experiments -------------------------------

def phase_experiments(record):
    """Two metachrony sweep points at 2048^2 in f32 and f64, and the
    reference channel's flux curve against the early f64 golden."""
    from cuda_iblb_11_tpu_torch import sweep_metachrony, validate_flux

    print("== phase 10: the reference's experiments on the card", flush=True)
    zero = dict.fromkeys(KERNELS, 0)
    rows, q = {}, {}
    want = {**zero, "B5 band_super": SWEEP_STEPS // K,
            "B4 temporal_bulk": SWEEP_STEPS // K}
    for dt in ("float32", "float64"):
        for cf in SWEEP_POINTS:
            name = f"sweep {dt} c_fraction {cf}"
            reset_launches()
            p = sweep_metachrony.run_point(cf, dt, DEVICE, "cuda",
                                           SWEEP_STEPS, SWEEP_CHUNKS)
            n = read_launches()
            check(n == want, f"{name}: launches {n}, expected {want}")
            check((p["sim"]["band_leg"], p["sim"]["temporal"])
                  == ("band_super_whole", K), f"{name}: {p['sim']}")
            check(p["finite"], f"{name}: non-finite f")
            q[(dt, cf)] = p["q_per_beat"]
            rows[name] = p
            print(f"  {name}: Q {p['q_per_beat']:.9g} after {SWEEP_STEPS} "
                  f"steps, {p['ms_per_step']:.4f} ms/step, "
                  f"{p['mlups']:.1f} MLUPS", flush=True)
    for cf in SWEEP_POINTS:
        rel = abs(q[("float32", cf)] - q[("float64", cf)]) / abs(
            q[("float64", cf)])
        check(rel <= SWEEP_GATE, f"sweep c_fraction {cf}: f32 vs f64 {rel}")
        rows[f"sweep c_fraction {cf} f32_vs_f64"] = rel
        print(f"  sweep c_fraction {cf}: f32 vs f64 {rel:.3e}", flush=True)
    a, b = (q[("float64", cf)] for cf in SWEEP_POINTS)
    check(abs(a - b) > SWEEP_GATE * abs(b),
          f"sweep: c_fraction {SWEEP_POINTS} give the same Q ({a}, {b})")
    for dt in ("float64", "float32"):
        name = f"flux curve {dt}"
        reset_launches()
        leg = validate_flux.run_leg(dt, FLUX_STEPS, FLUX_SAMPLES, DEVICE,
                                    "cuda")
        n = read_launches()
        check(n == {**zero, "B2 fused_step": FLUX_STEPS},
              f"{name}: launches {n}")
        check(leg["finite"], f"{name}: non-finite f")
        early = leg["early"]
        check([r["it"] for r in early["rows"]] == list(range(
            100, FLUX_STEPS + 1, 100)), f"{name}: samples {early['rows']}")
        check(early["max_rel"] <= FLUX_GATES[dt],
              f"{name}: {early['max_rel']} from {early['golden']}")
        rows[name] = leg
        print(f"  {name}: largest rel from {early['golden']} "
              f"{early['max_rel']:.3e} (gate {FLUX_GATES[dt]}), "
              f"{leg['ms_per_step']:.4f} ms/step", flush=True)
    record["experiments"] = rows


# --- phase 11: bf16 storage on the card ------------------------------------

# The bf16 entries (f in bf16, everything else f32), each named after its
# f32 kernel in KERNELS (source and TPU kernel are the same).
BF16_KERNELS = ("B2 fused_step", "B2h collide_stream",
                "B3 sharded_fused_step", "B4 temporal_bulk",
                "B5 band_super", "B6 band_super_tiled")
BF16_SHARE = 0.999   # of f bit-equal (ops/precision.bf16_agreement)
# floored ulps (ops/precision.bf16_agreement) where f rounds once a call:
# one between two runs of the same arithmetic; B7's and B8's 16 contracted
# sub-steps part from their eager plain versions' by up to about 5e-7 of a
# plane's scale, two bf16 ulps at the 2^-14 floor (their f equals the f32
# entry's rounded, bit for bit, which pins the rounding point)
ULPS_GATE = 1.0
ULPS_GATE_KSTEP = 2.0
BF16_CLI_Q_GATE = 2e-2   # the JAX package's bf16 flux bound
#                          (tests/test_simulation.py:125-140)
BF16_LONG_STEPS = 24_576   # 2048^2 auto: JAX's bench horizon
BF16_LONG_GATES = {"velocity": 1e-2, "q": 1e-2}


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


def bf16_sims(gname, **kw):
    """The model at grid gname on the cuda backend in bf16 and on the torch
    backend in bf16 and in f32, by (backend, dtype)."""
    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig

    c, sp, y = GRIDS[gname]
    return {(b, dt): MucociliarySim(
        SimConfig(c_num=c, c_space=sp, ydim=y, dtype=dt), backend=b,
        device=DEVICE, **kw)
        for b, dt in (("cuda", "bfloat16"), ("torch", "bfloat16"),
                      ("torch", "float32"))}


def bf16_backends_apart(sims, st, steps, label):
    """From state st, `steps` steps on each of bf16_sims' models (the f32
    one from st widened): {"f" | "velocity": (rel-L2 of cuda against
    torch in bf16, of torch in bf16 against f32)}; the first must be less
    than half the second, since the two bf16 backends round at the same
    points."""
    import torch

    out = {key: s_.run_chunk(st._replace(f=st.f.float()) if key[1] ==
                             "float32" else st, steps)
           for key, s_ in sims.items()}
    f = {key: o.f for key, o in out.items()}
    u = {key: sims[key].fields(o)[1] for key, o in out.items()}
    check(bool(torch.isfinite(u["cuda", "bfloat16"]).all()),
          f"{label}: non-finite")
    d = {name: (rel_l2(x["cuda", "bfloat16"], x["torch", "bfloat16"]),
                rel_l2(x["torch", "bfloat16"], x["torch", "float32"]))
         for name, x in (("f", f), ("velocity", u))}
    print(f"  {label}: cuda vs torch " + ", ".join(
        f"{k} {a:.3e} (bf16 vs f32 {b:.3e}, ratio {a / b:.3f})"
        for k, (a, b) in d.items()), flush=True)
    check(all(a < 0.5 * b for a, b in d.values()),
          f"{label}: cuda vs torch against bf16 vs f32 {d}")
    return d


def phase_bf16(record):
    """bf16 storage on the card: each bf16 entry against its plain version
    at its main path's shapes (B2, B2h, B3, B4 at 288 x 192 and 2048^2, B5
    at 2048^2, B6 at 8192^2 on the plan held to the card's L2 size), timed
    in turns with its f32 kernel at 2048^2 (B6 at 8192^2); then the main paths in bf16: the CLI at --temporal 1 and auto
    (the f32 runs' launch counts, Q within 2% of phase 3's), 2048^2 auto
    over 24,576 steps against f32 (velocity and Q within 1e-2, the rates in
    turns), 8192^2 on the x-tiled leg against the whole leg (bit for bit),
    and the 2048^2 quirk, cuda against the torch backend.  Returns (each
    bf16 kernel's timing row, its launches on its path)."""
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_temporal

    print("== phase 11: bf16 storage on the card", flush=True)
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    walls = ref.WallSpec(top="slip")
    st = "deviatoric"
    results, worst, timings = [], {}, {}
    g = {"*": GATE["float32"]}
    gi = {"force": GATE_IB["float32"], "flux": GATE_IB["float32"], "*": g["*"]}

    # the kernels at the shapes of their bf16 paths, each beside the f32
    # entry on the same values: at 288 x 192 the CLI's (B2 on the whole
    # grid, B2h at the quirk step's band, B3 on the per-sub-step leg's band
    # block, flags [0, 1, 0] without halos as the model calls it and with
    # a neighbour halo, B4 on the bulk at K = 16); at 2048^2 (auto: the
    # whole band super-step) the same and B5, timed there
    for gname, leg in (("288x192", "per_substep"),
                       (TIMING_GRID, "band_super_whole")):
        c, sp, y = GRIDS[gname]
        cfg = SimConfig(c_num=c, c_space=sp, ydim=y, dtype="bfloat16")
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
    big_name, (c, sp, y), _ = BIG_GRID
    l2 = l2_bytes(dev)
    cfg = SimConfig(c_num=c, c_space=sp, ydim=y, dtype="bfloat16")
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
    record["bf16_kernel_vs_plain"] = results
    record["bf16_kernel_timing"] = timings

    # the CLI in bf16 (each launch count equal to its f32 run's, phase 3)
    launches = {}
    zero = dict.fromkeys(KERNELS, 0)
    for label, temporal in (("cli_temporal_1", "1"),
                            ("cli_temporal_auto", "auto")):
        _, n, log, q = run_cli(f"{label}_bf16", ["--dtype", "bfloat16",
                                                 "--temporal", temporal],
                               None, record)
        check(n == record[label]["launches"],
              f"bf16 {label} launches {n}, f32 {record[label]['launches']}")
        check("Dtype: bfloat16" in log and "Storage: deviatoric" in log,
              f"bf16 {label}: SimLog does not record bf16 storage")
        q32 = {r["it"]: r["q"] for r in record[label]["flux"]}
        rel = {it: abs(q[it] - q32[it]) / abs(q32[it]) for it in FLUX_ITS}
        record[f"{label}_bf16_vs_f32"] = rel
        print(f"    bf16 vs f32 flux rel: {rel}", flush=True)
        check(rel[FLUX_ITS[-1]] <= BF16_CLI_Q_GATE,
              f"bf16 {label}: final Q {rel[FLUX_ITS[-1]]} from f32")
        launches[label] = {k: v for k, v in n.items() if v}
    check(launches["cli_temporal_1"] == {"B2 fused_step": 2000}
          and launches["cli_temporal_auto"] == {
              "B2 fused_step": 16, "B3 sharded_fused_step": 1984,
              "B4 temporal_bulk": 124},
          f"bf16 CLI launches {launches}")

    # the CLI's per-sub-step leg at 288 x 192 (B3 + the torch IB + B4) in
    # both IB modes: from a state the torch backend reached in 2 K + 3
    # steps, one call of K sub-steps on each backend
    rows = []
    for ib in ("periodic", "reference"):
        sims = bf16_sims("288x192", temporal=K, ib_x_edge=ib)
        check(sims["cuda", "bfloat16"].resolved_config()["band_leg"]
              == "per_substep", f"288x192 bf16 {ib}: not the per-sub-step "
                                "leg")
        t16 = sims["torch", "bfloat16"]
        st0 = t16.run_chunk(t16.init_state(), 2 * K + 3)
        reset_launches()
        d = bf16_backends_apart(
            sims, st0, K, f"288x192 per-sub-step leg bf16, ib {ib}, one "
                          f"call of {K} from a common state")
        n = read_launches()
        check(n == {**zero, "B3 sharded_fused_step": K,
                    "B4 temporal_bulk": 1},
              f"288x192 bf16 {ib} per-sub-step call launches {n}")
        rows.append(dict(grid="288x192", ib_x_edge=ib, steps=K,
                         per_substep_cuda_vs_torch_bf16=d))
        del sims, t16, st0

    # 2048^2 auto (B5 + B4) over 24,576 steps, bf16 against f32, in turns
    # (f32, bf16, bf16, f32)
    c, sp, y = GRIDS[TIMING_GRID]
    sims, us, qs = {}, {}, {}
    n_long = BF16_LONG_STEPS
    for dt in ("float32", "bfloat16"):
        cfg = SimConfig(c_num=c, c_space=sp, ydim=y, dtype=dt)
        sims[dt] = MucociliarySim(cfg, backend="cuda", device=DEVICE,
                                  temporal="auto")
        sims[dt].run_chunk(sims[dt].init_state(), K)   # warm-up
    want = {**zero, "B5 band_super": n_long // K,
            "B4 temporal_bulk": n_long // K}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        sim = sims[dt]
        reset_launches()
        st_, sec = _timed_run(sim, n_long)
        n = read_launches()
        check(n == want, f"{TIMING_GRID} auto {dt} launches {n}")
        if dt not in us:
            us[dt], qs[dt] = sim.fields(st_)[1], float(st_.q)
            check(bool(torch.isfinite(us[dt]).all()),
                  f"{TIMING_GRID} auto {dt}: non-finite")
        if dt == "bfloat16":
            launches[f"{TIMING_GRID} auto bf16"] = n
        _report(rows, TIMING_GRID, f"auto {dt}", sim.cfg, st_, sec, n_long,
                band_leg=sim.resolved_config()["band_leg"])
        del st_
    del sims
    err_u = rel_l2(us["bfloat16"], us["float32"])
    err_q = abs(qs["bfloat16"] - qs["float32"]) / abs(qs["float32"])
    print(f"  {TIMING_GRID} auto after {n_long} steps, bf16 against f32: "
          f"velocity rel-L2 {err_u:.3e}, Q rel {err_q:.3e}", flush=True)
    rows.append(dict(grid=TIMING_GRID, steps=n_long,
                     velocity_rel_l2_bf16_vs_f32=err_u,
                     q_rel_bf16_vs_f32=err_q))
    check(err_u < BF16_LONG_GATES["velocity"]
          and err_q < BF16_LONG_GATES["q"],
          f"{TIMING_GRID} bf16 vs f32: velocity {err_u}, Q {err_q}")
    del us

    # 8192^2, 32 steps: the x-tiled leg (the budgeted plan, B6) against
    # the whole leg (B5), bit for bit as in f32
    c, sp, y = BIG_GRID[1]
    cfg = SimConfig(c_num=c, c_space=sp, ydim=y, dtype="bfloat16")
    res = {}
    for label in ("whole", "x-tiled"):
        sim = MucociliarySim(cfg, backend="cuda", device=DEVICE,
                             temporal="auto")
        if label == "x-tiled":
            sim.plan = plan_temporal(cfg, K, walls, torch.bfloat16,
                                     budget=l2)
        reset_launches()
        st_ = sim.run_chunk(sim.init_state(), 2 * K)
        torch.cuda.synchronize()
        res[label] = (st_.f, read_launches())
        del sim, st_
    n6 = res["x-tiled"][1]
    check(n6 == {**zero, "B4 temporal_bulk": 2, "B6 band_super_tiled":
                 2 * cfg.xdim // xt.tile_x},
          f"{big_name} bf16 x-tiled launches {n6}")
    same = torch.equal(res["whole"][0], res["x-tiled"][0])
    print(f"  {big_name} bf16, {2 * K} steps: x-tiled leg (B6, "
          f"{n6['B6 band_super_tiled']} tile launches) = whole leg (B5) bit "
          f"for bit: {same}", flush=True)
    check(same, f"{big_name} bf16: the x-tiled leg is not the whole leg")
    launches[f"{big_name} x-tiled bf16"] = n6
    rows.append(dict(grid=big_name, steps=2 * K,
                     xtiled_equals_whole_bit_for_bit=same))
    del res
    torch.cuda.empty_cache()

    # the quirk at 2048^2: 512 steps on the cuda backend in bf16, then from
    # that state one step on the cuda backend, on the torch backend, and on
    # the torch backend in f32 (the state widened): the two bf16 backends
    # round at the same points, so they lie less than half as far apart as
    # bf16 lies from f32
    sims = bf16_sims(TIMING_GRID, temporal=1, ib_x_edge="reference")
    sim = sims["cuda", "bfloat16"]
    sim.run_chunk(sim.init_state(), 4)
    reset_launches()
    st_, sec = _timed_run(sim, REAL_SIZE_STEPS)
    n = {k: v for k, v in read_launches().items() if v}
    check(n == {"B2h collide_stream": REAL_SIZE_STEPS},
          f"quirk bf16 launches {n}")
    launches["quirk bf16"] = n
    _report(rows, TIMING_GRID, "quirk cuda bfloat16", sim.cfg, st_, sec,
            REAL_SIZE_STEPS, launches=n)
    d = bf16_backends_apart(sims, st_, 1, f"quirk {TIMING_GRID} bf16, one "
                            f"step from the cuda run's state after "
                            f"{REAL_SIZE_STEPS}")
    rows.append(dict(grid=TIMING_GRID, quirk_one_step_cuda_vs_torch_bf16=d))
    del sims, sim, st_
    record["bf16_runs"] = rows
    record["bf16_launches"] = launches
    record["bf16_phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 11: {record['bf16_phase_s']:.1f} s", flush=True)
    path = {"B2 fused_step": launches["cli_temporal_1"]["B2 fused_step"],
            "B2h collide_stream": launches["quirk bf16"][
                "B2h collide_stream"],
            "B3 sharded_fused_step": launches["cli_temporal_auto"][
                "B3 sharded_fused_step"],
            "B4 temporal_bulk": launches["cli_temporal_auto"][
                "B4 temporal_bulk"],
            "B5 band_super": launches[f"{TIMING_GRID} auto bf16"][
                "B5 band_super"],
            "B6 band_super_tiled": n6["B6 band_super_tiled"]}
    return timings, path


# --- phase 12: the rest of the mesh on the card ----------------------------

# The mesh kernels' bf16 entries, named after their f32 kernels in KERNELS.
BF16_MESH_KERNELS = ("B0 collide_slabs", "B7 ghost_temporal",
                     "B8 band_super_xsharded")
# (grid, mesh, temporal, steps, band leg, launches per exchange), as
# MESH_RUNS: the quirk mesh at 2048^2 against the single-device quirk, and
# the bf16 meshes against the single-device bf16 run
QUIRK_MESH_RUNS = (
    ("2048x2048", (2, 2), 1, 64, "sharded_per_step",
     {"B3 sharded_fused_step": 4, "B0 collide_slabs": 1}),
    ("2048x2048", (2, 2), "auto", 64, "per_substep_tiled",
     {"B3 sharded_fused_step": 2 * K, "B0 collide_slabs": K,
      "B7 ghost_temporal": 4}),
)
BF16_MESH_RUNS = (
    ("2048x2048", (2, 2), "auto", 64, "band_super_xsharded",
     {"B8 band_super_xsharded": 2, "B7 ghost_temporal": 4}),
    ("2048x2048", (2, 1), "auto", 64, "band_super_whole",
     {"B5 band_super": 1, "B7 ghost_temporal": 2}),
    ("2048x2048", (2, 2), 1, 64, "sharded_per_step",
     {"B3 sharded_fused_step": 4, "B0 collide_slabs": 1}),
    ("8192x8192", (2, 2), "auto", 32, "band_super_xsharded",
     {"B8 band_super_xsharded": 2, "B7 ghost_temporal": 4}),
)
MESH_GATE, MESH_GATE_F64 = 1e-5, 1e-12


def _grid_cfg(name, **kw):
    from cuda_iblb_11_tpu_torch import SimConfig

    c, sp, y = {**GRIDS, BIG_GRID[0]: BIG_GRID[1]}[name]
    return SimConfig(c_num=c, c_space=sp, ydim=y, **kw)


def _mesh_and_single(cfg, mesh, temporal, ib_x_edge):
    """The runner's mesh sim for `mesh` and the single-device model at the
    same temporal, both on the cuda backend."""
    import torch

    from cuda_iblb_11_tpu_torch import MucociliarySim
    from cuda_iblb_11_tpu_torch.runner import _make_mesh_sim

    msim = _make_mesh_sim(cfg, "auto", "trt_split", temporal,
                          f"{mesh[0]},{mesh[1]}", ib_x_edge, "no_mucus",
                          torch.device(DEVICE))
    single = MucociliarySim(cfg, backend="cuda", device=DEVICE,
                            temporal=temporal, ib_x_edge=ib_x_edge)
    return msim, single


def _want(per_exchange, n, k_run):
    return {**dict.fromkeys(KERNELS, 0),
            **{k: v * (n // k_run) for k, v in per_exchange.items()}}


def quirk_mesh(record):
    """Phase 12 (a): the quirk CLI on (2, 1) at --temporal 1 and auto
    against phase 6's unsharded runs, then 2048^2 on (2, 2) against the
    single-device quirk (f32, and f64 at temporal 1).  Returns the
    launches of the 2048^2 runs."""
    import torch

    cfg, n1, log1, q1 = run_cli("quirk_mesh_temporal_1",
                                QUIRK + ["--mesh", "2,1", "--temporal", "1"],
                                None, record)
    _, na, loga, qa = run_cli("quirk_mesh_auto", QUIRK + ["--mesh", "2,1"],
                              None, record)
    steps, interval = cfg.iterations, cfg.interval
    n_super = min(interval, 512) // K
    rest = (interval - n_super * K) * (steps // interval)
    n_super *= steps // interval
    zero = dict.fromkeys(KERNELS, 0)
    want1 = {**zero, "B3 sharded_fused_step": 2 * steps,
             "B0 collide_slabs": steps}
    wanta = {**zero, "B3 sharded_fused_step": n_super * K + 2 * rest,
             "B7 ghost_temporal": 2 * n_super, "B0 collide_slabs": rest}
    check(n1 == want1, f"quirk --mesh 2,1 --temporal 1 launches {n1}, "
                       f"expected {want1}")
    check(na == wanta, f"quirk --mesh 2,1 auto launches {na}, expected "
                       f"{wanta}")
    for log, leg in ((log1, "sharded_per_step"),
                     (loga, "per_substep_tiled")):
        check("IB path: stencil_quirk" in log and f"Kernel path: {leg}" in log
              and "Mesh: 2,1 over 1 device(s)" in log,
              f"quirk mesh SimLog does not name stencil_quirk and {leg}")
    check("Temporal K: 16 (auto: K=16" in loga, "quirk mesh auto: K")
    rel = {}
    for label, q, single in (("temporal_1", q1, "quirk_temporal_1"),
                             ("auto", qa, "quirk_auto")):
        q0 = {r["it"]: r["q"] for r in record[single]["flux"]}
        rel[label] = {it: abs(q[it] - q0[it]) / abs(q0[it])
                      for it in FLUX_ITS}
    record["quirk_mesh_cli_vs_unsharded"] = rel
    print(f"  quirk --mesh 2,1 vs unsharded quirk flux rel: {rel}",
          flush=True)
    for label, r in rel.items():
        check(max(r.values()) <= MESH_GATE, f"quirk mesh {label}: {r}")

    rows, launched = [], {}
    for name, mesh, temporal, n, leg, per_exchange in QUIRK_MESH_RUNS:
        cfg = _grid_cfg(name)
        label = f"quirk {name} mesh {mesh[0]},{mesh[1]} temporal {temporal}"
        msim, single = _mesh_and_single(cfg, mesh, temporal, "reference")
        rc = msim.resolved_config()
        k_run = K if temporal == "auto" else temporal
        check(rc["band_leg"] == leg and rc["temporal"] == k_run
              and rc["ib_path"] == "stencil_quirk" and rc["backend"] ==
              "cuda", f"{label} resolved {rc}")
        us = {}
        for run_label, sim in (("mesh", msim), ("single", single)):
            sim.run_chunk(sim.init_state(), K)            # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            st, sec = _timed_run(sim, n)
            launches = read_launches()
            us[run_label] = (sim.fields(st)[1], float(st.q))
            check(bool(torch.isfinite(us[run_label][0]).all()),
                  f"{label} {run_label}: non-finite")
            _report(rows, name, f"quirk {run_label} temporal {temporal}",
                    cfg, st, sec, n, band_leg=sim.resolved_config()[
                        "band_leg"], launches={k: v for k, v in
                                               launches.items() if v},
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if run_label == "mesh":
                want = _want(per_exchange, n, k_run)
                check(launches == want, f"{label} launches {launches}, "
                                        f"expected {want}")
                launched[label] = launches
            del st
        err = rel_l2(us["mesh"][0], us["single"][0])
        qrel = abs(us["mesh"][1] - us["single"][1]) / abs(us["single"][1])
        print(f"  {label} vs single-device quirk after {n} steps: velocity "
              f"rel-L2 {err:.3e}, flux rel {qrel:.3e}", flush=True)
        rows.append(dict(grid=name, mesh=list(mesh), temporal=temporal,
                         band_leg=leg, velocity_rel_l2_mesh_vs_single=err,
                         flux_rel_mesh_vs_single=qrel))
        check(err <= MESH_GATE and qrel <= MESH_GATE,
              f"{label}: mesh vs single velocity {err}, flux {qrel}")
        del msim, single, us
    # the f64 witness at temporal 1, 16 steps
    cfg = _grid_cfg("2048x2048", dtype="float64")
    msim, single = _mesh_and_single(cfg, (2, 2), 1, "reference")
    u = {k: s_.fields(s_.run_chunk(s_.init_state(), 16))[1]
         for k, s_ in (("mesh", msim), ("single", single))}
    err64 = rel_l2(u["mesh"], u["single"])
    print(f"  quirk 2048x2048 f64 mesh 2,2 temporal 1, 16 steps: velocity "
          f"rel-L2 against the single device {err64:.3e}", flush=True)
    rows.append(dict(grid="2048x2048", dtype="float64", mesh=[2, 2],
                     temporal=1, steps=16,
                     velocity_rel_l2_mesh_vs_single=err64))
    check(bool(torch.isfinite(u["mesh"]).all()) and err64 <= MESH_GATE_F64,
          f"quirk 2048x2048 f64 mesh: {err64}")
    del msim, single, u
    torch.cuda.empty_cache()
    record["quirk_mesh"] = rows
    return launched


def bf16_mesh_kernels(record):
    """Phase 12 (b): B0's bf16 entry on phase 2's three tables, B7 and B8
    in bf16 on phase 2's mesh cases, each against its plain version and
    bit for bit against its f32 entry on the same values widened (B0's f1
    is f32 in both), and timed in turns with it at 2048^2.  Returns
    (timing rows, worst |err|)."""
    import torch

    from cuda_iblb_11_tpu_torch.ops import reference as ref
    from cuda_iblb_11_tpu_torch.ops.collide_rows import collide_slabs
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded

    dev = torch.device(DEVICE)
    walls = ref.WallSpec(top="slip")
    st = "deviatoric"
    results, worst, timed = [], {}, {}
    g = {"*": GATE["float32"]}
    gi = {"force": GATE_IB["float32"], "flux": GATE_IB["float32"],
          "*": g["*"]}
    big = BIG_GRID[0]
    for gname, tables in (("288x192", [((2, 1), None)]),
                          (TIMING_GRID, [(MESH, None)]),
                          (big, [("seam", None)])):
        cfg = _grid_cfg(gname, dtype="bfloat16")
        f16, force = bf16_inputs(cfg, dev, seed=0)
        f32 = f16.float()
        for mesh, rows in tables:
            if mesh == "seam":   # the budgeted plan's per-sub-step leg
                sp = plan_sharded(cfg, K, *MESH, walls, torch.bfloat16,
                                  budget=l2_bytes(dev))
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
                  f"B0 bf16 {gname}: {collide_slabs.launches - n0} "
                  "launches for the table and its twin, expected 2")
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
            timings = {kname: time_bf16(kname, kc, twin,
                                        f"{gname} bf16 deviatoric",
                                        50 if kname.startswith("B0") else 10,
                                        2, worst)
                       for kname, (kc, twin) in timed.items()}
            timed.clear()
        del f16, f32, force
        torch.cuda.empty_cache()
    record["bf16_mesh_kernel_vs_plain"] = results
    record["bf16_mesh_kernel_timing"] = timings
    return timings


def bf16_mesh_runs(record):
    """Phase 12 (c): each BF16_MESH_RUNS run in bf16 against the
    single-device bf16 run at the same temporal: one call from a common
    state (the single-device run's end) at least BF16_SHARE of f
    bit-equal, every element within one floored ulp; after the run, the
    velocity distance under half the single-device bf16 run's from f32;
    exact launches; ms/step in turns with the f32 mesh (at temporal 1,
    whose IB reads the stored f where the single-device step reads B2's
    f32 planes, the velocity within twice that distance).  Then the quirk
    CLI on (2, 1) in bf16 against the unsharded bf16 and f32 quirk CLI.
    Returns each run's launches."""
    import torch

    from cuda_iblb_11_tpu_torch.ops.precision import bf16_agreement

    rows, launched = [], {}
    for name, mesh, temporal, n, leg, per_exchange in BF16_MESH_RUNS:
        label = f"bf16 {name} mesh {mesh[0]},{mesh[1]} temporal {temporal}"
        k_run = K if temporal == "auto" else temporal
        sims = {dt: _mesh_and_single(_grid_cfg(name, dtype=dt), mesh,
                                     temporal, "periodic")
                for dt in ("float32", "bfloat16")}
        rc = sims["bfloat16"][0].resolved_config()
        check(rc["band_leg"] == leg and rc["temporal"] == k_run
              and rc["dtype"] == "bfloat16" and rc["backend"] == "cuda",
              f"{label} resolved {rc}")
        for dt in sims:
            for sim in sims[dt]:
                sim.run_chunk(sim.init_state(), K)        # warm-up
        out = {}
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            msim = sims[dt][0]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            st, sec = _timed_run(msim, n)
            launches = read_launches()
            want = _want(per_exchange, n, k_run)
            check(launches == want, f"{label} {dt} launches {launches}, "
                                    f"expected {want}")
            _report(rows, name, f"mesh {mesh[0]},{mesh[1]} {dt}", msim.cfg,
                    st, sec, n, temporal=temporal, band_leg=leg,
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if dt == "bfloat16" and dt not in out:
                out[dt] = msim.fields(st)[1]
                launched[label] = launches
            del st
        single = {}
        for dt in ("bfloat16", "float32"):
            sim = sims[dt][1]
            st, sec = _timed_run(sim, n)
            single[dt] = (st, sim.fields(st)[1])
            _report(rows, name, f"single {dt}", sim.cfg, st, sec, n,
                    temporal=temporal,
                    band_leg=sim.resolved_config()["band_leg"])
        u16, u32 = single["bfloat16"][1], single["float32"][1]
        d_mesh, d_f32 = rel_l2(out["bfloat16"], u16), rel_l2(u16, u32)
        # one call from the single-device bf16 run's end
        st0 = single["bfloat16"][0]
        msim, ssim = sims["bfloat16"]
        a = msim.gather_state(msim.run_chunk(msim.place_state(st0), k_run))
        b = ssim.run_chunk(st0, k_run)
        share, ulps, floored = bf16_agreement(a.f, b.f)
        # the per-step mesh reads the IB moments from the stored bf16 f (JAX
        # sharded.py:642-644) where the single-device step reads B2's f32
        # planes: one call leaves f bit-equal, but the IB feedback carries
        # the moments' rounding on to bf16's own distance within the run,
        # as it does between any two bf16 runs of this leg (the same mesh
        # on the torch backend: 2.610e-3 against 2.634e-3 from its f32);
        # there the gate only bounds the run within twice that distance
        bound = 0.5 if temporal != 1 else 2.0
        print(f"  {label}: one call from a common state f {share:.6%} "
              f"bit-equal, {ulps:.0f} ulps ({floored:.0f} floored); after "
              f"{n} steps velocity from the single-device bf16 run "
              f"{d_mesh:.3e} (single bf16 from f32 {d_f32:.3e}; bound "
              f"{bound} of it)", flush=True)
        rows.append(dict(grid=name, mesh=list(mesh), temporal=temporal,
                         band_leg=leg, one_call_bit_equal=share,
                         one_call_ulps=ulps, one_call_ulps_floored=floored,
                         velocity_mesh_vs_single_bf16=d_mesh,
                         velocity_single_bf16_vs_f32=d_f32,
                         velocity_bound_share=bound))
        check(share >= BF16_SHARE and floored <= ULPS_GATE,
              f"{label}: one call {share} bit-equal, {floored} ulps")
        check(bool(torch.isfinite(out["bfloat16"]).all())
              and d_mesh <= bound * d_f32,
              f"{label}: velocity {d_mesh} from single bf16 against "
              f"bf16 from f32 {d_f32}")
        del sims, out, single, st0, msim, ssim, a, b, u16, u32
        torch.cuda.empty_cache()
    record["bf16_mesh_runs"] = rows

    # the quirk CLI in bf16 on (2, 1) and unsharded: the mesh's final Q
    # nearer the unsharded bf16 run's than phase 6's f32 run's is
    _, nm, logm, qm = run_cli("quirk_mesh_bf16", QUIRK + [
        "--mesh", "2,1", "--dtype", "bfloat16"], None, record)
    _, _, _, qs = run_cli("quirk_bf16", QUIRK + ["--dtype", "bfloat16"],
                          None, record)
    check(nm == record["quirk_mesh_auto"]["launches"],
          f"quirk mesh bf16 CLI launches {nm}, f32 "
          f"{record['quirk_mesh_auto']['launches']}")
    check("Dtype: bfloat16" in logm and "IB path: stencil_quirk" in logm
          and "Mesh: 2,1 over 1 device(s)" in logm,
          "quirk mesh bf16 SimLog")
    q32 = {r["it"]: r["q"] for r in record["quirk_auto"]["flux"]}
    dist = {it: (abs(qm[it] - qs[it]) / abs(qs[it]),
                 abs(q32[it] - qs[it]) / abs(qs[it])) for it in FLUX_ITS}
    record["quirk_mesh_bf16_cli_q"] = dist
    print(f"  quirk bf16 CLI, Q of --mesh 2,1 and of f32 from the unsharded "
          f"bf16 run (rel): {dist}", flush=True)
    # the final Q: on the way the f32 curve may cross the bf16 one
    m, f = dist[FLUX_ITS[-1]]
    check(m < f, f"quirk mesh bf16 CLI Q: {dist}")
    launched["quirk_mesh_bf16_cli"] = nm
    return launched


def phase_mesh_rest(record):
    """Phase 12: the quirk IB and bf16 storage on a mesh (every shard on
    the one card).  Returns (the bf16 mesh kernels' timing rows, their
    launches on their bf16 paths)."""
    from cuda_iblb_11_tpu_torch.ops.probes import card_line

    print("== phase 12: the rest of the mesh on the card (the quirk IB, "
          "bf16 storage)", flush=True)
    print(f"  {card_line()}", flush=True)
    t_phase = time.perf_counter()
    quirk_mesh(record)
    timings = bf16_mesh_kernels(record)
    runs = bf16_mesh_runs(record)
    record["mesh_rest_phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 12: {record['mesh_rest_phase_s']:.1f} s", flush=True)
    m22 = runs["bf16 2048x2048 mesh 2,2 temporal auto"]
    path = {"B0 collide_slabs": runs["bf16 2048x2048 mesh 2,2 temporal 1"][
                "B0 collide_slabs"],
            "B7 ghost_temporal": m22["B7 ghost_temporal"],
            "B8 band_super_xsharded": m22["B8 band_super_xsharded"]}
    return timings, path


def main():
    ap = argparse.ArgumentParser(
        description="smoke run of the port on one GPU")
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
    n_single, n_auto, q_auto = phase_main_path(record)
    n_super, n_xtiled = phase_real_size(record)
    n_mesh = phase_mesh(record, q_auto)
    n_quirk = phase_quirk(record)
    phase_models(record)
    n_probes, probe_rows = phase_probes(record)
    timings.update(probe_rows)
    phase_accuracy(record)
    phase_experiments(record)
    bf16_timings, bf16_launches = phase_bf16(record)
    mesh16_timings, mesh16_launches = phase_mesh_rest(record)
    bf16_timings.update(mesh16_timings)
    bf16_launches.update(mesh16_launches)
    # each kernel's launches on the path that runs it: B2 on the
    # single-step CLI, B3 and B4 on the default (auto) CLI, B5 on the
    # 2048^2 temporal run, B6 on the 8192^2 x-tiled leg (a budgeted plan),
    # B7 and B8 on the 2048^2 (2, 2) mesh, B0 on the 2048^2 (2, 2) mesh at
    # temporal 1, B2h on the quirk CLI with --temporal 1, P1-P3 on the
    # probes' own runs
    m22 = n_mesh["2048x2048 mesh 2,2"]
    launches = {"B2 fused_step": n_single["B2 fused_step"],
                "B3 sharded_fused_step": n_auto["B3 sharded_fused_step"],
                "B4 temporal_bulk": n_auto["B4 temporal_bulk"],
                "B5 band_super": n_super["B5 band_super"],
                "B6 band_super_tiled": n_xtiled["B6 band_super_tiled"],
                "B0 collide_slabs": n_mesh[
                    "2048x2048 mesh 2,2 temporal 1"]["B0 collide_slabs"],
                "B7 ghost_temporal": m22["B7 ghost_temporal"],
                "B8 band_super_xsharded": m22["B8 band_super_xsharded"],
                "B2h collide_stream": n_quirk["B2h collide_stream"],
                **n_probes}
    launches.update({f"{k} bf16": n for k, n in bf16_launches.items()})
    timings.update({f"{k} bf16": row for k, row in bf16_timings.items()})
    for kname, n in launches.items():
        check(n > 0, f"{kname} was not launched on its path")

    kernels = {"kernels": [dict(
        name=kname, route="cuda", source=src, replaces=rep,
        launches=launches[kname],
        max_abs_err=timings[kname]["max_abs_err"],
        ms=timings[kname]["ms"], plain_ms=timings[kname]["plain_ms"],
        bound_ms=timings[kname]["bound_ms"],
        bound_by=timings[kname]["bound_by"],
        library_ms=timings[kname].get("library_ms"))
        for kname, (src, rep) in list(KERNELS.items()) + [
            (f"{k} bf16", KERNELS[k])
            for k in BF16_KERNELS + BF16_MESH_KERNELS]]}
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
