"""Tests that need the card, the one suite that holds the port's paths on
it: the hand kernels of csrc/ (B2, B3 and B2h fused_step.cu, B4 and B7
ghost_temporal.cu, B5, B6 and B8 band_super.cu, B0 collide_rows.cu, P1-P3
probes.cu) against their plain versions on the same inputs on the GPU, B7
with B4's flags against B4 bit for bit, B4 against K launches of B3 bit
for bit, the K-step driver's passes at ragged widths, in f64 and with NaN
ghosts, its mbarriers on short and ragged segments and strips at every
pass depth (each case in a worker process with a time limit, so that a
hang fails it), and the model's cuda backend against its torch backend,
single-step (also 512 steps at 2048^2), temporal (all three band legs),
sharded (shards sharing the card, every leg) and in the quirk mode (two
runs bit for bit; 512 steps at 2048^2; f64 at 2048^2 within 1e-12); the
legs against each other at the benchmark's sizes (2048^2 auto against
single-step over 2,048 steps, bf16 against f32 over 24,576, 8192^2 auto
against single-step and the x-tiled leg bit for bit) and the meshes
there against one device (f32, the quirk, f64, bf16); the channel through
B2h (against the CPU, its analytic profile, and at 2048^2 its plain
version), the cavity against Ghia, a caller's TF32 setting kept out of
the IB, the f32-vs-f64 velocity gates at 192^2 over 4,000 steps
(single-step and auto, exact launches), B2 from the identity-collide
build streaming without colliding, B4 from the one-block-per-SM build
equal to the default build's, the probes' own runs, two 2048^2
metachrony sweep points in f32 against f64 (2e-4) with their exact B5/B4
launches and their refusals, validate_flux's early curve against the JAX
f64 oracle (1e-9 in f64, 2e-5 in f32), the CLI of the reference channel
(2,000 steps: single-step, auto, on (2, 1), in bf16 and in the quirk
mode, exact launches, flux against the f64 golden and each other), the
model step's kernel spans counting the wrappers' launches, B5, B6 and B8
at K = 1 to 16 in f32, f64 and bf16 storage with each sub-step's spread
folded into the next sub-step's band step (the flux column on a tile's
first and last column and in a ragged tile's wrapped columns), one B5
call's device kernels in the order the benchmark's counts/b5.py sums
them (2K + 2, or 2K + 1 without the flux column), the model
step making no host-device sync (a 1,000-step interval on the band
super-step leg and a single-step chunk, f32, f64 and bf16, under
torch.cuda.set_sync_debug_mode("error")), and ranks on the card (the
CLI under two gloo ranks and one NCCL rank bit for bit the one-process
mesh; the directory checkpoint).  They carry the ``cuda`` marker and
skip on a host without a CUDA device.  This file imports no JAX, so on
the GPU host (which has none) it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel vs plain version, as rel-L2 of each output: 1e-6 in f32
(nvcc contracts multiply-adds and the plain version does not, so they
differ at f32 round-off) and 1e-12 in f64; for B5's force and flux 1e-5
and 1e-11, since the kernel gathers the IB stencils in another order than
the plain version's dense window products and the IB feedback carries the
difference through K sub-steps.  B6 equals B5 on the same inputs bit for
bit: a cell's force takes the terms of the points that reach it, and no
cell is reached by two cilia whose lift order differs from their cilium
order.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super, band_super_reference, launch_band_super,
)
from cuda_iblb_11_tpu_torch.ops.band_super_tiled import (
    band_super_tiled, band_super_tiled_reference,
)
from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
    band_super_xsharded, band_super_xsharded_reference, shard_points,
)
from cuda_iblb_11_tpu_torch.models.channel import PoiseuilleChannel
from cuda_iblb_11_tpu_torch.ops import probes
from cuda_iblb_11_tpu_torch.ops.collide_rows import (
    MAX_SLABS, collide_rows, collide_rows_reference, collide_slabs,
    collide_slabs_reference,
)
from cuda_iblb_11_tpu_torch.ops.collide_stream import (
    collide_stream, collide_stream_reference,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference, sharded_fused_substep,
    sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
    ghost_temporal, ghost_temporal_reference, kstep_geometry,
)
from cuda_iblb_11_tpu_torch.ops.precision import bf16_agreement
from cuda_iblb_11_tpu_torch.ops.temporal import (
    band_super_resident, plan_temporal, xshard_layout,
)
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
    temporal_bulk, temporal_bulk_reference,
)
from cuda_iblb_11_tpu_torch.parallel import (
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)
from cuda_iblb_11_tpu_torch.utils import spans

GATE = {torch.float32: 1e-6, torch.float64: 1e-12}
GRIDS = {
    "channel_288x192": dict(c_num=6, c_space=48),
    "band_below_ydim": dict(c_num=2, c_space=64, ydim=64, length=16),
    "ragged_150x61": dict(c_num=3, c_space=50, ydim=61, length=16),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU host (README)")
    return torch.device("cuda")


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def random_inputs(cfg, storage, dtype, device, seed=0):
    """Seeded f near equilibrium (raw or deviatoric) and a band force."""
    rng = np.random.default_rng(seed)
    y, x = cfg.ydim, cfg.xdim
    rho = torch.from_numpy(1.0 + 0.02 * rng.standard_normal((y, x)))
    u = torch.from_numpy(0.01 * rng.standard_normal((2, y, x)))
    f = ref.equilibrium(rho, u, storage)
    w = torch.tensor(W)[:, None, None]
    f = f + 1e-4 * torch.from_numpy(rng.standard_normal(f.shape)) * w
    force = torch.from_numpy(
        1e-4 * rng.standard_normal((2, cfg.force_band, x)))
    return f.to(device, dtype), force.to(device, dtype)


# the hand kernels' wrappers by kernel ID; each counts its launches
WRAPPERS = {"B0": collide_slabs, "B2": fused_substep, "B2h": collide_stream,
            "B3": sharded_fused_substep, "B4": temporal_bulk,
            "B5": band_super, "B6": band_super_tiled, "B7": ghost_temporal,
            "B8": band_super_xsharded}
# the benchmark's grids (iblb_benchmark/configs/)
SIZES = {"2048x2048": dict(c_num=16, c_space=128, ydim=2048),
         "8192x8192": dict(c_num=64, c_space=128, ydim=8192)}


def counted(fn, *args, **kw):
    """fn(*args, **kw) and the launches it made, by kernel ID (the kernels
    it launched only)."""
    n0 = {k: w.launches for k, w in WRAPPERS.items()}
    out = fn(*args, **kw)
    return out, {k: w.launches - n0[k] for k, w in WRAPPERS.items()
                 if w.launches != n0[k]}


CASES = [
    (torch.float32, "deviatoric", "trt_split", "slip"),
    (torch.float32, "deviatoric", "trt_split", "noslip"),
    (torch.float32, "raw", "reference", "slip"),
    (torch.float64, "raw", "trt_split", "slip"),
    (torch.float64, "raw", "trt_split", "noslip"),
    (torch.float64, "deviatoric", "reference", "noslip"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("dtype,storage,forcing,top", CASES)
def test_kernel_matches_plain_version(card, grid, dtype, storage, forcing,
                                      top):
    cfg = SimConfig(**GRIDS[grid])
    walls = ref.WallSpec(top=top)
    f, force = random_inputs(cfg, storage, dtype, card)
    got = fused_substep(f, force, cfg, walls, forcing, storage)
    want = fused_substep_reference(f, force, cfg, walls, forcing, storage)
    torch.cuda.synchronize()
    for name, g, w in zip(("f", "q", "fluxcol"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert rel_l2(g, w) <= GATE[dtype], (name, rel_l2(g, w))


@pytest.mark.cuda
def test_wrapper_counts_launches_and_guards_buffers(card):
    cfg = SimConfig(**GRIDS["band_below_ydim"])
    f, force = random_inputs(cfg, "raw", torch.float32, card)
    out = torch.empty_like(f)
    before = fused_substep.launches
    f_new, _, _ = fused_substep(f, force, cfg, storage="raw", out=out)
    assert f_new.data_ptr() == out.data_ptr()
    assert fused_substep.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        fused_substep(f, force, cfg, storage="raw", out=f)
    with pytest.raises(ValueError, match="contiguous"):
        fused_substep(f.transpose(1, 2).contiguous().transpose(1, 2), force,
                      cfg, storage="raw")
    # raw bf16 refuses as JAX does; a dtype without a kernel raises and
    # never reaches another dtype's entry
    with pytest.raises(ValueError, match="requires deviatoric mode"):
        fused_substep(f.to(torch.bfloat16), force, cfg, storage="raw")
    with pytest.raises(NotImplementedError):
        fused_substep(f.to(torch.float16), force.to(torch.float16), cfg,
                      storage="deviatoric")
    with pytest.raises(NotImplementedError):
        fused_substep(f, force, cfg, ref.WallSpec(top="moving"))
    assert fused_substep.launches == before + 1   # refusals launch nothing


@pytest.mark.cuda
@pytest.mark.parametrize("grid,dtype,steps", [
    ("288x192", "float32", 512), ("288x192", "float64", 50),
    ("2048x2048", "float32", 512)])
def test_sim_cuda_backend_matches_torch_backend(card, grid, dtype, steps):
    kw = SIZES.get(grid, dict(c_num=6, c_space=48))
    cfg = SimConfig(dtype=dtype, **kw)
    states = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card)
        st, launched = counted(sim.run_chunk, sim.init_state(), steps)
        states[backend] = (sim, st)
        assert launched == ({"B2": steps} if backend == "cuda" else {})
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,temporal", [("cuda", 1), ("cuda", 16),
                                              ("torch", 1)])
def test_tf32_setting_does_not_reach_the_ib(card, backend, temporal):
    # a caller who allows TF32 ("high" and allow_tf32) gets the same 2048^2
    # run of 64 steps, bit for bit, as with both off: the IB matmuls and
    # the plain collide's einsums (the torch backend's step is B2's plain
    # version, fused_substep_reference) pin full f32
    # (ops/precision.full_f32) and give the caller's setting back
    cfg = SimConfig(c_num=16, c_space=128, ydim=2048)
    saved = torch.get_float32_matmul_precision()

    def run():
        sim = MucociliarySim(cfg, device=card, backend=backend,
                             temporal=temporal)
        return sim.run_chunk(sim.init_state(), 64)

    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        loose = run()
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32 is True
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        strict = run()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert torch.equal(loose.f, strict.f)
    assert torch.equal(loose.force, strict.force)
    assert float(loose.q) == float(strict.q)


# --- B3, B4, B5 --------------------------------------------------------

TEMPORAL_CASES = [
    (torch.float32, "deviatoric", "slip"),
    (torch.float32, "deviatoric", "noslip"),
    (torch.float64, "raw", "slip"),
    (torch.float64, "raw", "noslip"),
]
SMALL = dict(c_num=4, c_space=48, ydim=256)            # per-sub-step leg
SUPER = dict(c_num=4, c_space=128, ydim=256)           # band super leg


def _rows(cfg, storage, dtype, device, rows, seed):
    f, force = random_inputs(cfg, storage, dtype, device, seed)
    return f[:, :rows].contiguous(), force


def _check_all(got, want, gates):
    for (name, gate), g, w in zip(gates, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert rel_l2(g, w) <= gate, (name, rel_l2(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(0, 1, 0), (0, 1, 1)])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES)
def test_b3_matches_plain_version(card, flags, dtype, storage, top):
    cfg = SimConfig(**SMALL)
    band = cfg.force_band
    f, force = _rows(cfg, storage, dtype, card, band + 16, seed=1)
    rng = np.random.default_rng(2)
    halos = [torch.from_numpy(0.1 * rng.standard_normal((9, cfg.xdim))).to(
        card, dtype) + f[:, 0] for _ in range(2)]
    walls = ref.WallSpec(top=top)
    args = (flags, f, force, halos[0], halos[1], cfg, walls, "trt_split",
            storage, band - 1, True)
    before = sharded_fused_substep.launches
    got = sharded_fused_substep(*args)
    want = sharded_fused_substep_reference(*args)
    torch.cuda.synchronize()
    assert sharded_fused_substep.launches == before + 1
    g = GATE[dtype]
    _check_all(got, want, [("f", g), ("f1row", g), ("q", g), ("fluxcol", g)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES)
def test_b3_with_both_walls_is_the_b2_step(card, dtype, storage, top):
    # flags [0, 1, 1] and no halos over the whole domain: the one kernel
    # gives B2's result bit for bit
    cfg = SimConfig(**SMALL)
    f, force = random_inputs(cfg, storage, dtype, card, seed=6)
    walls = ref.WallSpec(top=top)
    b2 = fused_substep(f, force, cfg, walls, "trt_split", storage)
    b3 = sharded_fused_substep((0, 1, 1), f, force, None, None, cfg, walls,
                               "trt_split", storage, emit_moments=True)
    for a, b in zip(b2, (b3[0], b3[2], b3[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 5])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES)
def test_b4_matches_plain_version(card, K, dtype, storage, top):
    cfg = SimConfig(**SMALL)
    band = cfg.force_band
    f, _ = random_inputs(cfg, storage, dtype, card, seed=3)
    f_bulk = f[:, band:]          # a row range of the state, as the model
    bhalos = f[None, :, band - 1].repeat(K, 1, 1).contiguous()
    walls = ref.WallSpec(top=top)
    before = temporal_bulk.launches
    out = torch.empty_like(f)
    got = temporal_bulk(f_bulk, bhalos, cfg, walls, "trt_split", storage,
                        out=out[:, band:])
    want = temporal_bulk_reference(f_bulk, bhalos, cfg, walls, "trt_split",
                                   storage)
    torch.cuda.synchronize()
    assert temporal_bulk.launches == before + 1
    assert got[0].data_ptr() == out[:, band:].data_ptr()
    g = GATE[dtype]
    _check_all(got, want, [("f", g), ("flux", g)])


def super_inputs(cfg, K, dtype, storage, device, it0=137, seed=4):
    """f_ext, force and the points of K real steps from it0 (K = 1 with
    the pad and halo of K = 2: no plan takes a one-step super-step)."""
    sim = MucociliarySim(cfg, backend="torch", device=device, dtype=dtype,
                         temporal=max(K, 2))
    plan = sim.plan
    # the whole leg (no device holds the band to a budget); the x-tiled
    # leg takes the same inputs
    assert plan.band_leg == "band_super_whole"
    f, force = random_inputs(cfg, storage, dtype, device, seed)
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(it0, K)
    xs = prep_band_super_points(cfg, K, plan.halo, dtype, u_s, eps, anchor,
                                frac, 1)
    return (f[:, :cfg.force_band + plan.pad_s], force,
            [x[0] for x in xs], plan.halo)


# f in f32, f64 and bf16 storage (the band super-step's compute dtype
# f32 under bf16)
SUPER_CASES = TEMPORAL_CASES[::3] + [(torch.bfloat16, "deviatoric", "slip")]
SUPER_OUTPUTS = ("f_band", "bhalos", "force", "flux")


def super_config(dtype, flux=None, **grid):
    """SimConfig of grid (SUPER by default) with f in dtype and the flux
    column at x = flux (the model's x = X - 5 for None); flux "wrapped" is
    column 5 of a ragged 500-column domain (c_space 125), one of the
    columns that the last 32-column tile, 20 columns wide, collides past
    the domain's end."""
    grid = dict(SUPER, **grid)
    if flux == "wrapped":
        grid["c_space"], flux = 125, 5
    cfg = SimConfig(dtype=str(dtype).split(".")[-1], **grid)
    if flux is None:
        return cfg
    return dataclasses.replace(cfg, flux_column_offset=cfg.xdim - flux)


def super_gates(dtype):
    g, gi = (1e-6, 1e-5) if dtype != torch.float64 else (1e-12, 1e-11)
    return [("f_band", g), ("bhalos", g), ("force", gi), ("flux", gi)]


def check_super(got, want, dtype, gates=None):
    """A band super-step call against its plain version (bf16 f: at least
    99.9% bit-equal)."""
    gates = gates or super_gates(dtype)
    (_check_bf16 if dtype == torch.bfloat16 else _check_all)(got, want,
                                                            gates)


# (K, flux column): the model's, on a 32-column tile's first column (256)
# and last (255), and in the wrapped columns of a ragged last tile; a
# sub-step s >= 1 folds sub-step s - 1's spread and flux column into its
# band step
B5_CASES = ([(K, None) for K in (1, 2, 4, 16)]
            + [(K, x) for x in (256, 255, "wrapped") for K in (2, 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("K,flux", B5_CASES)
@pytest.mark.parametrize("dtype,storage,top", SUPER_CASES)
def test_b5_matches_plain_version(card, K, flux, dtype, storage, top):
    cfg = super_config(dtype, flux)
    cdt = torch.promote_types(dtype, torch.float32)
    f_ext, force, xs, halo = super_inputs(cfg, K, cdt, storage, card)
    f_ext = f_ext.to(dtype)
    walls = ref.WallSpec(top=top)
    args = (f_ext, force, *xs, cfg, halo, walls, "trt_split", storage)
    before = band_super.launches
    got, again = band_super(*args), band_super(*args)
    want = band_super_reference(*args)
    torch.cuda.synchronize()
    assert band_super.launches == before + 2
    for name, a, b in zip(SUPER_OUTPUTS, got, again):   # no atomics
        assert torch.equal(a, b), name
    check_super(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("owned", [True, False])
@pytest.mark.parametrize("K", [1, 2, 16])
def test_b5_device_kernels_are_what_the_benchmark_sums(card, K, owned):
    # one call's device kernels, read as the benchmark's trace reads them:
    # per sub-step the band step (from the second on the instantiation
    # that folds in the spread before it) and the interpolation, then the
    # last spread and, where the block owns the flux column, the flux sum;
    # counts/b5.py sums every one of them
    from torch.profiler import ProfilerActivity, profile

    from iblb_benchmark.counts import b5, kernel_name
    from iblb_benchmark.trace import read_device

    cfg = SimConfig(**SUPER)
    f_ext, force, xs, halo = super_inputs(cfg, K, torch.float32,
                                          "deviatoric", card)

    def call():
        return launch_band_super(
            f_ext, force, xs, cfg, cfg.c_space + 2 * halo, -halo,
            cfg.flux_x if owned else None, ref.REFERENCE_WALLS, "trt_split",
            "deviatoric", "band_super")

    want = (["step_kernel", "interp_kernel"] * K + ["spread_kernel"]
            + ["column_sum_kernel"] * owned)
    call()
    torch.cuda.synchronize()
    # the C entry launches the same kernels in the same order every call,
    # so one clean profile shows it; a profile of the full card suite
    # once read another sequence here, which no rerun showed again, so a
    # profile that does not read it is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ops = read_device(prof.profiler.kineto_results.events())
        names = [kernel_name(o.name) for o in ops]
        if names == want:
            break
    assert names == want, names
    assert len(ops) == 2 * K + 1 + owned
    steps = [o.name for o in ops[:2 * K:2]]
    assert all(n == steps[-1] != steps[0] for n in steps[1:])
    assert b5.device_seconds(ops) == sum(o.seconds for o in ops)


@pytest.mark.cuda
def test_temporal_wrappers_refuse_bad_inputs(card):
    cfg = SimConfig(**SMALL)
    band = cfg.force_band
    f, force = random_inputs(cfg, "raw", torch.float32, card)
    bh = f[None, :, band - 1].repeat(2, 1, 1).contiguous()
    n3, n4 = sharded_fused_substep.launches, temporal_bulk.launches
    with pytest.raises(ValueError):       # bhalos shape
        temporal_bulk(f[:, band:], bh[:, :4], cfg)
    with pytest.raises(ValueError):       # bhalos dtype
        temporal_bulk(f[:, band:], bh.double(), cfg)
    with pytest.raises(ValueError):       # bhalos device
        temporal_bulk(f[:, band:], bh.cpu(), cfg)
    with pytest.raises(ValueError, match="alias"):
        temporal_bulk(f[:, band:], bh, cfg, out=f[:, band:])
    with pytest.raises(NotImplementedError):
        temporal_bulk(f[:, band:].half(), bh.half(), cfg)
    with pytest.raises(ValueError, match="rows"):   # columns not contiguous
        temporal_bulk(f[:, band:, :].transpose(1, 2).contiguous()
                      .transpose(1, 2), bh, cfg)
    with pytest.raises(ValueError):       # halo shape
        sharded_fused_substep((0, 1, 0), f[:, :band + 16], force,
                              bh[:, :, :8], None, cfg)
    with pytest.raises(ValueError, match="width"):   # x-shard + emission
        sharded_fused_substep((0, 1, 0), f[:, :band + 16, :96].contiguous(),
                              force[:, :, :96].contiguous(), None, None, cfg,
                              emit_moments=True)
    assert (sharded_fused_substep.launches, temporal_bulk.launches) == \
        (n3, n4)   # refusals launch nothing
    cfg_s = SimConfig(**SUPER)
    f_ext, frc, xs, halo = super_inputs(cfg_s, 2, torch.float32,
                                        "deviatoric", card)
    n5 = band_super.launches
    with pytest.raises(ValueError):       # int64 anchors
        band_super(f_ext, frc, xs[0], xs[1], xs[2].long(), *xs[3:], cfg_s,
                   halo)
    with pytest.raises(ValueError, match="ghost pad"):
        band_super(f_ext[:, :cfg_s.force_band + 1], frc, *xs, cfg_s, halo)
    with pytest.raises(ValueError):       # force dtype
        band_super(f_ext, frc.double(), *xs, cfg_s, halo)
    with pytest.raises(ValueError):       # points on the CPU
        band_super(f_ext, frc, xs[0].cpu(), *xs[1:], cfg_s, halo)
    with pytest.raises(ValueError):       # points of another K
        band_super(f_ext, frc, xs[0][:1].contiguous(), *xs[1:], cfg_s, halo)
    assert band_super.launches == n5


@pytest.mark.cuda
@pytest.mark.parametrize("grid,K", [("per_substep", 16),
                                    ("band_super_whole", 8)])
def test_sim_temporal_cuda_matches_torch_backend(card, grid, K):
    kw = dict(c_num=6, c_space=48) if grid == "per_substep" else SUPER
    cfg = SimConfig(**kw)
    states = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card, temporal=K)
        assert sim.resolved_config()["band_leg"] == grid
        n0 = (sharded_fused_substep.launches, temporal_bulk.launches,
              band_super.launches, fused_substep.launches)
        states[backend] = (sim, sim.run_chunk(sim.init_state(), 3 * K + 3))
        n1 = (sharded_fused_substep.launches, temporal_bulk.launches,
              band_super.launches, fused_substep.launches)
        launched = tuple(b - a for a, b in zip(n0, n1))
        if backend == "torch":
            assert launched == (0, 0, 0, 0)
        elif grid == "per_substep":
            assert launched == (3 * K, 3, 0, 3)
        else:
            assert launched == (0, 3, 3, 3)
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    assert rel_l2(ua, ub) <= 1e-5
    assert abs(float(a.q) - float(b.q)) <= 1e-5 * abs(float(b.q))


@pytest.mark.cuda
def test_kernel_spans_count_the_wrappers_launches(card):
    # each kernel span wraps one wrapper call: 3 super-steps and 3 single
    # steps at K = 8 on the band super-step leg
    K = 8
    sim = MucociliarySim(SimConfig(**SUPER), backend="cuda", device=card,
                         temporal=K)
    wrappers = {"iblb.B2": fused_substep, "iblb.B4": temporal_bulk,
                "iblb.B5": band_super}
    n0 = {name: w.launches for name, w in wrappers.items()}
    spans.start()
    try:
        sim.run_chunk(sim.init_state(), 3 * K + 3)
        torch.cuda.synchronize()
    finally:
        spans.stop()
    names = Counter(r.name for r in spans.records())
    for name, w in wrappers.items():
        assert names[name] == w.launches - n0[name] == 3, name
    assert names["iblb.run_chunk"] == 1 and names["iblb.ib"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("leg,K,n", [("band_super_whole", 16, 1000),
                                     ("single_step", 1, 8)])
def test_run_chunk_never_waits_for_the_card(card, leg, K, n, dtype):
    # a 1,000-step interval at K = 16 runs a 512-step chunk and a 480 +
    # 8-step one; nothing in run_chunk may sync the host with the card,
    # or each chunk's kinematics would wait for the queued work
    sim = MucociliarySim(SimConfig(**SUPER, dtype=dtype), backend="cuda",
                         device=card, temporal=K)
    assert sim.resolved_config()["band_leg"] == leg
    state = sim.run_chunk(sim.init_state(), n)   # builds and warms
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sim.run_chunk(state, n)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert out.it == state.it + n and torch.isfinite(out.q)


# --- B6 ------------------------------------------------------------------

TILED = dict(c_num=12, c_space=128, ydim=192)   # 3 tiles of 512 + 2 x 512


def xtiled_plan(cfg, K, dtype, walls=ref.REFERENCE_WALLS):
    """The plan of cfg with a budget one byte below the whole band's
    footprint: the x-tiled leg (the plans of the simulations take no
    budget)."""
    whole = plan_temporal(cfg, K, walls, dtype)
    fp = band_super_resident(cfg.xdim, cfg.force_band + whole.pad_s,
                             cfg.force_band, 2 * whole.halo, dtype)
    plan = plan_temporal(cfg, K, walls, dtype, budget=fp - 1)
    assert plan.band_leg == "band_super_xtiled"
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b6_matches_plain_version_and_b5(card, K, dtype, storage, top):
    cfg = SimConfig(dtype=str(dtype).split(".")[-1], **TILED)
    plan = xtiled_plan(cfg, K, dtype)
    f_ext, force, xs, halo = super_inputs(cfg, K, dtype, storage, card)
    walls = ref.WallSpec(top=top)
    args = (f_ext, force, *xs, cfg, halo, plan.tile_x, plan.gx, walls,
            "trt_split", storage)
    before = band_super_tiled.launches
    got = band_super_tiled(*args)
    want = band_super_tiled_reference(*args)
    torch.cuda.synchronize()
    assert band_super_tiled.launches == before + cfg.xdim // plan.tile_x
    g, gi = (1e-6, 1e-5) if dtype == torch.float32 else (1e-12, 1e-11)
    gates = [("f_band", g), ("bhalos", g), ("force", gi), ("flux", gi)]
    _check_all(got, want, gates)
    whole = band_super(f_ext, force, *xs, cfg, halo, walls, "trt_split",
                       storage)
    for name, a, b in zip(("f_band", "bhalos", "force", "flux"), got, whole):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_b6_refuses_bad_tiles_and_points(card):
    cfg = SimConfig(**TILED)
    plan = xtiled_plan(cfg, 2, torch.float32)
    f_ext, frc, xs, halo = super_inputs(cfg, 2, torch.float32, "deviatoric",
                                        card)
    n6 = band_super_tiled.launches
    with pytest.raises(ValueError, match="multiple of c_space"):
        band_super_tiled(f_ext, frc, *xs, cfg, halo, 320, plan.gx)
    with pytest.raises(ValueError, match="ghost margin"):
        band_super_tiled(f_ext, frc, *xs, cfg, halo, plan.tile_x, 256)
    with pytest.raises(ValueError):       # the points of 11 cilia, not 12
        band_super_tiled(f_ext, frc, xs[0][:, :, :11].contiguous(),
                         *(x[:, :11].contiguous() for x in xs[1:]), cfg,
                         halo, plan.tile_x, plan.gx)
    with pytest.raises(ValueError):       # int64 anchors
        band_super_tiled(f_ext, frc, xs[0], xs[1], xs[2].long(), *xs[3:],
                         cfg, halo, plan.tile_x, plan.gx)
    with pytest.raises(ValueError, match="alias"):
        band_super_tiled(f_ext, frc, *xs, cfg, halo, plan.tile_x, plan.gx,
                         out=f_ext[:, :cfg.force_band])
    assert band_super_tiled.launches == n6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sim_xtiled_cuda_matches_torch_backend(card, dtype):
    cfg = SimConfig(dtype=dtype, **TILED)
    K = 4
    states = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card, temporal=K)
        plan = xtiled_plan(cfg, K, sim.dtype)
        assert dataclasses.replace(plan, band_leg=sim.plan.band_leg,
                                   tile_x=sim.plan.tile_x,
                                   gx=sim.plan.gx) == sim.plan
        sim.plan = plan
        assert sim.resolved_config()["band_leg"] == "band_super_xtiled"
        n0 = (band_super_tiled.launches, band_super.launches,
              temporal_bulk.launches, fused_substep.launches)
        states[backend] = (sim, sim.run_chunk(sim.init_state(), 3 * K + 3))
        n1 = (band_super_tiled.launches, band_super.launches,
              temporal_bulk.launches, fused_substep.launches)
        launched = tuple(b - a for a, b in zip(n0, n1))
        n_tiles = cfg.xdim // plan.tile_x
        assert launched == ((0, 0, 0, 0) if backend == "torch"
                            else (3 * n_tiles, 0, 3, 3))
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q))


# --- the spread's candidate list (B5, B6, B8) ------------------------------

def placed_points(cfg, K, halo, dtype, device, X, Y, live, eps=0.05,
                  seed=7):
    """Point blocks in the band super-step's layout (us [K, 2, c, 128],
    eps, axl, fx, ay, fy [K, c, 128]) with node k of cilium m anchored at
    the domain cell (X[m, k], Y[m, k]) in every sub-step where live[m, k],
    and inert (padded: anchors -20000, eps 0) elsewhere; fractions in
    [-0.5, 0.5) and velocities seeded."""
    rng = np.random.default_rng(seed)
    c = cfg.c_num
    shape = (K, c, 128)
    wstart = (np.arange(c) * cfg.c_space - halo)[:, None]
    axl = np.broadcast_to(np.where(live, X - wstart, -20000), shape)
    ay = np.broadcast_to(np.where(live, Y, -20000), shape)
    fx = np.where(live, rng.uniform(-0.5, 0.5, shape), 0.0)
    fy = np.where(live, rng.uniform(-0.5, 0.5, shape), 0.0)
    us = np.where(live, 0.01 * rng.standard_normal((K, 2, c, 128)), 0.0)
    ep = np.broadcast_to(np.where(live, eps, 0.0), shape)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
            for a, dt in ((us, dtype), (ep, dtype), (axl, torch.int32),
                          (fx, dtype), (ay, torch.int32), (fy, dtype))]


def placement(cfg, layout):
    """(X, Y, live) [c, 128] of a candidate-list case.  Every layout but
    "curled" spreads each cilium's nodes over 43 consecutive columns
    around a centre, on rows at the band's bottom and top and around a
    row edge of the 32 x 8 blocks: some node lies on each side of every
    block edge it crosses, within 3 cells, whatever the block's alignment.
      edges     centres at m c_space + c_space / 2;
      seam      cilium 0 centred on column 0 and the last on column X
                (the periodic seam, through both wrapped windows);
      curled    cilia 0-2 with all 128 nodes in the one block of columns
                160-191 and rows 8-15 (384 candidates there, more than a
                pass of the list holds); the rest inert;
      inert     every node padded;
      zero_eps  the edges layout with eps 0 (set by the caller): every
                point passes and adds zero."""
    c, cw, band = cfg.c_num, cfg.c_space, cfg.force_band
    k = np.arange(128)
    rows = np.array([0, 1, 2, 5, 6, 7, 8, 9, 10, band - 3, band - 2,
                     band - 1])
    centre = np.arange(c) * cw + cw // 2
    if layout == "seam":
        centre[0], centre[-1] = 0, cfg.xdim
    X = centre[:, None] + (k % 43) - 21
    Y = np.broadcast_to(rows[k % len(rows)], (c, 128))
    live = np.ones((c, 128), bool)
    if layout == "curled":
        X = np.broadcast_to(160 + k % 32, (c, 128))
        Y = 8 + (k // 32)[None, :] + 4 * (np.arange(c)[:, None] == 1)
        live = np.broadcast_to(np.arange(c)[:, None] < 3, (c, 128))
    elif layout == "inert":
        live[:] = False
    return X, Y, live


def _hold_candidates(got, again, want, dtype, zero_force):
    """The kernel against its second run (bit for bit: no atomics) and
    against the plain version (the gates above; where the force is all
    zero, it is zero in both)."""
    for name, a, b in zip(SUPER_OUTPUTS, got, again):
        assert torch.equal(a, b), name
    gates = super_gates(dtype)
    if zero_force:
        assert not got[2].any() and not want[2].any()
        got, want, gates = (got[:2] + got[3:], want[:2] + want[3:],
                            gates[:2] + gates[3:])
    else:
        assert got[2].abs().max() > 0
    check_super(got, want, dtype, gates)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 16])
@pytest.mark.parametrize("layout", ["edges", "seam", "curled", "inert",
                                    "zero_eps"])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b5_candidate_list(card, layout, dtype, storage, top, K):
    # points where pruning the spread's candidates could drop one: the
    # kernel against the plain version and against itself; from the
    # second sub-step on the band step lists them (the same points in
    # every sub-step, so "curled" passes SCAP there too)
    cfg = SimConfig(dtype=str(dtype).split(".")[-1], **SUPER)
    f_ext, force, _, halo = super_inputs(cfg, K, dtype, storage, card)
    xs = placed_points(cfg, K, halo, dtype, card, *placement(cfg, layout),
                       eps=0.0 if layout == "zero_eps" else 0.05)
    args = (f_ext, force, *xs, cfg, halo, ref.WallSpec(top=top),
            "trt_split", storage)
    got, again = band_super(*args), band_super(*args)
    want = band_super_reference(*args)
    torch.cuda.synchronize()
    _hold_candidates(got, again, want, dtype,
                     layout in ("inert", "zero_eps"))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 16])
@pytest.mark.parametrize("kernel,layout", [("B6", "seam"), ("B6", "curled"),
                                           ("B8", "edges")])
@pytest.mark.parametrize("dtype,storage,top", SUPER_CASES)
def test_b6_b8_candidate_list(card, kernel, layout, dtype, storage, top, K):
    # B6 on tiles (the seam's cilia lifted into the first and last tile)
    # and B8 in the phase-general layout (c_space 256 on four x-shards:
    # windows c_space wider, from block column 0); K = 1 on the K = 2
    # layout; bf16 storage with f32 points and force
    walls = ref.WallSpec(top=top)
    cdt = torch.promote_types(dtype, torch.float32)
    if kernel == "B6":
        cfg = SimConfig(dtype=str(dtype).split(".")[-1], **TILED)
        plan = xtiled_plan(cfg, max(K, 2), dtype)
        f_ext, force, _, halo = super_inputs(cfg, K, cdt, storage, card)
        f_ext = f_ext.to(dtype)
        xs = placed_points(cfg, K, halo, cdt, card,
                           *placement(cfg, layout))
        args = (f_ext, force, *xs, cfg, halo, plan.tile_x, plan.gx, walls,
                "trt_split", storage)
        got, again = band_super_tiled(*args), band_super_tiled(*args)
        want = band_super_tiled_reference(*args)
    else:
        cfg = SimConfig(c_num=10, c_space=256, ydim=256,
                        dtype=str(dtype).split(".")[-1])
        n_x = 4
        xl = cfg.xdim // n_x
        pad = max(K, 8)
        lay = xshard_layout(cfg, pad, K, walls, dtype, xl, n_x)
        assert lay.phase_general
        f, force = random_inputs(cfg, storage, cdt, card, seed=12)
        f = f.to(dtype)
        xs = placed_points(cfg, K, lay.halo, cdt, card,
                           *placement(cfg, layout))
        ix = 1          # its block's edge runs through cilium 2's nodes
        cols = torch.arange(ix * xl - lay.gx, (ix + 1) * xl + lay.gx,
                            device=card) % cfg.xdim
        owned = ix * xl <= cfg.flux_x < (ix + 1) * xl
        flags = (cfg.flux_x - ix * xl + lay.gx if owned else 0, int(owned))
        args = (flags, f[:, :cfg.force_band + pad][:, :, cols].contiguous(),
                force[:, :, cols].contiguous(),
                *shard_points(lay, xs, cfg, ix, xl), cfg, lay, walls,
                "trt_split", storage)
        got, again = band_super_xsharded(*args), band_super_xsharded(*args)
        want = band_super_xsharded_reference(*args)
        if not owned:   # flux: zeros in both
            got, again, want = got[:3], again[:3], want[:3]
    torch.cuda.synchronize()
    _hold_candidates(got, again, want, dtype, False)


@pytest.mark.cuda
def test_band_super_f32_velocity_error_500_steps(card):
    # tests/test_accuracy_horizon.py's band super-step gate on the card:
    # 384 x 256 with 3 cilia, the cuda backend in f32 (storage auto) at
    # temporal 4 on the band super-step, against the torch backend in f64
    # raw single-step, 500 steps
    cfg64 = SimConfig(c_num=3, c_space=128, ydim=256, dtype="float64",
                      storage="raw")
    s64 = MucociliarySim(cfg64, backend="torch", device=card)
    u64 = s64.fields(s64.run_chunk(s64.init_state(), 500))[1]
    ssup = MucociliarySim(cfg64.replace(dtype="float32", storage="auto"),
                          backend="cuda", device=card, temporal=4)
    assert ssup.resolved_config()["band_leg"] == "band_super_whole"
    n5 = band_super.launches
    u32 = ssup.fields(ssup.run_chunk(ssup.init_state(), 500))[1]
    assert band_super.launches - n5 == 500 // 4
    assert torch.isfinite(u32).all()
    assert rel_l2(u32, u64) < 1.0e-5


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [1, "auto"])
def test_f32_velocity_error_500_2000_4000_steps(card, temporal):
    # tests/test_accuracy_horizon.py:50-73 on the card: 192^2 with 4
    # cilia, f32 (storage auto) single-step (B2) or at auto (K = 16, the
    # per-sub-step leg: B3 + the torch IB + B4) against f64 raw
    # single-step (B2 in f64).  run_chunk takes pieces of at most 512
    # steps, each the largest multiple of K as super-steps (K B3 and one
    # B4 each) and the rest single steps: the calls of 500, 1,500 and
    # 2,000 steps leave 4 + 12 of 4,000 steps to B2
    from cuda_iblb_11_tpu_torch.accuracy_horizon import velocity

    cfg64 = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
    s64 = MucociliarySim(cfg64, device=card)
    s32 = MucociliarySim(cfg64.replace(dtype="float32", storage="auto"),
                         device=card, temporal=temporal)
    assert (s32.temporal, s32.resolved_config()["band_leg"]) == (
        (1, "single_step") if temporal == 1 else (16, "per_substep"))
    st64, st32 = s64.init_state(), s32.init_state()
    n64, n32 = Counter(), Counter()
    errs = {}
    for n, gate in ((500, 1e-5), (2000, 3e-5), (4000, 8e-5)):
        st64, a = counted(s64.run_chunk, st64, n - st64.it)
        st32, b = counted(s32.run_chunk, st32, n - st32.it)
        n64.update(a)
        n32.update(b)
        errs[n] = rel_l2(velocity(s32, st32), velocity(s64, st64))
        assert errs[n] < gate, errs
    assert errs[4000] < 12.0 * errs[500], errs
    assert n64 == {"B2": 4000}
    assert n32 == ({"B2": 4000} if temporal == 1 else
                   {"B2": 16, "B3": 3984, "B4": 249}), n32


# Whole runs at the benchmark's sizes from the rest state, one run a leg:
# label: (grid, steps, {run: (dtype, temporal, (tile_x, gx) of the plan
# held to the card's L2 size or None for auto's, its launches)}, [(run,
# against, what, gate)]); "bits": f, force and q equal.  A 2,048-step run
# at 2048^2 is four 512-step pieces of 32 super-steps; the x-tiled leg
# launches B6 once a tile
LEGS_AT_SIZE = {
    "2048x2048 auto against single-step": (
        "2048x2048", 2048,
        {"auto": ("float32", "auto", None, {"B4": 128, "B5": 128}),
         "single": ("float32", 1, None, {"B2": 2048})},
        [("auto", "single", "velocity", 1e-5)]),
    "2048x2048 bf16 against f32 over JAX's bench horizon": (
        "2048x2048", 24576,
        {"bf16": ("bfloat16", "auto", None, {"B4": 1536, "B5": 1536}),
         "f32": ("float32", "auto", None, {"B4": 1536, "B5": 1536})},
        [("bf16", "f32", "velocity", 1e-2), ("bf16", "f32", "q", 1e-2)]),
    "8192x8192 auto against single-step and the x-tiled leg": (
        "8192x8192", 32,
        {"auto": ("float32", "auto", None, {"B4": 2, "B5": 2}),
         "single": ("float32", 1, None, {"B2": 32}),
         "x-tiled": ("float32", "auto", (1024, 512), {"B4": 2, "B6": 16})},
        [("auto", "single", "velocity", 1e-5), ("x-tiled", "auto", "bits",
                                                None)]),
    "8192x8192 bf16 x-tiled leg against the whole leg": (
        "8192x8192", 32,
        {"auto": ("bfloat16", "auto", None, {"B4": 2, "B5": 2}),
         "x-tiled": ("bfloat16", "auto", (2048, 512), {"B4": 2, "B6": 8})},
        [("x-tiled", "auto", "bits", None)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(LEGS_AT_SIZE))
def test_legs_agree_at_the_benchmark_sizes(card, label):
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes

    grid, steps, runs, checks = LEGS_AT_SIZE[label]
    out = {}
    for run, (dtype, temporal, tiles, launches) in runs.items():
        cfg = SimConfig(dtype=dtype, **SIZES[grid])
        sim = MucociliarySim(cfg, backend="cuda", device=card,
                             temporal=temporal)
        if tiles:
            sim.plan = plan_temporal(cfg, 16, sim.walls, sim.dtype,
                                     budget=l2_bytes(card))
            assert (sim.plan.band_leg, sim.plan.tile_x, sim.plan.gx) == (
                "band_super_xtiled", *tiles)
        st, n = counted(sim.run_chunk, sim.init_state(), steps)
        assert n == launches, (run, n)
        u = sim.fields(st)[1]
        assert torch.isfinite(u).all(), run
        out[run] = (st, u)
        del sim
    for run, other, what, gate in checks:
        (a, ua), (b, ub) = out[run], out[other]
        if what == "velocity":
            assert rel_l2(ua, ub) < gate, (run, other, rel_l2(ua, ub))
        elif what == "q":
            assert abs(float(a.q) - float(b.q)) < gate * abs(float(b.q))
        else:
            for field in ("f", "force", "q"):
                assert torch.equal(getattr(a, field), getattr(b, field)), \
                    (run, other, field)


@pytest.mark.cuda
def test_identity_collide_build_only_streams(card):
    # the identity-collide variant (probe_vpu.py's A/B): B2 from that
    # build streams f without colliding it, so its f is the plain
    # streaming of the input, bit for bit; the default library collides
    from cuda_iblb_11_tpu_torch.ops import _kernels

    cfg = SimConfig(**GRIDS["channel_288x192"])
    f, force = random_inputs(cfg, "raw", torch.float64, card, seed=3)
    want = ref.stream(f, ref.REFERENCE_WALLS)
    with _kernels.using(_kernels.load("identity_collide")):
        got = fused_substep(f, force, cfg, ref.REFERENCE_WALLS, "trt_split",
                            "raw")[0]
    full = fused_substep(f, force, cfg, ref.REFERENCE_WALLS, "trt_split",
                         "raw")[0]
    torch.cuda.synchronize()
    assert _kernels.load("identity_collide").path != _kernels.load().path
    assert torch.equal(got, want)
    assert not torch.equal(full, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_block_per_sm_build_is_the_same_b4(card, dtype):
    # probe_kstep.py's residency variant only asks for more shared memory
    # per block: B4 from it equals the default build's bit for bit
    from cuda_iblb_11_tpu_torch.ops import _kernels

    cfg = SimConfig(**SMALL)
    band, K = cfg.force_band, 5
    f, _ = random_inputs(cfg, "raw", dtype, card, seed=3)
    bhalos = f[None, :, band - 1].repeat(K, 1, 1).contiguous()
    want = temporal_bulk(f[:, band:], bhalos, cfg, ref.REFERENCE_WALLS,
                         "trt_split", "raw")
    with _kernels.using(_kernels.load("one_block_per_sm")):
        got = temporal_bulk(f[:, band:], bhalos, cfg, ref.REFERENCE_WALLS,
                            "trt_split", "raw")
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- B0, B7, B8 and the sharded path -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b0_matches_plain_version(card, dtype, storage, top):
    # an edge row and an edge column of a state, read in place (strided)
    cfg = SimConfig(**SMALL)
    f, force = random_inputs(cfg, storage, dtype, card, seed=8)
    fo = torch.zeros((2,) + f.shape[1:], dtype=dtype, device=card)
    fo[:, :cfg.force_band] = force
    before = collide_slabs.launches
    for sl in (np.s_[:, 5:6, :], np.s_[:, :, 7:8], np.s_[:, :150, -1:]):
        got = collide_rows(f[sl], fo[sl], cfg, "trt_split", storage)
        want = collide_rows_reference(f[sl], fo[sl], cfg, "trt_split",
                                      storage)
        assert got.is_contiguous() and got.shape == want.shape
        assert rel_l2(got, want) <= GATE[dtype]
    assert collide_slabs.launches == before + 3


def _slab_table(f, fo, n):
    """n slabs of f and fo read in place, in turn an edge row, an edge
    column, a block, a partial column and an empty slab, each somewhere
    else in the state."""
    y, x = f.shape[1:]
    out = []
    for i in range(n):
        r, c = (7 * i) % (y - 4), (13 * i) % (x - 4)
        sl = (np.s_[:, r:r + 1, :], np.s_[:, :, c:c + 1],
              np.s_[:, r:r + 3, c:c + 4], np.s_[:, :150, c:c + 1],
              np.s_[:, r:r, :])[i % 5]
        out.append((f[sl], fo[sl]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
@pytest.mark.parametrize("n", [1, 17, MAX_SLABS + 5])
def test_b0_table_is_the_per_slab_kernel(card, dtype, storage, top, n):
    # one launch per MAX_SLABS slabs of mixed rows, columns and blocks, read
    # in place (strided), an empty slab among them: each f1 equals the
    # single-slab call's bit for bit, and the plain version's to its gate
    cfg = SimConfig(**SMALL)
    f, force = random_inputs(cfg, storage, dtype, card, seed=9)
    fo = torch.zeros((2,) + f.shape[1:], dtype=dtype, device=card)
    fo[:, :cfg.force_band] = force
    slabs = _slab_table(f, fo, n)
    assert n < 5 or any(a.numel() == 0 for a, _ in slabs)
    before = collide_slabs.launches
    got = collide_slabs(slabs, cfg, "trt_split", storage)
    assert collide_slabs.launches == before + -(-n // MAX_SLABS)
    want = collide_slabs_reference(slabs, cfg, "trt_split", storage)
    one = [collide_rows(a, b, cfg, "trt_split", storage) for a, b in slabs]
    torch.cuda.synchronize()
    for g, w, o, (a, _) in zip(got, want, one, slabs):
        assert g.shape == a.shape and g.is_contiguous()
        assert torch.equal(g, o)
        if a.numel():
            assert rel_l2(g, w) <= GATE[dtype]


@pytest.mark.cuda
def test_b0_table_refuses_mixed_slabs(card):
    cfg = SimConfig(**SMALL)
    f, force = random_inputs(cfg, "raw", torch.float64, card, seed=9)
    fo = torch.zeros((2,) + f.shape[1:], dtype=f.dtype, device=card)
    before = collide_slabs.launches
    row = (f[:, 0:1], fo[:, 0:1])
    with pytest.raises(ValueError, match="slab 1"):     # another dtype
        collide_slabs([row, (f[:, 1:2].float(), fo[:, 1:2].float())], cfg)
    with pytest.raises(ValueError, match="slab 1: force shape"):
        collide_slabs([row, (f[:, 1:2], fo[:, 1:3])], cfg)
    assert collide_slabs([], cfg) == []
    assert collide_slabs.launches == before


def _ghost_case(cfg, f, y0, yl, x0, xl, xpad, K, pad=16):
    """Shard (y0, x0)'s block widened by xpad columns, its ghost rows and
    the seam halos (f's own row band-1, perturbed), periodic in y and x."""
    cols = torch.arange(x0 - xpad, x0 + xl + xpad, device=f.device) \
        % cfg.xdim
    rows = torch.arange(y0 - pad, y0 + yl + pad, device=f.device) % cfg.ydim
    blk = f[:, rows][:, :, cols]
    bh = f[None, :, cfg.force_band - 1][:, :, cols].repeat(K, 1, 1)
    bh = bh * (1.0 + 1e-3 * torch.arange(K, device=f.device)[:, None, None])
    return (blk[:, pad:pad + yl].contiguous(), blk[:, :pad].contiguous(),
            blk[:, pad + yl:].contiguous(), bh.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 5])
@pytest.mark.parametrize("y0,xpad", [(96, 0), (128, 128), (192, 128),
                                     (192, 0)])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b7_matches_plain_version(card, K, y0, xpad, dtype, storage, top):
    # an inject shard (the seam inside it, or at its bottom row), a top
    # shard, with and without x ghost columns; held on the rows it owns
    cfg = SimConfig(**SMALL)
    band, yl, pad = cfg.force_band, 64, 16
    xl = cfg.xdim if not xpad else 96
    f, _ = random_inputs(cfg, storage, dtype, card, seed=9)
    f_loc, bot, top_g, bh = _ghost_case(cfg, f, y0, yl, 0, xl, xpad, K)
    lb = min(max(band - y0, 0), yl)
    flags = (int(y0 <= band < y0 + yl), int(y0 + yl == cfg.ydim), pad + lb,
             xpad + cfg.flux_x % xl, 1)
    walls = ref.WallSpec(top=top)
    before = ghost_temporal.launches
    got = ghost_temporal(flags, f_loc, bot, top_g, bh, cfg, walls,
                         "trt_split", storage)
    want = ghost_temporal_reference(flags, f_loc, bot, top_g, bh, cfg, walls,
                                    "trt_split", storage)
    torch.cuda.synchronize()
    assert ghost_temporal.launches == before + 1
    own = np.s_[:, pad + lb:pad + yl, xpad:xpad + xl]
    assert rel_l2(got[0][own], want[0][own]) <= GATE[dtype]
    assert rel_l2(got[1], want[1]) <= GATE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES)
def test_b7_with_b4_flags_is_b4(card, dtype, storage, top):
    # the bulk rows as one shard above the band, NaN ghost rows, the seam
    # at its bottom row, the top wall and the flux column: B4 bit for bit
    cfg = SimConfig(**SMALL)
    band, K, pad = cfg.force_band, 5, 16
    f, _ = random_inputs(cfg, storage, dtype, card, seed=10)
    bh = f[None, :, band - 1].repeat(K, 1, 1).contiguous()
    nan = torch.full((9, pad, cfg.xdim), float("nan"), dtype=dtype,
                     device=card)
    walls = ref.WallSpec(top=top)
    b4 = temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split", storage)
    b7 = ghost_temporal((1, 1, pad, cfg.flux_x, 1), f[:, band:], nan, nan,
                        bh, cfg, walls, "trt_split", storage)
    assert torch.equal(b7[0][:, pad:-pad], b4[0])
    assert torch.equal(b7[1], b4[1])


# --- the K-step driver's passes, strips and segments (B4 and B7) -------

KSTEP_WIDTHS = {288: dict(c_num=6, c_space=48), 150: dict(c_num=3,
                                                          c_space=50)}


def _bulk_case(width, dtype, storage, K, seed):
    """B4's inputs on a 256-row grid of the given width: the bulk rows as
    a row range of the state, and K perturbed seam halos."""
    cfg = SimConfig(ydim=256, **KSTEP_WIDTHS[width])
    band = cfg.force_band
    f, _ = random_inputs(cfg, storage, dtype, torch.device("cuda"), seed)
    bh = f[None, :, band - 1] * (1.0 + 1e-3 * torch.arange(
        K, device=f.device, dtype=dtype)[:, None, None])
    return cfg, f, bh.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("width", sorted(KSTEP_WIDTHS))
def test_b4_shapes_match_plain_version(card, K, width):
    # K of one pass and of two (depth 8 each), at widths no strip width
    # divides (ragged last strips; at 150 one strip wraps the domain)
    cfg, f, bh = _bulk_case(width, torch.float32, "deviatoric", K, seed=K)
    walls = ref.WallSpec(top="noslip")
    band = cfg.force_band
    geo = kstep_geometry(cfg.ydim - band, 0, width, K, torch.float32)
    assert geo.hbm_passes == -(-K // 8)
    before = temporal_bulk.launches
    got = temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split",
                        "deviatoric")
    want = temporal_bulk_reference(f[:, band:], bh, cfg, walls, "trt_split",
                                   "deviatoric")
    torch.cuda.synchronize()
    assert temporal_bulk.launches == before + 1
    _check_all(got, want, [("f", GATE[torch.float32]),
                           ("flux", GATE[torch.float32])])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 5, 8, 16])
def test_b7_xsharded_shapes_match_plain_version(card, K):
    # an x-sharded block, 96 + 2 x 128 columns: the inject shard that owns
    # the flux column, held on the rows it owns above the seam
    cfg = SimConfig(**SMALL)
    band, yl, pad, xl, xpad = cfg.force_band, 64, 16, 96, 128
    f, _ = random_inputs(cfg, "deviatoric", torch.float32, card, seed=20)
    f_loc, bot, top_g, bh = _ghost_case(cfg, f, 96, yl, 0, xl, xpad, K)
    lb = band - 96
    flags = (1, 0, pad + lb, xpad + cfg.flux_x % xl, 1)
    args = (flags, f_loc, bot, top_g, bh, cfg, ref.WallSpec(), "trt_split",
            "deviatoric")
    got = ghost_temporal(*args)
    want = ghost_temporal_reference(*args)
    torch.cuda.synchronize()
    own = np.s_[:, pad + lb:pad + yl, xpad:xpad + xl]
    assert torch.isfinite(got[0][own]).all()
    assert rel_l2(got[0][own], want[0][own]) <= GATE[torch.float32]
    assert rel_l2(got[1], want[1]) <= GATE[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B4", "B7"])
def test_kstep_f64_two_passes_match_plain_version(card, kernel):
    # f64 at K = 16: two passes of 8 through the scratch block, the
    # shared-memory choice of f64 (Wc = 89)
    K, dt = 16, torch.float64
    walls = ref.WallSpec(top="slip")
    if kernel == "B4":
        cfg, f, bh = _bulk_case(288, dt, "raw", K, seed=21)
        band = cfg.force_band
        got = temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split", "raw")
        want = temporal_bulk_reference(f[:, band:], bh, cfg, walls,
                                       "trt_split", "raw")
        torch.cuda.synchronize()
        _check_all(got, want, [("f", GATE[dt]), ("flux", GATE[dt])])
        return
    cfg = SimConfig(**SMALL)
    band, yl, pad, xl, xpad = cfg.force_band, 64, 16, 96, 128
    f, _ = random_inputs(cfg, "raw", dt, card, seed=22)
    f_loc, bot, top_g, bh = _ghost_case(cfg, f, 192, yl, 0, xl, xpad, K)
    flags = (0, 1, pad, xpad + cfg.flux_x % xl, 1)
    args = (flags, f_loc, bot, top_g, bh, cfg, walls, "trt_split", "raw")
    assert kstep_geometry(yl, pad, xl + 2 * xpad, K, dt).hbm_passes == 2
    got = ghost_temporal(*args)
    want = ghost_temporal_reference(*args)
    torch.cuda.synchronize()
    own = np.s_[:, pad:pad + yl, xpad:xpad + xl]
    assert rel_l2(got[0][own], want[0][own]) <= GATE[dt]
    assert rel_l2(got[1], want[1]) <= GATE[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [5, 16])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b4_is_k_launches_of_b3(card, K, dtype, storage, top):
    # the old arithmetic: B3 with flags (band, 0, 1), the seam halo as its
    # bottom halo row, launched K times; B4's f bit for bit
    cfg, f, bh = _bulk_case(288, dtype, storage, K, seed=23)
    walls = ref.WallSpec(top=top)
    band = cfg.force_band
    b4 = temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split", storage)
    cur = f[:, band:]
    for s in range(K):
        cur = sharded_fused_substep((band, 0, 1), cur, None, bh[s], None,
                                    cfg, walls, "trt_split", storage)[0]
    assert torch.equal(b4[0], cur)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [0, -1])
@pytest.mark.parametrize("ydim", [197, 230])
@pytest.mark.parametrize("K", [5, 16])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b4_row_paths_are_k_launches_of_b3(card, K, ydim, edge, dtype,
                                           storage, top):
    # the K-step kernel's row loop, unrolled by its ring's period, takes a
    # fast path on plain rows and the full one on the seam, the top wall
    # and the rows outside the block; the flux lane sums on either.  Bulk
    # heights whose segments end at more than one phase of the unrolled
    # loop, K of one pass and of two, the flux column the first output
    # column of the second strip (edge 0) or the last of the first (-1):
    # f bit for bit K launches of B3, the flux the plain version's
    cfg = SimConfig(c_num=6, c_space=48, ydim=ydim)
    rows = ydim - cfg.force_band
    geo = kstep_geometry(rows, 0, cfg.xdim, K, dtype)
    assert {(y1 - y0 + 3 * p.kp) % 4 for p in geo.passes
            for y0, y1 in p.segments(rows)} != {0}
    flux_x = geo.passes[0].wt + edge
    cfg = dataclasses.replace(cfg, flux_column_offset=cfg.xdim - flux_x)
    assert cfg.flux_x == flux_x
    band = cfg.force_band
    f, _ = random_inputs(cfg, storage, dtype, card, seed=K + ydim)
    bh = (f[None, :, band - 1] * (1.0 + 1e-3 * torch.arange(
        K, device=card, dtype=dtype)[:, None, None])).contiguous()
    walls = ref.WallSpec(top=top)
    b4, flux = temporal_bulk(f[:, band:], bh, cfg, walls, "trt_split",
                             storage)
    cur = f[:, band:]
    for s in range(K):
        cur = sharded_fused_substep((band, 0, 1), cur, None, bh[s], None,
                                    cfg, walls, "trt_split", storage)[0]
    want = temporal_bulk_reference(f[:, band:], bh, cfg, walls, "trt_split",
                                   storage)[1]
    torch.cuda.synchronize()
    assert torch.equal(b4, cur)
    assert rel_l2(flux, want) <= GATE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 16])
def test_b7_nan_ghosts_keep_owned_cells(card, K):
    # NaN in the ghost rows (sealed: the seam at the bottom owned row, the
    # top wall at the top one) and in the ghost columns farther than K from
    # the owned ones: the owned cells stay finite and equal the plain
    # version's on the same inputs
    cfg = SimConfig(**SMALL)
    band, yl, pad, xl, xpad = cfg.force_band, 128, 16, 96, 128
    f, _ = random_inputs(cfg, "deviatoric", torch.float32, card, seed=24)
    f_loc, bot, top_g, bh = _ghost_case(cfg, f, band, yl, 0, xl, xpad, K)
    f_loc = f_loc.clone()
    f_loc[:, :, :xpad - K] = float("nan")
    f_loc[:, :, xpad + xl + K:] = float("nan")
    bot = torch.full_like(bot, float("nan"))
    top_g = torch.full_like(top_g, float("nan"))
    flags = (1, 1, pad, xpad + cfg.flux_x % xl, 1)
    args = (flags, f_loc, bot, top_g, bh, cfg, ref.WallSpec(), "trt_split",
            "deviatoric")
    got = ghost_temporal(*args)
    want = ghost_temporal_reference(*args)
    torch.cuda.synchronize()
    own = np.s_[:, pad:pad + yl, xpad:xpad + xl]
    assert torch.isfinite(got[0][own]).all() and torch.isfinite(got[1]).all()
    assert rel_l2(got[0][own], want[0][own]) <= GATE[torch.float32]
    assert rel_l2(got[1], want[1]) <= GATE[torch.float32]


# The K-step kernel's mbarriers, case by case in a worker process
# (tests/_kstep_sync.py) under a time limit, so that a wait no neighbour
# ever ends fails its case instead of hanging the suite: segments of one
# row and shorter than the ring, a ragged last strip and segment, pass
# depths 1, 3, 5 and 8, one pass and two, bf16 storage, B7 with NaN
# ghosts.
KSTEP_SYNC_CASES = {
    "one_row_segments": dict(kernel="B4", dtype="float32",
                             storage="deviatoric", top="noslip", width=288,
                             ydim=197, K=5, ly=1),
    "segments_shorter_than_the_ring": dict(
        kernel="B4", dtype="float64", storage="raw", top="slip", width=150,
        ydim=230, K=16, ly=3),
    "ragged_strip_and_segment": dict(kernel="B4", dtype="float32",
                                     storage="deviatoric", top="slip",
                                     width=150, ydim=197, K=16, ly=10),
    "depth_1": dict(kernel="B4", dtype="float32", storage="deviatoric",
                    top="slip", width=288, ydim=230, K=1),
    "depth_3": dict(kernel="B4", dtype="float64", storage="raw",
                    top="noslip", width=150, ydim=197, K=3),
    "depth_8_one_pass": dict(kernel="B4", dtype="float32",
                             storage="deviatoric", top="slip", width=288,
                             ydim=256, K=8),
    "two_passes_of_8": dict(kernel="B4", dtype="float64", storage="raw",
                            top="noslip", width=288, ydim=256, K=16),
    "bf16_two_passes": dict(kernel="B4", dtype="bfloat16",
                            storage="deviatoric", top="slip", width=150,
                            ydim=230, K=16),
    "b7_nan_ghosts": dict(kernel="B7", dtype="float32",
                          storage="deviatoric", K=16),
    "b7_nan_ghosts_depth_5": dict(kernel="B7", dtype="float64",
                                  storage="raw", K=5),
}
KSTEP_SYNC_LIMIT_S = 120   # a case's time, the worker's start included


@pytest.fixture(scope="module")
def kstep_worker():
    """The worker process's pool, shut down after the module; a case that
    hangs kills the worker and empties the list, and the next case starts
    another."""
    pools = []
    yield pools
    for pool in pools:
        pool.shutdown(cancel_futures=True)


def _kstep_sync_result(pools, spec):
    """run_case(spec) in the worker process, or fail the test if it gives
    no result within KSTEP_SYNC_LIMIT_S (the worker is then killed)."""
    import concurrent.futures
    import multiprocessing

    import _kstep_sync
    from cuda_iblb_11_tpu_torch.ops import _kernels

    _kernels.load()   # built here, so the worker only loads it
    if not pools:
        pools.append(concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")))
    fut = pools[0].submit(_kstep_sync.run_case, spec)
    try:
        return fut.result(timeout=KSTEP_SYNC_LIMIT_S)
    except concurrent.futures.TimeoutError:
        pool = pools.pop()
        for proc in list(pool._processes.values()):
            proc.kill()
        pool.shutdown(wait=False, cancel_futures=True)
        pytest.fail(f"no result in {KSTEP_SYNC_LIMIT_S} s: the K-step "
                    f"kernel hangs on {spec}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KSTEP_SYNC_CASES))
def test_kstep_mbarriers_are_k_launches_of_b3(card, kstep_worker, case):
    spec = KSTEP_SYNC_CASES[case]
    res = _kstep_sync_result(kstep_worker, spec)
    if "ly" in spec:
        assert set(res["ly"]) == {spec["ly"]}
    assert res["finite"]
    assert res["flux_rel"] <= res["gate"]
    if spec["kernel"] == "B7":
        assert res["owned_is_short_segments_with_finite_ghosts"]
        assert res["f_rel"] <= res["gate"]
        return
    assert res["f_is_k_launches_of_b3"]
    if spec["dtype"] == "bfloat16":
        assert res["bf16_is_f32_rounded"] and res["bf16_flux_is_f32"]
    if case == "segments_shorter_than_the_ring":
        assert max(res["segment_rows"]) < 4
    if case == "ragged_strip_and_segment":
        assert len(res["segment_rows"]) > 1 and len(res["strip_cols"]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("c_num,n_x", [(16, 2), (10, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b8_matches_plain_version(card, c_num, n_x, dtype):
    # the uniform layout (xl a c_space multiple) and the phase-general one
    cfg = SimConfig(c_num=c_num, c_space=128 if n_x == 2 else 256,
                    ydim=256, dtype=str(dtype).split(".")[-1])
    K = 4
    storage = cfg.storage_resolved
    xl = cfg.xdim // n_x
    lay = xshard_layout(cfg, 8, K, ref.REFERENCE_WALLS, dtype, xl, n_x)
    assert lay.phase_general == (xl % cfg.c_space != 0)
    f, force = random_inputs(cfg, storage, dtype, card, seed=11)
    sim = MucociliarySim(cfg, backend="torch", device=card, dtype=dtype)
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(137, K)
    xs = [x[0] for x in prep_band_super_points(
        cfg, K, lay.halo, dtype, u_s, eps, anchor, frac, 1)]
    g, gi = (1e-6, 1e-5) if dtype == torch.float32 else (1e-12, 1e-11)
    for ix in range(n_x):
        cols = torch.arange(ix * xl - lay.gx, (ix + 1) * xl + lay.gx,
                            device=card) % cfg.xdim
        f_ext = f[:, :cfg.force_band + 8][:, :, cols].contiguous()
        fo = force[:, :, cols].contiguous()
        pts = shard_points(lay, xs, cfg, ix, xl)
        owned = ix * xl <= cfg.flux_x < (ix + 1) * xl
        flags = (cfg.flux_x - ix * xl + lay.gx if owned else 0, int(owned))
        before = band_super_xsharded.launches
        args = (flags, f_ext, fo, *pts, cfg, lay, ref.REFERENCE_WALLS,
                "trt_split", storage)
        got = band_super_xsharded(*args)
        want = band_super_xsharded_reference(*args)
        torch.cuda.synchronize()
        assert band_super_xsharded.launches == before + 1
        _check_all(got[:3], want[:3], [("f_band", g), ("bhalos", g),
                                       ("force", gi)])
        if owned:
            assert rel_l2(got[3], want[3]) <= gi
        else:
            assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,K,leg", [
    ((2, 1), 1, "sharded_per_step"), ((2, 2), 1, "sharded_per_step"),
    ((2, 1), 4, "band_super_whole"), ((2, 2), 4, "per_substep_tiled"),
    ((1, 2), 4, "band_super_xsharded")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_cuda_matches_torch_backend(card, mesh, K, leg, dtype):
    # every shard on the one card: the kernels against their plain
    # versions through the whole sharded path, 2 K + 2 steps; B0 launches
    # once per exchange: per step, and per band sub-step on the
    # per-sub-step leg of an x-sharded mesh (the two remainder steps of
    # the temporal legs are per-step exchanges)
    cfg = SimConfig(c_num=16 if leg == "band_super_xsharded" else 3,
                    c_space=128, ydim=256, dtype=dtype)
    m = make_mesh(*mesh, devices=[card])
    wrappers = (collide_slabs, sharded_fused_substep, ghost_temporal,
                band_super, band_super_xsharded)
    b0 = 2 * K + 2 if leg in ("sharded_per_step", "per_substep_tiled") \
        else 2
    states = {}
    for backend in ("cuda", "torch"):
        sim = (ShardedPallasSim(cfg, m, backend=backend) if K == 1 else
               ShardedTemporalSim(cfg, m, temporal=K, backend=backend))
        assert sim.resolved_config()["band_leg"] == leg
        n0 = [w.launches for w in wrappers]
        st = sim.run_chunk(sim.init_state(), 2 * K + 2)
        launched = [w.launches - a for w, a in zip(wrappers, n0)]
        assert (sum(launched) > 0) == (backend == "cuda"), launched
        assert launched[0] == (b0 if backend == "cuda" else 0), launched
        states[backend] = (sim, st)
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q)) + 1e-30


@pytest.mark.cuda
def test_mesh_8192_takes_b8_and_matches_single_device(card):
    # 8192^2 with 64 cilia on (2, 2), every shard on the card: the plan
    # takes B8 on the 5,120-column block (no budget), within 1e-5 of the
    # single-device auto run after 32 steps
    cfg = SimConfig(c_num=64, c_space=128, ydim=8192)
    msim = ShardedTemporalSim(cfg, make_mesh(2, 2, devices=[card]),
                              temporal=16)
    assert msim.resolved_config()["band_leg"] == "band_super_xsharded"
    single = MucociliarySim(cfg, device=card, temporal="auto")
    assert single.plan.band_leg == "band_super_whole"
    n0 = (band_super_xsharded.launches, ghost_temporal.launches,
          collide_slabs.launches)
    a = msim.run_chunk(msim.init_state(), 32)
    assert (band_super_xsharded.launches - n0[0], ghost_temporal.launches
            - n0[1], collide_slabs.launches - n0[2]) == (4, 8, 0)
    b = single.run_chunk(single.init_state(), 32)
    ua, ub = msim.fields(a)[1], single.fields(b)[1]
    assert torch.isfinite(ua).all()
    assert rel_l2(ua, ub) <= 1e-5
    assert abs(float(a.q) - float(b.q)) <= 1e-5 * abs(float(b.q))


# Meshes at the benchmark's sizes, every shard on the one card, through
# the runner's mesh resolution: (grid, mesh, temporal, the plan held to
# the card's L2 size, steps, ib_x_edge, dtype, band leg, launches per
# exchange: a super-step, or a step at temporal 1)
MESHES_AT_SIZE = {
    "2048x2048 (2, 2) auto": ("2048x2048", (2, 2), "auto", False, 64,
                              "periodic", "float32", "band_super_xsharded",
                              {"B8": 2, "B7": 4}),
    "2048x2048 (2, 1) auto": ("2048x2048", (2, 1), "auto", False, 64,
                              "periodic", "float32", "band_super_whole",
                              {"B5": 1, "B7": 2}),
    "2048x2048 (2, 2) temporal 1": ("2048x2048", (2, 2), 1, False, 64,
                                    "periodic", "float32",
                                    "sharded_per_step", {"B3": 4, "B0": 1}),
    "8192x8192 (2, 2) on the budgeted plan": (
        "8192x8192", (2, 2), "auto", True, 32, "periodic", "float32",
        "per_substep_tiled", {"B3": 32, "B0": 16, "B7": 4}),
    "quirk 2048x2048 (2, 2) temporal 1": (
        "2048x2048", (2, 2), 1, False, 64, "reference", "float32",
        "sharded_per_step", {"B3": 4, "B0": 1}),
    "quirk 2048x2048 (2, 2) auto": (
        "2048x2048", (2, 2), "auto", False, 64, "reference", "float32",
        "per_substep_tiled", {"B3": 32, "B0": 16, "B7": 4}),
    "quirk f64 2048x2048 (2, 2) temporal 1": (
        "2048x2048", (2, 2), 1, False, 16, "reference", "float64",
        "sharded_per_step", {"B3": 4, "B0": 1}),
    "bf16 2048x2048 (2, 2) auto": ("2048x2048", (2, 2), "auto", False, 64,
                                   "periodic", "bfloat16",
                                   "band_super_xsharded", {"B8": 2, "B7": 4}),
    "bf16 2048x2048 (2, 1) auto": ("2048x2048", (2, 1), "auto", False, 64,
                                   "periodic", "bfloat16",
                                   "band_super_whole", {"B5": 1, "B7": 2}),
    "bf16 2048x2048 (2, 2) temporal 1": (
        "2048x2048", (2, 2), 1, False, 64, "periodic", "bfloat16",
        "sharded_per_step", {"B3": 4, "B0": 1}),
    "bf16 8192x8192 (2, 2) auto": ("8192x8192", (2, 2), "auto", False, 32,
                                   "periodic", "bfloat16",
                                   "band_super_xsharded", {"B8": 2, "B7": 4}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(MESHES_AT_SIZE))
def test_mesh_at_size_matches_single_device(card, label):
    # against the single-device run at the same temporal: f32 velocity
    # and flux within 1e-5, f64 velocity within 1e-12.  bf16: one call
    # from the single-device run's end at least 99.9% bit-equal and
    # within one floored ulp; after the run the velocity less than half
    # as far from the single-device bf16 run as that is from f32 (at
    # temporal 1, whose IB reads the stored bf16 f as JAX's mesh does
    # where the single-device step reads B2's f32 planes: one call is
    # bit-equal, but the IB feedback carries the moments' rounding on to
    # bf16's own distance within the run, so within twice it)
    from cuda_iblb_11_tpu_torch.ops.probes import l2_bytes
    from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded
    from cuda_iblb_11_tpu_torch.runner import _make_mesh_sim

    (grid, mesh, temporal, budgeted, steps, ib_x_edge, dtype, leg,
     per_exchange) = MESHES_AT_SIZE[label]
    k = 16 if temporal == "auto" else temporal
    cfg = SimConfig(dtype=dtype, **SIZES[grid])
    msim = _make_mesh_sim(cfg, "auto", "trt_split", temporal,
                          f"{mesh[0]},{mesh[1]}", ib_x_edge, "no_mucus",
                          card)
    if budgeted:
        # auto plans no budget and takes B8 there
        msim.plan = plan_sharded(cfg, k, *mesh, msim.walls, msim.dtype,
                                 budget=l2_bytes(card))
        msim._kernel_path = msim.plan.band_leg
    single = MucociliarySim(cfg, backend="cuda", device=card,
                            temporal=temporal, ib_x_edge=ib_x_edge)
    rc = msim.resolved_config()
    assert (rc["band_leg"], rc["temporal"], rc["backend"], rc["dtype"]) == \
        (leg, k, "cuda", dtype)
    assert (rc["ib_path"] == "stencil_quirk") == (ib_x_edge == "reference")
    a, n = counted(msim.run_chunk, msim.init_state(), steps)
    assert n == {kk: v * (steps // k) for kk, v in per_exchange.items()}, n
    b = single.run_chunk(single.init_state(), steps)
    ua, ub = msim.fields(a)[1], single.fields(b)[1]
    assert torch.isfinite(ua).all()
    if dtype == "float64":
        assert rel_l2(ua, ub) <= 1e-12
        return
    if dtype == "float32":
        assert rel_l2(ua, ub) <= 1e-5
        assert abs(float(a.q) - float(b.q)) <= 1e-5 * abs(float(b.q))
        return
    one = msim.gather_state(msim.run_chunk(msim.place_state(b), k))
    share, _, floored = bf16_agreement(one.f, single.run_chunk(b, k).f)
    assert share >= 0.999 and floored <= 1.0, (share, floored)
    s32 = MucociliarySim(cfg.replace(dtype="float32"), backend="cuda",
                         device=card, temporal=temporal)
    u32 = s32.fields(s32.run_chunk(s32.init_state(), steps))[1]
    bound = 2.0 if temporal == 1 else 0.5
    assert rel_l2(ua, ub) <= bound * rel_l2(ub, u32)


# --- B2h, the quirk mode, the channel ------------------------------------

B2H_GRIDS = {   # (xdim, ydim, force band or None for the whole height)
    "width8_channel": (8, 32, None), "width16_channel": (16, 32, None),
    "width16_band": (16, 40, 16), "ragged_150x61": (150, 61, 40),
    "channel_288x192": (288, 192, 128), "whole_288x192": (288, 192, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", sorted(B2H_GRIDS))
@pytest.mark.parametrize("dtype,storage,forcing,top", CASES)
def test_b2h_matches_plain_version(card, grid, dtype, storage, forcing, top):
    xdim, ydim, band = B2H_GRIDS[grid]
    cfg = SimConfig(c_num=1, c_space=xdim, ydim=ydim, length=4)
    f, _ = random_inputs(cfg, storage, dtype, card, seed=12)
    rng = np.random.default_rng(13)
    force = torch.from_numpy(1e-4 * rng.standard_normal(
        (2, band or ydim, xdim))).to(card, dtype)
    walls = ref.WallSpec(top=top)
    args = (f, force, cfg.tau, cfg.tau2, walls, forcing, storage)
    before = collide_stream.launches
    got = collide_stream(*args)
    want = collide_stream_reference(*args)
    torch.cuda.synchronize()
    assert collide_stream.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_l2(got, want) <= GATE[dtype]


@pytest.mark.cuda
def test_b2h_is_b2_without_emission(card):
    # the same step kernel: B2h's f equals B2's bit for bit
    cfg = SimConfig(**GRIDS["channel_288x192"])
    for dtype, storage, forcing, top in CASES:
        f, force = random_inputs(cfg, storage, dtype, card, seed=14)
        walls = ref.WallSpec(top=top)
        b2 = fused_substep(f, force, cfg, walls, forcing, storage)[0]
        b2h = collide_stream(f, force, cfg.tau, cfg.tau2, walls, forcing,
                             storage)
        assert torch.equal(b2, b2h)


@pytest.mark.cuda
def test_b2h_wrapper_refuses_bad_inputs(card):
    cfg = SimConfig(**GRIDS["band_below_ydim"])
    f, force = random_inputs(cfg, "raw", torch.float32, card)
    n = collide_stream.launches
    tau = (cfg.tau, cfg.tau2)
    with pytest.raises(ValueError, match="alias"):
        collide_stream(f, force, *tau, out=f)
    with pytest.raises(ValueError, match="band"):      # band > ydim
        collide_stream(f, torch.zeros((2, cfg.ydim + 8, cfg.xdim),
                                      device=card), *tau)
    with pytest.raises(ValueError):                     # force dtype
        collide_stream(f, force.double(), *tau)
    with pytest.raises(ValueError, match="contiguous"):
        collide_stream(f.transpose(1, 2).contiguous().transpose(1, 2),
                       force, *tau)
    with pytest.raises(NotImplementedError):
        collide_stream(f.half(), force.half(), *tau, storage="deviatoric")
    with pytest.raises(NotImplementedError):
        collide_stream(f, force, *tau, ref.WallSpec(top="moving"))
    assert collide_stream.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("grid,temporal,dtype,steps", [
    ("288x192", 1, "float32", 6), ("288x192", 4, "float32", 15),
    ("288x192", 1, "float64", 6), ("288x192", 4, "float64", 15),
    ("2048x2048", 1, "float32", 512)])
def test_quirk_cuda_matches_torch_backend(card, grid, temporal, dtype,
                                          steps):
    # 3 super-steps and 3 single steps at temporal 4
    cfg = SimConfig(dtype=dtype, **SIZES.get(grid, dict(c_num=6,
                                                        c_space=48)))
    states = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card,
                             temporal=temporal, ib_x_edge="reference")
        assert sim.resolved_config()["ib_path"] == "stencil_quirk"
        n0 = (collide_stream.launches, sharded_fused_substep.launches,
              temporal_bulk.launches, fused_substep.launches)
        states[backend] = (sim, sim.run_chunk(sim.init_state(), steps))
        n1 = (collide_stream.launches, sharded_fused_substep.launches,
              temporal_bulk.launches, fused_substep.launches)
        launched = tuple(b - a for a, b in zip(n0, n1))
        if backend == "torch":
            assert launched == (0, 0, 0, 0)
        elif temporal == 1:
            assert launched == (steps, 0, 0, 0)
        else:
            assert launched == (3, 3 * temporal, 3, 0)
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q))


@pytest.mark.cuda
def test_quirk_f64_cuda_matches_torch_backend_at_2048(card):
    # the f64 witness of the quirk path's kernel-vs-torch gap: B2h and the
    # stencil IB on the card against the plain path, 64 single steps at
    # 2048^2 with 16 cilia; round-off only leaves about 1e-15
    cfg = SimConfig(c_num=16, c_space=128, ydim=2048, dtype="float64")
    u = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card, temporal=1,
                             ib_x_edge="reference")
        u[backend] = sim.fields(sim.run_chunk(sim.init_state(), 64))[1]
    assert torch.isfinite(u["cuda"]).all()
    assert rel_l2(u["cuda"], u["torch"]) <= 1e-12


@pytest.mark.cuda
def test_quirk_runs_are_bit_identical(card):
    # no atomics in the spread: two runs give the same bits
    cfg = SimConfig(c_num=6, c_space=48)
    runs = []
    for _ in range(2):
        sim = MucociliarySim(cfg, device=card, temporal="auto",
                             ib_x_edge="reference")
        assert sim.resolved_config()["band_leg"] == "per_substep"
        runs.append(sim.run_chunk(sim.init_state(), 2 * sim.temporal + 3))
    assert torch.equal(runs[0].f, runs[1].f)
    assert torch.equal(runs[0].force, runs[1].force)
    assert torch.equal(runs[0].q, runs[1].q)


@pytest.mark.cuda
@pytest.mark.parametrize("xdim", [8, 16])
def test_channel_on_the_card_matches_the_cpu(card, xdim):
    # f64 through B2h against the plain version on the CPU: f at the f64
    # gate; the profile, a velocity of ~1e-4 taken from populations of
    # ~0.1, carries their round-off 1e3 times larger
    steps = 300
    got = {}
    for dev in (card, "cpu"):
        ch = PoiseuilleChannel(xdim, 32, tau=0.8, device=dev)
        before = collide_stream.launches
        f = ch.run(ch.init_f(), steps)
        assert collide_stream.launches - before == (
            steps if dev == card else 0)
        got[str(dev)] = (f.cpu(), ch.profile(f).cpu())
    (fa, pa), (fb, pb) = got[str(card)], got["cpu"]
    assert rel_l2(fa, fb) <= 1e-12
    assert rel_l2(pa, pb) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,storage", [(torch.float64, "raw"),
                                           (torch.float32, "deviatoric")])
def test_channel_on_the_card_meets_the_analytic_profile(card, dtype,
                                                        storage):
    # 16 x 32, 8,000 steps, each one B2h launch
    ch = PoiseuilleChannel(16, 32, tau=1.0, dtype=dtype, device=card,
                           storage=storage)
    f, n = counted(ch.run, ch.init_f(), 8000)
    assert n == {"B2h": 8000}
    got = ch.profile(f).double().cpu().numpy()
    want = ch.analytic_profile()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-3


@pytest.mark.cuda
def test_channel_2048_b2h_matches_plain_version(card):
    # 2048^2 with the force over the whole height, 512 steps: B2h against
    # the plain version in f64 raw, f at 1e-12 (a wrong force row or wall
    # at band = ydim fails it).  In f32 deviatoric the flow, the same in
    # every column, grows steadily from rest, so round-off accumulates
    # coherently (1.5e-5 to 2.2e-5 from f64 after 512 steps): B2h no
    # farther from the f64 run than the plain version, and within 1e-5
    # of it
    from cuda_iblb_11_tpu_torch.models import channel

    f64, u = {}, {}
    for label, dtype, storage in (("B2h", torch.float32, "deviatoric"),
                                  ("plain", torch.float32, "deviatoric"),
                                  ("B2h f64", torch.float64, "raw"),
                                  ("plain f64", torch.float64, "raw")):
        ch = PoiseuilleChannel(2048, 2048, tau=1.0, body_force=1e-6,
                               dtype=dtype, device=card, storage=storage)
        f = ch.init_f()
        if label.startswith("plain"):
            for _ in range(512):
                f = collide_stream_reference(f, ch.force, ch.tau, ch.tau2,
                                             ch.walls, channel.FORCING,
                                             ch.storage)
        else:
            f, n = counted(ch.run, f, 512)
            assert n == {"B2h": 512}
        u[label] = ch.profile(f).double()
        if dtype == torch.float64:
            f64[label] = f
        del f, ch
    assert rel_l2(f64["B2h f64"], f64["plain f64"]) <= 1e-12
    assert rel_l2(u["B2h"], u["B2h f64"]) <= rel_l2(u["plain"], u["B2h f64"])
    assert rel_l2(u["B2h"], u["plain"]) <= 1e-5


GHIA_X = (0.0703, 0.2344, 0.5000, 0.8047, 0.9063, 0.9453)
GHIA_UY = (0.10091, 0.17527, 0.05454, -0.24533, -0.16914, -0.10313)


@pytest.mark.cuda
def test_cavity_on_the_card_against_ghia(card):
    # 64^2 at Re 100, 30,000 plain torch steps on the card (about a
    # minute): u_x on the vertical centreline within validate_cavity's
    # 0.02 lid units of Ghia, Ghia & Shin (1982), u_y on the horizontal
    # one within 0.025
    from cuda_iblb_11_tpu_torch import validate_cavity as vc
    from cuda_iblb_11_tpu_torch.models.cavity import LidDrivenCavity

    cav = LidDrivenCavity(64, 100.0, vc.U_LID, device=card)
    f = cav.run(cav.init_f(), 30000)
    ux, uy = (u.double().cpu().numpy() for u in cav.centreline_profiles(f))
    assert np.isfinite(ux).all() and np.isfinite(uy).all()
    pos = (np.arange(cav.n) + 0.5) / cav.n
    gy, gux = vc.GHIA[100]
    assert np.abs(np.interp(gy, pos, ux) - gux).max() <= vc.GATES[100]
    assert np.abs(np.interp(GHIA_X, pos, uy) - GHIA_UY).max() <= 0.025


# --- P1-P3 ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("threads,blocks", [(256, None), (1024, None),
                                            (128, 264)])
def test_p2_copy_and_scale_bit_for_bit(card, threads, blocks):
    x = torch.rand((9, 64, 96), device=card) + 0.5
    for scale in (False, True):
        want = probes.probe_copy_reference(x, scale)
        before = probes.probe_copy.launches
        got = probes.probe_copy(x, scale, out=torch.full_like(x, torch.nan),
                                threads=threads, blocks=blocks)
        y = x.clone()
        probes.probe_copy(y, scale, out=y, threads=threads, blocks=blocks)
        torch.cuda.synchronize()
        assert probes.probe_copy.launches == before + 2
        assert torch.equal(got, want) and torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,depth", [(1024, 2), (4096, 3), (65536, 2)])
def test_p3_ring_copy_bit_for_bit(card, tile, depth):
    x = torch.rand((9, 64, 256), device=card)     # 576 KiB: whole tiles
    before = probes.probe_ring_copy.launches
    out = torch.full_like(x, float("nan"))
    got = probes.probe_ring_copy(x, tile, depth, out=out)
    torch.cuda.synchronize()
    assert probes.probe_ring_copy.launches == before + 1
    assert torch.equal(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,depth", [(1024, 2), (1024, 3), (4096, 3),
                                        (65536, 2), (65536, 3)])
def test_p3_ring_wraps_over_many_tiles_per_block(card, tile, depth):
    # 64 MiB plus one tile: every block but the last streams its run of
    # tiles and the last copies the one tile left.  The default run
    # (RING_RUN) wraps each ring; a run of 8 tiles, more than 2 x depth,
    # refills every stage after its store has read it at least twice, so
    # each stage's mbarrier parity flips both ways
    long_run = 8
    assert probes.RING_RUN > depth and long_run > 2 * depth
    n = (64 << 20) // 4 + tile // 4
    g = torch.Generator(device=card).manual_seed(tile + depth)
    x = torch.rand(n, generator=g, device=card)
    for run in (probes.RING_RUN, long_run):
        assert (n * 4 // tile) % run == 1
        out = torch.full_like(x, float("nan"))
        before = probes.probe_ring_copy.launches
        probes.probe_ring_copy(x, tile, depth, out=out, run=run)
        torch.cuda.synchronize()
        assert probes.probe_ring_copy.launches == before + 1
        assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
def test_p3_ring_tiles_not_dividing_by_the_grid(card, depth):
    # 8,191 tiles, a prime: no run of tiles a block divides it, and the
    # last block's ring ends before it is full
    tile = 4096
    g = torch.Generator(device=card).manual_seed(depth)
    x = torch.rand(8191 * tile // 4, generator=g, device=card)
    out = torch.full_like(x, float("nan"))
    before = probes.probe_ring_copy.launches
    probes.probe_ring_copy(x, tile, depth, out=out)
    torch.cuda.synchronize()
    assert probes.probe_ring_copy.launches == before + 1
    assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [1, 3, 4, 16])
@pytest.mark.parametrize("depth", [2, 3])
def test_p3_ring_run_lengths_copy_bit_for_bit(card, run, depth):
    # probe_bw's run-length sweep: runs shorter than the ring, equal to
    # it and longer; 1,001 tiles leave every run a partial last block
    tile = 8192
    g = torch.Generator(device=card).manual_seed(run * 4 + depth)
    x = torch.rand(1001 * tile // 4, generator=g, device=card)
    out = torch.full_like(x, float("nan"))
    before = probes.probe_ring_copy.launches
    probes.probe_ring_copy(x, tile, depth, out=out, run=run)
    torch.cuda.synchronize()
    assert probes.probe_ring_copy.launches == before + 1
    assert torch.equal(out, x)


@pytest.mark.cuda
def test_launch_floor_is_positive_and_small(card):
    ms = probes.launch_floor_ms(count=400, device=card)
    assert 0.0 < ms < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("op", probes.CHAIN_OPS)
def test_p1_chain_matches_plain_version(card, op):
    # up to probe_vpu's longer chain (R2 links) on its shape
    from cuda_iblb_11_tpu_torch import probe_vpu

    g = torch.Generator(device=card).manual_seed(3)
    x = 0.5 + torch.rand(probe_vpu.SHAPE, generator=g, device=card)
    before = probes.probe_chain.launches
    for reps in (0, 7, 450, probe_vpu.R2):
        got = probes.probe_chain(x, reps, op)
        want = probes.probe_chain_reference(x, reps, op)
        torch.cuda.synchronize()
        assert torch.equal(got, want)   # fmaf and the f64 link round once
    assert probes.probe_chain.launches == before + 4


@pytest.mark.cuda
def test_probes_run_on_the_card(card):
    # probe_bw's and probe_vpu's own runs: every P2 and P3 pattern on the
    # 151 MB state bit for bit its plain version (into NaN), and each
    # rate measured
    from cuda_iblb_11_tpu_torch import probe_bw, probe_vpu

    bw = probe_bw.measure(reps=1)
    errs = bw["max_abs_err_vs_plain"]
    assert errs and all(e == 0.0 for e in errs.values()), errs
    assert all(row["median_gbs"] > 0 for row in bw["patterns"].values())
    vpu = probe_vpu.measure(steps=512)
    assert all(tf > 0 for tf in vpu["tflops_by_op"].values())
    assert vpu["port_2048"]["mlups"] > 0


@pytest.mark.cuda
def test_probe_wrappers_refuse_bad_inputs(card):
    x = torch.rand((9, 64, 96), device=card)
    n = (probes.probe_copy.launches, probes.probe_ring_copy.launches,
         probes.probe_chain.launches)
    flat = x.view(-1)
    with pytest.raises(ValueError, match="alias"):     # partial overlap
        probes.probe_copy(flat[:4096], out=flat[2048:6144])
    with pytest.raises(ValueError, match="float32"):
        probes.probe_copy(x.double())
    with pytest.raises(ValueError, match="float4"):
        probes.probe_copy(torch.rand(6, device=card))
    with pytest.raises(ValueError, match="alias"):     # the ring reads ahead
        probes.probe_ring_copy(x, 1024, 2, out=x)
    with pytest.raises(ValueError, match="depth"):
        probes.probe_ring_copy(x, 1024, 4)
    with pytest.raises(ValueError, match="tile"):
        probes.probe_ring_copy(x, 1000, 2)
    with pytest.raises(ValueError, match="float32"):
        probes.probe_chain(x.double(), 10)
    assert (probes.probe_copy.launches, probes.probe_ring_copy.launches,
            probes.probe_chain.launches) == n


# --- the reference's experiments (sweep_metachrony.py, validate_flux.py)

@pytest.mark.cuda
def test_sweep_point_f32_against_f64_with_exact_launches(card):
    # two 2048^2 points (16 cilia, c_fraction 4 and 16) over 4,000 steps
    # in 2 chunks on the whole band super-step: 250 B5 and 250 B4
    # launches and no other kernel, f32 within 2e-4 of f64 (1.1e-5 and
    # 3.0e-5 on the card), and the two points' Q farther apart than that
    from cuda_iblb_11_tpu_torch import sweep_metachrony as sm

    q = {}
    for cf in (4, 16):
        for dt in ("float32", "float64"):
            p, n = counted(sm.run_point, cf, dt, card, steps=4000, chunks=2)
            assert n == {"B5": 250, "B4": 250}, n
            assert p["launches"] == {"B5 band_super": 250,
                                     "B4 temporal_bulk": 250,
                                     "B2 fused_step": 0}
            assert (p["sim"]["band_leg"], p["sim"]["temporal"]) == (
                "band_super_whole", 16)
            assert p["sim"]["backend"] == "cuda" and p["finite"]
            q[cf, dt] = p["q_per_beat"]
        assert abs(q[cf, "float32"] - q[cf, "float64"]) <= \
            2e-4 * abs(q[cf, "float64"])
    assert abs(q[4, "float64"] - q[16, "float64"]) > \
        2e-4 * abs(q[16, "float64"])


@pytest.mark.cuda
def test_sweep_point_refuses_another_path(card):
    # both refuse before a step is taken
    from cuda_iblb_11_tpu_torch import sweep_metachrony as sm

    n = (band_super.launches, temporal_bulk.launches, fused_substep.launches)
    with pytest.raises(ValueError, match="multiple of K"):
        sm.run_point(4, "float32", card, steps=520, chunks=2)
    # 192^2 with 4 cilia 48 apart: K = 16 takes the per-sub-step leg
    with pytest.raises(RuntimeError, match="per_substep"):
        sm.run_point(4, "float32", card, steps=512, chunks=2, c_num=4,
                     c_space=48, ydim=192)
    assert (band_super.launches, temporal_bulk.launches,
            fused_substep.launches) == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gate", [("float64", 1e-9),
                                        ("float32", 2e-5)])
def test_validate_flux_f64_early_curve_against_the_golden(card, dtype,
                                                          gate):
    # the reference channel on B2 at temporal 1, 2,000 steps: every
    # 100-step sample within 1e-9 (f64, raw storage) and 2e-5 (f32) of
    # the JAX f64 oracle's early curve
    from cuda_iblb_11_tpu_torch import validate_flux

    leg, n = counted(validate_flux.run_leg, dtype, 2000, 20, card)
    assert n == {"B2": 2000}
    assert leg["launches"]["B2 fused_step"] == 2000 and leg["finite"]
    assert leg["sim"]["temporal"] == 1
    if dtype == "float64":
        assert leg["sim"]["storage"] == "raw"
    rows = leg["early"]["rows"]
    assert [r["it"] for r in rows] == list(range(100, 2001, 100))
    assert leg["early"]["max_rel"] <= gate


# --- bf16 storage: the _bf16 entries ----------------------------------------

def bf16_inputs(cfg, device, seed=0):
    """Deviatoric f rounded to bf16 and an f32 band force (the model's
    dtypes under bf16 storage)."""
    f, force = random_inputs(cfg, "deviatoric", torch.float32, device, seed)
    return f.to(torch.bfloat16), force


def _check_bf16(got, want, gates):
    """f outputs (bf16): at least 99.9% bit-equal (ops/precision.
    bf16_agreement); f32 outputs at their rel-L2 gates."""
    for (name, gate), g, w in zip(gates, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        if g.dtype == torch.bfloat16:
            share, _, _ = bf16_agreement(g, w)
            assert share >= 0.999, (name, share)
        else:
            assert g.dtype == torch.float32, name
            assert rel_l2(g, w) <= gate, (name, rel_l2(g, w))


def _nan_like(t):
    return torch.full_like(t, float("nan"))


def _bf16_case(kernel, card, widen=False):
    """(wrapper, kernel call, plain call, gates, launches per call) of one
    bf16 kernel at a small size of its path, outputs into NaN buffers;
    widen=True: the same call with f widened to f32 (the f32 entry on the
    bf16 case's values)."""
    g, gi = 1e-6, 1e-5

    def inputs(cfg, seed=0):
        f, force = bf16_inputs(cfg, card, seed)
        return (f.float() if widen else f), force

    if kernel in ("B2", "B2h"):
        cfg = SimConfig(dtype="bfloat16", **GRIDS["channel_288x192"])
        f, force = inputs(cfg)
        walls = ref.WallSpec(top="slip")
        out = _nan_like(f)
        if kernel == "B2":
            args = (f, force, cfg, walls, "trt_split", "deviatoric")
            return (fused_substep, lambda: fused_substep(*args, out=out),
                    lambda: fused_substep_reference(*args),
                    [("f", g), ("q", g), ("fluxcol", g)], 1)
        args = (f, force, cfg.tau, cfg.tau2, walls, "trt_split",
                "deviatoric")
        return (collide_stream, lambda: (collide_stream(*args, out=out),),
                lambda: (collide_stream_reference(*args),), [("f", g)], 1)
    if kernel == "B3":
        cfg = SimConfig(dtype="bfloat16", **SMALL)
        band = cfg.force_band
        f, force = inputs(cfg, seed=1)
        f = f[:, :band + 16].contiguous()
        thalo = f[:, -1].float().contiguous()
        args = ((0, 1, 0), f, force, None, thalo, cfg, ref.REFERENCE_WALLS,
                "trt_split", "deviatoric", band - 1, True)
        out, f1out = _nan_like(f), torch.full((9, cfg.xdim), float("nan"),
                                              device=card)
        return (sharded_fused_substep,
                lambda: sharded_fused_substep(*args, out=out, f1out=f1out),
                lambda: sharded_fused_substep_reference(*args),
                [("f", g), ("f1row", g), ("q", g), ("fluxcol", g)], 1)
    if kernel.startswith("B4"):
        K = int(kernel.split("K")[1])
        cfg = SimConfig(dtype="bfloat16", **SMALL)
        band = cfg.force_band
        f, _ = inputs(cfg, seed=3)
        f_bulk = f[:, band:]
        bhalos = f[None, :, band - 1].float().repeat(K, 1, 1).contiguous()
        out = _nan_like(f)[:, band:]
        args = (f_bulk, bhalos, cfg, ref.REFERENCE_WALLS, "trt_split",
                "deviatoric")
        return (temporal_bulk, lambda: temporal_bulk(*args, out=out),
                lambda: temporal_bulk_reference(*args),
                [("f", g), ("flux", g)], 1)
    K = 4
    grid = SUPER if kernel == "B5" else TILED
    cfg = SimConfig(dtype="bfloat16", **grid)
    f_ext, force, xs, halo = super_inputs(cfg, K, torch.float32,
                                          "deviatoric", card)
    f_ext = f_ext.to(torch.bfloat16)
    if widen:
        f_ext = f_ext.float()
    gates = [("f_band", g), ("bhalos", g), ("force", gi), ("flux", gi)]
    out = torch.full((9, cfg.force_band, cfg.xdim), float("nan"),
                     dtype=f_ext.dtype, device=card)
    if kernel == "B5":
        args = (f_ext, force, *xs, cfg, halo, ref.REFERENCE_WALLS,
                "trt_split", "deviatoric")
        return (band_super, lambda: band_super(*args, out=out),
                lambda: band_super_reference(*args), gates, 1)
    plan = xtiled_plan(cfg, K, torch.bfloat16)
    args = (f_ext, force, *xs, cfg, halo, plan.tile_x, plan.gx,
            ref.REFERENCE_WALLS, "trt_split", "deviatoric")
    return (band_super_tiled, lambda: band_super_tiled(*args, out=out),
            lambda: band_super_tiled_reference(*args), gates,
            cfg.xdim // plan.tile_x)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B2", "B2h", "B3", "B4K5", "B4K16",
                                    "B5", "B6"])
def test_bf16_kernel_matches_plain_version(card, kernel):
    # each _bf16 entry against its plain version (which computes in f32
    # and rounds f to bf16 once, where the kernel does), and bit for bit
    # the f32 entry on the widened inputs with f rounded to nearest even:
    # the same f32 arithmetic, rounded where the TPU kernel rounds (B4 at
    # K = 5 is one pass, bf16 in and out; at K = 16 two, with f32 scratch
    # between them)
    wrapper, kern, plain, gates, n = _bf16_case(kernel, card)
    before = wrapper.launches
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    assert wrapper.launches == before + n
    _check_bf16(got, want, gates)
    twin = _bf16_case(kernel, card, widen=True)[1]()
    for name, a, b in zip(gates, got, twin):
        assert b.dtype == torch.float32, name
        assert torch.equal(a, b.to(a.dtype)), name


@pytest.mark.cuda
def test_bf16_b6_is_b5_and_b4_is_b3_composed(card):
    # the bit-for-bit identities of f32 hold in bf16: B6 equals B5 on the
    # same inputs; B4 (f rounded once a call) equals 16 B3 launches whose
    # f stays f32 between them, rounded at the end
    cfg = SimConfig(dtype="bfloat16", **TILED)
    plan = xtiled_plan(cfg, 4, torch.bfloat16)
    f_ext, force, xs, halo = super_inputs(cfg, 4, torch.float32,
                                          "deviatoric", card)
    f_ext = f_ext.to(torch.bfloat16)
    a = band_super_tiled(f_ext, force, *xs, cfg, halo, plan.tile_x, plan.gx,
                         storage="deviatoric")
    b = band_super(f_ext, force, *xs, cfg, halo, storage="deviatoric")
    for name, x, y in zip(("f_band", "bhalos", "force", "flux"), a, b):
        assert torch.equal(x, y), name
    cfg = SimConfig(dtype="bfloat16", **SMALL)
    band = cfg.force_band
    f, _ = bf16_inputs(cfg, card, seed=3)
    bhalos = f[None, :, band - 1].float().repeat(16, 1, 1).contiguous()
    got = temporal_bulk(f[:, band:], bhalos, cfg, storage="deviatoric")[0]
    cur = f[:, band:].float()
    for s in range(16):
        cur = sharded_fused_substep((band, 0, 1), cur, None, bhalos[s], None,
                                    cfg, storage="deviatoric")[0]
    assert torch.equal(got, cur.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,temporal,ib_x_edge,leg,warm", [
    (dict(c_num=6, c_space=48), 1, "periodic", "single_step", None),
    (dict(c_num=6, c_space=48), 16, "periodic", "per_substep", None),
    (SUPER, 8, "periodic", "band_super_whole", None),
    (dict(c_num=6, c_space=48), 1, "reference", "single_step", None),
    (dict(c_num=6, c_space=48), 16, "reference", "per_substep", None),
    (SIZES["2048x2048"], 1, "reference", "single_step", 512),
])
def test_bf16_sim_cuda_matches_torch_backend(card, kw, temporal, ib_x_edge,
                                             leg, warm):
    # the whole model in bf16 through the _bf16 entries: from a state the
    # torch backend reached in 2 K + 3 steps (or, with warm, the cuda
    # backend in warm steps), one call of the leg (K steps, or one step;
    # the per-sub-step leg at the K = 16 of auto's plan) on the cuda
    # backend, on the torch backend, and on the torch backend in f32 (the
    # state widened).  The two bf16 backends round at the same points, so
    # they lie less than half as far apart as bf16 lies from f32 (on the
    # CPU, port against JAX's Pallas after one call: 0.002 of it
    # single-step, 0.04 on the band super-step, 0.28 over the 16
    # sub-steps of the per-sub-step leg)
    wrappers = (fused_substep, collide_stream, sharded_fused_substep,
                temporal_bulk, band_super)
    sims = {(b, dt): MucociliarySim(SimConfig(dtype=dt, **kw), backend=b,
                                    device=card, temporal=temporal,
                                    ib_x_edge=ib_x_edge)
            for b, dt in (("cuda", "bfloat16"), ("torch", "bfloat16"),
                          ("torch", "float32"))}
    assert sims["cuda", "bfloat16"].resolved_config()["band_leg"] == leg
    if warm is None:
        torch16 = sims["torch", "bfloat16"]
        st = torch16.run_chunk(torch16.init_state(), 2 * temporal + 3)
    else:
        cuda16 = sims["cuda", "bfloat16"]
        st, n = counted(cuda16.run_chunk, cuda16.init_state(), warm)
        assert n == {"B2h": warm}
    n0 = [w.launches for w in wrappers]
    out = {key: sim.run_chunk(st._replace(f=st.f.float()) if key[1] ==
                              "float32" else st, temporal)
           for key, sim in sims.items()}
    torch.cuda.synchronize()
    launched = [w.launches - a for w, a in zip(wrappers, n0)]
    want = {"single_step": [int(ib_x_edge == "periodic"),
                            int(ib_x_edge == "reference"), 0, 0, 0],
            "per_substep": [0, 0, temporal, 1, 0],
            "band_super_whole": [0, 0, 0, 1, 1]}[leg]
    assert launched == want, launched
    fc, ft, f32 = (out[k].f for k in sims)
    uc, ut, u32 = (sims[k].fields(out[k])[1] for k in sims)
    assert fc.dtype == ft.dtype == torch.bfloat16
    assert torch.isfinite(uc).all()
    assert rel_l2(fc, ft) < 0.5 * rel_l2(ft, f32)
    assert rel_l2(uc, ut) < 0.5 * rel_l2(ut, u32)


@pytest.mark.cuda
def test_bf16_refusals(card):
    # raw bf16 refuses as JAX does, on one device and on a mesh; B0's bf16
    # entry takes an f32 force only and launches nothing otherwise
    with pytest.raises(ValueError, match="requires deviatoric mode"):
        MucociliarySim(SimConfig(dtype="bfloat16", storage="raw", c_num=6,
                                 c_space=48), device=card)
    with pytest.raises(ValueError, match="requires deviatoric mode"):
        ShardedPallasSim(SimConfig(dtype="bfloat16", storage="raw",
                                   c_num=3, c_space=128, ydim=256),
                         make_mesh(2, 1, devices=[card]))
    cfg = SimConfig(dtype="bfloat16", c_num=3, c_space=128, ydim=256)
    f, force = bf16_inputs(cfg, card)
    n = collide_slabs.launches
    with pytest.raises(ValueError, match="force must be torch.float32"):
        collide_slabs([(f[:, :4].contiguous(),
                        force[:, :4].to(torch.bfloat16).contiguous())],
                      cfg, storage="deviatoric")
    assert collide_slabs.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, MAX_SLABS + 5])
def test_bf16_b0_is_the_f32_entry_on_widened_slabs(card, n):
    # B0's bf16 entry: f read as bf16 in place (rows, columns, blocks, an
    # empty slab), the force f32, f1 f32: bit for bit the f32 entry on
    # the same slabs widened, and the plain version's at the f32 gate
    cfg = SimConfig(dtype="bfloat16", **SMALL)
    f, force = bf16_inputs(cfg, card, seed=9)
    fo = torch.zeros((2,) + f.shape[1:], device=card)
    fo[:, :cfg.force_band] = force
    slabs = _slab_table(f, fo, n)
    before = collide_slabs.launches
    got = collide_slabs(slabs, cfg, "trt_split", "deviatoric")
    assert collide_slabs.launches == before + -(-n // MAX_SLABS)
    twin = collide_slabs(_slab_table(f.float(), fo, n), cfg, "trt_split",
                         "deviatoric")
    want = collide_slabs_reference(slabs, cfg, "trt_split", "deviatoric")
    torch.cuda.synchronize()
    for g, t, w, (a, _) in zip(got, twin, want, slabs):
        assert g.dtype == w.dtype == torch.float32 and g.shape == a.shape
        assert torch.equal(g, t)
        if a.numel():
            assert rel_l2(g, w) <= GATE[torch.float32]


MESH_LEGS = [((2, 1), 1, "sharded_per_step"), ((2, 2), 1, "sharded_per_step"),
             ((2, 1), 4, "band_super_whole"), ((2, 2), 4, "per_substep_tiled"),
             ((1, 2), 4, "band_super_xsharded")]


def _mesh_sim(cfg, mesh, K, card, backend, ib_x_edge="periodic"):
    m = make_mesh(*mesh, devices=[card])
    return (ShardedPallasSim(cfg, m, backend=backend, ib_x_edge=ib_x_edge)
            if K == 1 else ShardedTemporalSim(cfg, m, temporal=K,
                                              backend=backend,
                                              ib_x_edge=ib_x_edge))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,K,leg", MESH_LEGS + [
    ((2, 1), 1, "quirk sharded_per_step"),
    ((2, 2), 4, "quirk per_substep_tiled")])
def test_bf16_sharded_cuda_matches_torch_backend(card, mesh, K, leg):
    # bf16 storage on a mesh through the _bf16 entries (B0, B3, B5, B7,
    # B8): from a state the torch backend reached in 2 K + 3 steps, one
    # call (K steps) on the cuda backend, on the torch backend and on the
    # torch backend in f32 (the state widened): the two bf16 backends
    # round at the same points, so they lie less than half as far apart
    # as bf16 from f32 (on the CPU, the torch backend against JAX's bf16
    # mesh: 0.001-0.03 of it)
    ib_x_edge = "reference" if leg.startswith("quirk") else "periodic"
    kw = (dict(c_num=6, c_space=48) if K == 1 or ib_x_edge == "reference"
          else dict(c_num=16 if leg == "band_super_xsharded" else 3,
                    c_space=128))
    sims = {(b, dt): _mesh_sim(SimConfig(dtype=dt, ydim=256, **kw), mesh, K,
                               card, b, ib_x_edge)
            for b, dt in (("cuda", "bfloat16"), ("torch", "bfloat16"),
                          ("torch", "float32"))}
    rc = sims["cuda", "bfloat16"].resolved_config()
    assert rc["band_leg"] == leg.split()[-1] and rc["dtype"] == "bfloat16"
    torch16 = sims["torch", "bfloat16"]
    st = torch16.run_chunk(torch16.init_state(), 2 * K + 3)
    wrappers = (collide_slabs, sharded_fused_substep, ghost_temporal,
                band_super, band_super_xsharded)
    n0 = [w.launches for w in wrappers]
    out = {}
    for key, sim in sims.items():
        s0 = st if key[1] == "bfloat16" else st._replace(
            f=[x.float() for x in st.f])
        out[key] = sim.run_chunk(s0, K)
    torch.cuda.synchronize()
    launched = [w.launches - a for w, a in zip(wrappers, n0)]
    n_sh, n_x = mesh[0] * mesh[1], mesh[1]
    want = {"sharded_per_step": [1, n_sh, 0, 0, 0],
            "per_substep_tiled": [K, K * n_x, n_sh, 0, 0],
            "band_super_whole": [0, 0, n_sh, 1, 0],
            "band_super_xsharded": [0, 0, n_sh, 0, n_x]}[leg.split()[-1]]
    assert launched == want, launched
    g = {k: sims[k].gather_state(o) for k, o in out.items()}
    fc, ft, f32 = (g[k].f for k in sims)
    uc, ut, u32 = (sims[k].fields(out[k])[1] for k in sims)
    assert fc.dtype == ft.dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in out["cuda", "bfloat16"].force)
    assert torch.isfinite(uc).all()
    assert rel_l2(fc, ft) < 0.5 * rel_l2(ft, f32)
    assert rel_l2(uc, ut) < 0.5 * rel_l2(ut, u32)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,K,leg", [
    ((2, 1), 1, "sharded_per_step"), ((2, 2), 1, "sharded_per_step"),
    ((2, 1), 4, "per_substep_tiled"), ((1, 2), 4, "per_substep_tiled")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quirk_sharded_cuda_matches_torch_backend(card, mesh, K, leg, dtype):
    # the quirk IB on a mesh (the stencil forms on the shards, the
    # per-sub-step leg at K > 1), every shard on the card: the kernels
    # against their plain versions over 2 K + 2 steps, at the gates of
    # the periodic mesh; a geometry whose cilia cross the x edges
    cfg = SimConfig(c_num=6, c_space=48, ydim=256, dtype=dtype)
    wrappers = (collide_slabs, sharded_fused_substep, ghost_temporal)
    states = {}
    for backend in ("cuda", "torch"):
        sim = _mesh_sim(cfg, mesh, K, card, backend, "reference")
        rc = sim.resolved_config()
        assert rc["band_leg"] == leg and rc["ib_path"] == "stencil_quirk"
        n0 = [w.launches for w in wrappers]
        st = sim.run_chunk(sim.init_state(), 2 * K + 2)
        launched = [w.launches - a for w, a in zip(wrappers, n0)]
        if backend == "torch":
            assert launched == [0, 0, 0]
        else:
            n_sh = mesh[0] * mesh[1]
            b0 = 2 * K + 2 if K == 1 or mesh[1] > 1 else 2
            b3 = (2 * K + 2) * n_sh if K == 1 else \
                2 * K * mesh[1] + 2 * n_sh
            assert launched == [b0, b3, 0 if K == 1 else 2 * n_sh], launched
        states[backend] = (sim, st)
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q)) + 1e-30


# --- the CLI on the card ---------------------------------------------------

def cli_config(argv):
    """The SimConfig of a CLI argv."""
    from cuda_iblb_11_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    cfg = SimConfig.from_argv(args.positionals)
    if args.ydim:
        cfg = cfg.replace(ydim=args.ydim)
    return cfg.replace(dtype=args.dtype) if args.dtype else cfg


def same_state(a, b):
    return a.it == b.it and all(
        getattr(a, k).dtype == getattr(b, k).dtype
        and torch.equal(getattr(a, k), getattr(b, k))
        for k in ("f", "force", "lasts", "q"))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """run(label, argv): the port's CLI on the card, once a label, with
    its launches by kernel ID, SimLog text, Flux bytes and output paths."""
    import types

    from cuda_iblb_11_tpu_torch import cli
    from cuda_iblb_11_tpu_torch.io.writers import OutputPaths

    root = tmp_path_factory.mktemp("cli")
    runs = {}

    def run(label, argv):
        if label not in runs:
            paths = OutputPaths(str(root / label.replace(" ", "_")),
                                cli_config(argv))
            rc, n = counted(cli.main, argv + ["--device", "cuda", "--output",
                                              paths.root, "--quiet"])
            assert rc == 0, label
            with open(paths.flux_path, "rb") as fh:
                flux = fh.read()
            with open(paths.simlog_path) as fh:
                simlog = fh.read()
            runs[label] = types.SimpleNamespace(launches=n, simlog=simlog,
                                                flux=flux, paths=paths)
        return runs[label]
    return run


# The reference channel (288 x 192, 6 cilia): 2,000 steps in intervals of
# 500, flux rows at it = 500 ... 2,000.  Each interval of auto's
# per-sub-step leg is 31 super-steps (16 B3, one B4 each) and 4 single
# steps; on (2, 1), per_substep_tiled, a super-step is 16 B3 (one
# x-column) and 2 B7, a single step 2 B3 and one B0 call.
CLI_ARGV = ["1", "6", "48", "1.0", "1.0", "5", "0.02", "4", "0", "0"]
FLUX_ITS = (500, 1000, 1500, 2000)
QUIRK = ["--ib-x-edge", "reference"]
AUTO = ["Temporal K: 16 (auto: K=16"]
MESH_2X1 = ["Mesh: 2,1 over 1 device(s)"]
BF16 = ["Dtype: bfloat16", "Storage: deviatoric"]
STENCIL = ["IB path: stencil_quirk"]
# label: (flags, launches by kernel, SimLog lines)
CLI_RUNS = {
    "temporal_1": (["--temporal", "1"], {"B2": 2000},
                   ["Kernel path: single_step", "Resolved backend: cuda"]),
    "auto": ([], {"B2": 16, "B3": 1984, "B4": 124},
             ["Kernel path: per_substep"] + AUTO),
    "mesh_2x1": (["--mesh", "2,1"], {"B3": 2016, "B7": 248, "B0": 16},
                 ["Kernel path: per_substep_tiled"] + MESH_2X1 + AUTO),
    "bf16_temporal_1": (["--dtype", "bfloat16", "--temporal", "1"],
                        {"B2": 2000}, BF16 + ["Kernel path: single_step"]),
    "bf16_auto": (["--dtype", "bfloat16"], {"B2": 16, "B3": 1984, "B4": 124},
                  BF16 + ["Kernel path: per_substep"] + AUTO),
    "quirk_temporal_1": (QUIRK + ["--temporal", "1"], {"B2h": 2000},
                         STENCIL + ["Kernel path: single_step"]),
    "quirk_auto": (QUIRK, {"B2h": 16, "B3": 1984, "B4": 124},
                   STENCIL + ["Kernel path: per_substep"] + AUTO),
    "quirk_torch": (QUIRK + ["--backend", "torch"], {}, STENCIL),
    "quirk_mesh_temporal_1": (
        QUIRK + ["--mesh", "2,1", "--temporal", "1"], {"B3": 4000, "B0": 2000},
        STENCIL + ["Kernel path: sharded_per_step"] + MESH_2X1),
    "quirk_mesh_auto": (QUIRK + ["--mesh", "2,1"],
                        {"B3": 2016, "B7": 248, "B0": 16},
                        STENCIL + ["Kernel path: per_substep_tiled"]
                        + MESH_2X1 + AUTO),
    "quirk_bf16": (QUIRK + ["--dtype", "bfloat16"],
                   {"B2h": 16, "B3": 1984, "B4": 124},
                   STENCIL + BF16 + ["Kernel path: per_substep"]),
    "quirk_mesh_bf16": (QUIRK + ["--mesh", "2,1", "--dtype", "bfloat16"],
                        {"B3": 2016, "B7": 248, "B0": 16},
                        STENCIL + BF16 + ["Kernel path: per_substep_tiled"]
                        + MESH_2X1),
}
CLI_RUNS["quirk_auto_again"] = CLI_RUNS["quirk_auto"]   # two runs, one Flux
# label: [(check, other run, gate)]: "golden", every flux row within gate
# of the f64 golden; "rows", of the other run's; "final", the last row;
# "bytes", the Flux files equal; "nearer", the final Q nearer the other
# run's than the run named by gate (the f32 curve may cross the bf16 one
# on the way)
CLI_CHECKS = {
    "temporal_1": [("golden", None, 1e-3)],
    "auto": [("golden", None, 1e-3), ("rows", "temporal_1", 1e-5)],
    "mesh_2x1": [("golden", None, 2e-5), ("rows", "auto", 1e-5)],
    "bf16_temporal_1": [("final", "temporal_1", 2e-2)],
    "bf16_auto": [("final", "auto", 2e-2)],
    "quirk_temporal_1": [("rows", "quirk_torch", 1e-5)],
    "quirk_auto": [("rows", "quirk_torch", 1e-5),
                   ("rows", "quirk_temporal_1", 1e-5),
                   ("bytes", "quirk_auto_again", None)],
    "quirk_torch": [],
    "quirk_mesh_temporal_1": [("rows", "quirk_temporal_1", 1e-5)],
    "quirk_mesh_auto": [("rows", "quirk_auto", 1e-5)],
    "quirk_mesh_bf16": [("nearer", "quirk_bf16", "quirk_auto")],
}


def flux_rows(run):
    """Q at FLUX_ITS of a run's Flux file, in lattice units."""
    cfg = run.paths.cfg
    flux = np.loadtxt(run.paths.flux_path)
    q = {}
    for it in FLUX_ITS:
        hit = np.isclose(flux[:, 0], it * cfg.t_scale, rtol=1e-5)
        assert hit.sum() == 1, it
        q[it] = float(flux[hit, 1][0]) / cfg.x_scale
    return q


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(CLI_CHECKS))
def test_cli_on_the_card(card, cli_runs, label):
    # the CLI of the reference channel, 2,000 f32 steps unless named:
    # exact launches, SimLog naming the path, flux rows against the f64
    # golden (validation/flux_early_f64_c6.dat) and the other runs
    import os

    checks = CLI_CHECKS[label]
    names = [label] + [o for _, o, _ in checks if o] + [
        g for c, _, g in checks if c == "nearer"]
    runs = {}
    for name in names:
        flags, launches, lines = CLI_RUNS[name]
        runs[name] = cli_runs(name, CLI_ARGV + flags)
        assert runs[name].launches == launches, (name, runs[name].launches)
        for line in lines:
            assert line in runs[name].simlog, (name, line)
    q = {name: flux_rows(run) for name, run in runs.items()}
    mine = q[label]
    for check, other, gate in checks:
        if check == "golden":
            gold = np.loadtxt(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "validation", "flux_early_f64_c6.dat"))
            for it in FLUX_ITS:
                want = float(gold[gold[:, 0] == it, 1][0])
                assert abs(mine[it] - want) <= gate * abs(want), it
        elif check == "rows":
            for it in FLUX_ITS:
                assert abs(mine[it] - q[other][it]) <= \
                    gate * abs(q[other][it]), (other, it)
        elif check == "final":
            it = FLUX_ITS[-1]
            assert abs(mine[it] - q[other][it]) <= gate * abs(q[other][it])
        elif check == "bytes":
            assert runs[label].flux == runs[other].flux
        else:
            it = FLUX_ITS[-1]
            assert abs(mine[it] - q[other][it]) < \
                abs(q[gate][it] - q[other][it])


@pytest.mark.cuda
@pytest.mark.parametrize("world,transport", [
    (2, "gloo (staged through host memory)"), (1, "nccl")])
def test_distributed_transport_on_the_card(card, tmp_path, cli_runs, world,
                                           transport):
    # ranks on the one card (tests/test_torch_distributed.py's worker):
    # two take gloo staged through host memory (NCCL refuses two ranks on
    # one card), one takes NCCL.  Each rank's ring shift of card tensors
    # (f32, f64, bf16, 0-d) equals the values moved on one rank, the
    # ordered sum the local sum, and the per-step and temporal meshes
    # equal the one-process mesh bit for bit.  Then the CLI under the
    # ranks (td.CARD_CLI: 2048^2 on each leg of the mesh and in bf16, the
    # quirk): each run's Flux bytes and final npz state bit for bit the
    # one-process --mesh run's, its SimLog naming the ranks, the
    # transport and the leg, the ranks' launches summing to the one
    # process's (B0: one call per exchange on each rank's device, as on
    # the one process).  Two ranks also write a directory checkpoint half
    # way and resume it to the uninterrupted run's bits, and it resumes in
    # one process on (2, 1) and on one device within 1e-5 of it
    import json
    import os

    import test_torch_distributed as td

    from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt

    out = td._wait(td._start(world, "card", str(tmp_path)), timeout=600)
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"card.rank{r}.json")) as fh:
            ranks.append(json.load(fh))
        assert (ranks[r]["transport"], ranks[r]["device"]) == (transport,
                                                               "cuda:0")
    for name, (_, _, n) in td.CARD_RUNS.items():
        cfg, sim = td.card_mesh(None, name, card)
        one = sim.gather_state(sim.run_chunk(sim.init_state(), n))
        got, _ = ckpt.load(os.path.join(out, f"card_{name}.npz"))
        assert got.it == one.it == n
        for field in ("f", "force", "lasts", "q"):
            assert torch.equal(getattr(got, field),
                               getattr(one, field).cpu()), (name, field)

    def files(root, argv):
        """(Flux bytes, final npz state, SimLog) of a run written to root."""
        from cuda_iblb_11_tpu_torch.io.writers import OutputPaths

        paths = OutputPaths(root, cli_config(argv))
        with open(paths.flux_path, "rb") as fh:
            flux = fh.read()
        st, _ = ckpt.load(os.path.join(paths.raw_dir, "checkpoint.npz"))
        with open(paths.simlog_path) as fh:
            return flux, st, fh.read()

    for name in td.card_cli(world):
        argv, leg = td.CARD_CLI[name]
        one = cli_runs(f"one process {name}", argv)
        flux, st, log = files(os.path.join(out, f"cli_{name}"), argv)
        one_flux, one_st, _ = files(one.paths.root, argv)
        assert flux == one_flux and same_state(st, one_st), name
        for line in (f"Distributed: {world} rank(s), transport {transport}",
                     f"Kernel path: {leg}", "Device: cuda:0"):
            assert line in log, (name, line)
        per_rank = [rk["launches"][name] for rk in ranks]
        assert all(per_rank), (name, per_rank)
        summed = Counter()
        for n in per_rank:
            summed.update({k: v for k, v in n.items() if k != "B0"})
        assert summed == {k: v for k, v in one.launches.items()
                          if k != "B0"}, (name, per_rank, one.launches)
        assert all(n.get("B0", 0) == one.launches.get("B0", 0)
                   for n in per_rank), (name, per_rank, one.launches)
    if world == 1:
        return
    # the directory checkpoint, resumed by two ranks
    argv = td.CARD_CLI["f32_auto_2x2"][0]
    ck = os.path.join(out, "cli_ckpt")
    ck_dir = os.path.join(ck, "Raw", "16", "1", "checkpoint_orbax")
    assert sorted(os.listdir(ck_dir)) == [".metadata", "__0_0.distcp",
                                          "__1_0.distcp", "iblb.json"]
    flux, st, log = files(ck, argv)
    two_flux, two_st, _ = files(os.path.join(out, "cli_f32_auto_2x2"), argv)
    assert "Resumed from checkpoint at iteration 128" in log
    assert flux == two_flux and same_state(st, two_st)
    # ... and in one process
    cfg = cli_config(argv)
    sim = MucociliarySim(cfg, backend="cuda", device=card)

    def velocity(s):
        return sim.fields(s._replace(f=s.f.to(card),
                                     force=s.force.to(card)))[1]

    u_two = velocity(two_st)
    for label, flags in (("resume one process 2,1", ["--mesh", "2,1"]),
                         ("resume one device", [])):
        resumed = cli_runs(label, td.CARD_ARGV + flags + [
            "--resume", ck_dir, "--checkpoint-every", "128"])
        _, st1, _ = files(resumed.paths.root, argv)
        assert st1.f.dtype == two_st.f.dtype
        assert rel_l2(velocity(st1), u_two) <= 1e-5, label
        assert abs(float(st1.q) - float(two_st.q)) <= \
            1e-5 * abs(float(two_st.q)), label

