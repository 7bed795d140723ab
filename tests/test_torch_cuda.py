"""Tests that need the card: the hand kernels of csrc/ (B2 and B3
fused_step.cu, B4 temporal_bulk.cu, B5 band_super.cu) against their plain
versions on the same inputs on the GPU, and the model's cuda backend
against its torch backend, single-step and temporal.  They carry the
``cuda`` marker and skip on a host without a CUDA device.  This file imports no JAX, so on the GPU host
(which has none) it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel vs plain version, as rel-L2 of each output: 1e-6 in f32
(nvcc contracts multiply-adds and the plain version does not, so they
differ at f32 round-off) and 1e-12 in f64; for B5's force and flux 1e-5
and 1e-11, since the kernel gathers the IB stencils in another order than
the plain version's dense window products and the IB feedback carries the
difference through K sub-steps.
"""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super, band_super_reference,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference, sharded_fused_substep,
    sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.temporal import plan_temporal
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
    temporal_bulk, temporal_bulk_reference,
)

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
    with pytest.raises(NotImplementedError):
        fused_substep(f.to(torch.bfloat16), force, cfg,
                      storage="deviatoric")
    with pytest.raises(NotImplementedError):
        fused_substep(f, force, cfg, ref.WallSpec(top="moving"))
    assert fused_substep.launches == before + 1   # refusals launch nothing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sim_cuda_backend_matches_torch_backend(card, dtype):
    cfg = SimConfig(c_num=6, c_space=48, dtype=dtype)
    states = {}
    for backend in ("cuda", "torch"):
        sim = MucociliarySim(cfg, backend=backend, device=card)
        before = fused_substep.launches
        states[backend] = (sim, sim.run_chunk(sim.init_state(), 50))
        launched = fused_substep.launches - before
        assert launched == (50 if backend == "cuda" else 0)
    (sc, a), (_, b) = states["cuda"], states["torch"]
    ua, ub = sc.fields(a)[1], sc.fields(b)[1]
    assert torch.isfinite(ua).all()
    gate = 1e-5 if dtype == "float32" else 1e-11
    assert rel_l2(ua, ub) <= gate
    assert abs(float(a.q) - float(b.q)) <= gate * abs(float(b.q))


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
    """f_ext, force and the points of K real steps from it0."""
    sim = MucociliarySim(cfg, backend="torch", device=device, dtype=dtype,
                         temporal=K)
    plan = sim.plan
    assert plan.band_leg == "band_super_whole"
    f, force = random_inputs(cfg, storage, dtype, device, seed)
    _, u_s, eps, anchor, frac = sim.step_kinematics(it0, K)
    xs = prep_band_super_points(cfg, K, plan.halo, dtype, u_s, eps, anchor,
                                frac, 1)
    return (f[:, :cfg.force_band + plan.pad_s], force,
            [x[0] for x in xs], plan.halo)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("dtype,storage,top", TEMPORAL_CASES[::3])
def test_b5_matches_plain_version(card, K, dtype, storage, top):
    cfg = SimConfig(dtype=str(dtype).split(".")[-1], **SUPER)
    f_ext, force, xs, halo = super_inputs(cfg, K, dtype, storage, card)
    walls = ref.WallSpec(top=top)
    before = band_super.launches
    got = band_super(f_ext, force, *xs, cfg, halo, walls, "trt_split",
                     storage)
    want = band_super_reference(f_ext, force, *xs, cfg, halo, walls,
                                "trt_split", storage)
    torch.cuda.synchronize()
    assert band_super.launches == before + 1
    g, gi = (1e-6, 1e-5) if dtype == torch.float32 else (1e-12, 1e-11)
    _check_all(got, want, [("f_band", g), ("bhalos", g), ("force", gi),
                           ("flux", gi)])


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
    with pytest.raises(NotImplementedError, match="x-sharded"):
        sharded_fused_substep((0, 1, 0), f[:, :band + 16, :96].contiguous(),
                              force[:, :, :96].contiguous(), None, None, cfg)
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
