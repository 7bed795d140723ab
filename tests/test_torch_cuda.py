"""Tests that need the card: the hand kernel csrc/fused_step.cu against its
plain version on the same inputs on the GPU, and the model's cuda backend
against its torch backend.  They carry the ``cuda`` marker and skip on a
host without a CUDA device.  This file imports no JAX, so on the GPU host
(which has none) it runs without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, kernel vs plain version, as rel-L2 of each output: 1e-6 in f32
(nvcc contracts multiply-adds and the plain version does not, so they
differ at f32 round-off) and 1e-12 in f64.
"""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import W
from cuda_iblb_11_tpu_torch import MucociliarySim
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference,
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
