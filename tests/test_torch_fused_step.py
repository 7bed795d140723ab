"""The port's fused step (plain version, and the wrapper on CPU tensors)
against the JAX Pallas kernel make_fused_substep(..., emit_moments=True),
run as the JAX package's own tests run it on the CPU: f64, interpret mode.

Tolerance: rtol 1e-12 on f, q and fluxcol lane 0, with an absolute floor of
1e-12 times the array's largest magnitude — the kernel's pair-form collide
and the oracle's per-direction form agree only to f64 round-off.  The
kernel itself is compared with the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import W
from cuda_iblb_11_tpu.ops import reference as jref
from cuda_iblb_11_tpu.ops.pallas_step import make_fused_substep
from cuda_iblb_11_tpu_torch.ops import reference as tref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

RTOL = 1e-12
GRID = dict(c_num=2, c_space=64, ydim=64)               # band == ydim == 64
BAND_GRID = dict(c_num=2, c_space=64, ydim=64, length=16)  # band 48 < 64


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _inputs(cfg, storage, seed=0):
    rng = np.random.default_rng(seed)
    y, x = cfg.ydim, cfg.xdim
    rho = 1.0 + 0.02 * rng.standard_normal((y, x))
    u = 0.01 * rng.standard_normal((2, y, x))
    f = np.asarray(jref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * rng.standard_normal(f.shape) * W[:, None, None]
    if storage == "deviatoric":
        f = f - W[:, None, None]
    force = 1e-4 * rng.standard_normal((2, cfg.force_band, x))
    return f, force


def _compare(cfg, storage, forcing, top, tile_y=None):
    f, force = _inputs(cfg, storage)
    jfn = make_fused_substep(cfg, jref.WallSpec(top=top), dtype=jnp.float64,
                             forcing=forcing, interpret=True, tile_y=tile_y,
                             storage=storage, emit_moments=True)
    jf, jq, jcol = jfn(jnp.asarray(f), jnp.asarray(force))
    tf, tq, tcol = fused_substep_reference(
        torch.from_numpy(f), torch.from_numpy(force), cfg,
        tref.WallSpec(top=top), forcing, storage)
    _close(tf, jf)
    _close(tq, jq)
    _close(tcol, np.asarray(jcol)[:, :, 0])


@pytest.mark.parametrize("top", ["slip", "noslip"])
@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_plain_matches_pallas_kernel(storage, forcing, top):
    _compare(SimConfig(dtype="float64", **GRID), storage, forcing, top)


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_plain_matches_pallas_kernel_band_below_ydim(storage):
    # rows at and above the band must see exactly zero force, and q covers
    # the band only (tests/test_pallas.py:85 is the JAX twin)
    cfg = SimConfig(dtype="float64", **BAND_GRID)
    assert cfg.force_band == 48
    _compare(cfg, storage, "trt_split", "slip", tile_y=16)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    cfg = SimConfig(dtype="float64", **BAND_GRID)
    f, force = _inputs(cfg, "raw", seed=3)
    f, force = torch.from_numpy(f), torch.from_numpy(force)
    before = fused_substep.launches
    got = fused_substep(f, force, cfg, storage="raw")
    want = fused_substep_reference(f, force, cfg, storage="raw")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_substep.launches == before  # the plain path never counts


def test_plain_version_bf16_storage_computes_in_f32():
    # bf16 deviatoric storage: f32 compute, bf16 f out, f32 moments
    cfg = SimConfig(dtype="bfloat16", **BAND_GRID)
    f, force = _inputs(cfg, "deviatoric", seed=4)
    f16 = torch.from_numpy(f).to(torch.bfloat16)
    f_new, q, col = fused_substep_reference(
        f16, torch.from_numpy(force).float(), cfg, storage="deviatoric")
    assert f_new.dtype == torch.bfloat16
    assert q.dtype == col.dtype == torch.float32
    want, _, _ = fused_substep_reference(
        f16.double(), torch.from_numpy(force), cfg, storage="deviatoric")
    # bf16 output rounding: 2^-8 of the largest deviation
    assert (f_new.double() - want).abs().max() <= 2.0 ** -8 * want.abs().max()


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    from cuda_iblb_11_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_kernels, "CUDA_ROOT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_kernels, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load()


@pytest.mark.parametrize("amp", [1.0, 0.01])
def test_plain_version_f32_deviatoric_keeps_the_deviation(amp):
    # deviatoric storage spends the f32 mantissa on f_i - w_i: the plain
    # version must not round it through rho - 1 (ops/reference.equilibrium
    # takes drho), or its own f32 error (~1e-6 of the deviation at amp 1,
    # ~1e-4 at amp 0.01) would swamp the kernel's (~1e-7, measured on the
    # card) in the kernel-vs-plain gate of 1e-6.  Gate: 3e-7 rel-L2 against
    # the same function in f64, at any deviation amplitude.
    cfg = SimConfig(dtype="float32", **BAND_GRID)
    f, force = _inputs(cfg, "deviatoric", seed=5)
    f32 = torch.from_numpy(amp * f).float()
    force32 = torch.from_numpy(force).float()
    got = fused_substep_reference(f32, force32, cfg, storage="deviatoric")
    want = fused_substep_reference(f32.double(), force32.double(), cfg,
                                   storage="deviatoric")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        rel = float(torch.linalg.norm(g.double() - w) / torch.linalg.norm(w))
        assert rel <= 3e-7, rel
