"""B2h's plain version (ops/collide_stream.py) against the JAX kernel it
ports, make_fused_substep(pipeline=False) in interpret mode, at the shapes
and tiles of tests/test_pallas.py (:25-29, :72-83, and a force band below
the grid, :85-101), both forcings, both top walls and both storages; also
against make_fused_substep(pipeline=True, emit_moments=False), the JAX
quirk path's step, which computes the same function.  f64, rtol 1e-12 with
an absolute floor of 1e-15 (round-off of two implementations of the same
expression tree).  Inputs are seeded numpy arrays handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.core.lattice import W
from cuda_iblb_11_tpu.ops import reference as jref
from cuda_iblb_11_tpu.ops.pallas_step import make_fused_substep
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.collide_stream import (
    collide_stream, collide_stream_reference,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)


def _inputs(ydim, xdim, band, storage, seed):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.02 * rng.standard_normal((ydim, xdim))
    u = 0.01 * rng.standard_normal((2, ydim, xdim))
    f = np.asarray(jref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * rng.standard_normal(f.shape) * np.asarray(W)[:, None, None]
    if storage == "deviatoric":
        f = f - np.asarray(W)[:, None, None]
    force = 1e-4 * rng.standard_normal((2, band, xdim))
    return f, force


def _port(f, force, cfg, top, forcing, storage):
    walls = ref.WallSpec(top=top)
    return collide_stream_reference(torch.from_numpy(f),
                                    torch.from_numpy(force), cfg.tau,
                                    cfg.tau2, walls, forcing,
                                    storage).numpy()


def _jax(f, force, cfg, top, forcing, storage, tile_y, pipeline=False):
    walls = jref.WallSpec(top=top)
    fused = make_fused_substep(cfg, walls=walls, dtype=jnp.float64,
                               forcing=forcing, interpret=True,
                               tile_y=tile_y, pipeline=pipeline,
                               storage=storage)
    return np.asarray(fused(jnp.asarray(f), jnp.asarray(force)))


@pytest.mark.parametrize("ydim,xdim,tile_y", [
    (32, 256, 8),    # multi-tile
    (16, 128, 16),   # single tile
    (24, 128, 8),    # 3 tiles
])
@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
@pytest.mark.parametrize("top", ["slip", "noslip"])
def test_plain_matches_jax_halo_band_kernel(ydim, xdim, tile_y, forcing,
                                            top):
    cfg = SimConfig(c_num=2, c_space=xdim // 2, ydim=ydim, dtype="float64")
    assert cfg.force_band == ydim
    f, force = _inputs(ydim, xdim, ydim, "raw", seed=ydim + xdim)
    np.testing.assert_allclose(_port(f, force, cfg, top, forcing, "raw"),
                               _jax(f, force, cfg, top, forcing, "raw",
                                    tile_y), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_plain_matches_jax_with_band_below_grid(storage):
    # force band 48 < 64 rows: rows above the band see exactly zero force
    cfg = SimConfig(c_num=2, c_space=64, ydim=64, length=16,
                    dtype="float64")
    assert cfg.force_band == 48
    f, force = _inputs(64, 128, 48, storage, seed=5)
    np.testing.assert_allclose(
        _port(f, force, cfg, "slip", "trt_split", storage),
        _jax(f, force, cfg, "slip", "trt_split", storage, 16),
        rtol=1e-12, atol=1e-15)


def test_plain_matches_jax_quirk_step():
    # the pipelined kernel without emission: the quirk mode's step
    cfg = SimConfig(c_num=2, c_space=64, ydim=64, length=16,
                    dtype="float64")
    f, force = _inputs(64, 128, cfg.force_band, "raw", seed=6)
    np.testing.assert_allclose(
        _port(f, force, cfg, "noslip", "trt_split", "raw"),
        _jax(f, force, cfg, "noslip", "trt_split", "raw", 16,
             pipeline=True), rtol=1e-12, atol=1e-15)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cfg = SimConfig(c_num=2, c_space=64, ydim=64, length=16,
                    dtype="float64")
    f, force = (torch.from_numpy(a) for a in _inputs(64, 128, 48, "raw", 7))
    out = torch.empty_like(f)
    before = collide_stream.launches
    got = collide_stream(f, force, cfg.tau, cfg.tau2, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, collide_stream_reference(f, force, cfg.tau,
                                                     cfg.tau2))
    assert collide_stream.launches == before   # no kernel on the CPU
