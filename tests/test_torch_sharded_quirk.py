"""The quirk IB (--ib-x-edge reference) on a mesh in the port against the
JAX package, on the CPU: every shard on the one CPU device, the kernels'
plain versions, f64 raw.

(a) The ownership-masked stencil forms, _stencil_interp_block and
    _quirk_spread_block, against JAX's functions of the same names
    (cuda_iblb_11_tpu/parallel/sharded.py:403-453) on seeded inputs, shard
    by shard of a (2, 2) mesh (rtol 1e-13, 1e-12); the shards' sum and the
    x-columns' concatenation against the port's single-device stencil IB.
(b) ShardedPallasSim on (2, 1) and (2, 2), 4 steps, and ShardedTemporalSim
    K = 4 on (2, 1) and (1, 2), 8 steps, against JAX's jnp single-device
    quirk oracle at the sizes and tolerances of JAX's own tests
    (tests/test_sharding.py:221-243, tests/test_sharded_temporal.py:
    203-245): f rtol 1e-12 / 1e-13, force 1e-9 / 1e-10, q 1e-10 / 1e-12;
    then 42 steps of K = 4 on (2, 1) (the remainder on the per-step path),
    where the flux has moved.  The quirk bites: the
    periodic mesh run differs by more than 1e-12.
(c) plan_sharded(..., ib_x_edge="reference") against JAX's
    ShardedTemporalSim on each mesh: the per-sub-step leg and its pad,
    where the periodic plan takes a band super-step.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.parallel import sharded as jsharded
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.ops import ib
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded
from cuda_iblb_11_tpu_torch.parallel import (
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)
from cuda_iblb_11_tpu_torch.parallel.sharded import (
    _quirk_spread_block, _stencil_interp_block,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

F64 = dict(dtype="float64", storage="raw")
NARROW = dict(c_num=4, c_space=48, ydim=256)    # 192 columns
CFG2 = dict(c_num=3, c_space=128, ydim=256)     # 384 columns
WIDE = dict(c_num=16, c_space=128, ydim=256)    # B8 when periodic


@functools.lru_cache(maxsize=None)
def _oracle(items, n, ib_x_edge="reference"):
    sim = JaxSim(JaxConfig(**dict(items), **F64), backend="jnp",
                 ib_x_edge=ib_x_edge)
    st = sim.run_chunk(sim.init_state(), n)
    return np.asarray(st.f), np.asarray(st.force), float(st.q)


def _run(kw, mesh, K, n, ib_x_edge="reference"):
    cfg = SimConfig(**kw, **F64)
    m = make_mesh(*mesh, devices=["cpu"])
    sim = (ShardedPallasSim(cfg, m, ib_x_edge=ib_x_edge) if K == 1 else
           ShardedTemporalSim(cfg, m, temporal=K, ib_x_edge=ib_x_edge))
    rc = sim.resolved_config()
    assert rc["band_leg"] == ("sharded_per_step" if K == 1
                              else "per_substep_tiled" if
                              ib_x_edge == "reference" else rc["band_leg"])
    assert rc["ib_path"] == ("stencil_quirk" if ib_x_edge == "reference"
                             else "band_matmul")
    st = sim.run_chunk(sim.init_state(), n)
    assert st.it == n
    return sim.gather_state(st)


# --- (a) the stencil forms --------------------------------------------------

def _points(cfg, rng, n=60):
    """Seeded points in the band, a third of them within two cells of the
    x edges (where the quirk aliases and drops)."""
    x = rng.uniform(0, cfg.xdim, n)
    k = n // 3
    x[:k] = rng.uniform(0.0, 1.4, k)
    x[k:2 * k] = cfg.xdim - rng.uniform(0.0, 1.4, k)
    y = rng.uniform(1.0, cfg.force_band - 2.0, n)
    return np.stack([x, y], 1)


def test_stencil_forms_match_jax_per_shard():
    rng = np.random.default_rng(11)
    jcfg, cfg = JaxConfig(**NARROW, **F64), SimConfig(**NARROW, **F64)
    Y, X, band = cfg.ydim, cfg.xdim, cfg.force_band
    f = np.asarray(W)[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, Y, X)))
    s = _points(cfg, rng)
    u_s = 1e-3 * rng.standard_normal(s.shape)
    eps = rng.uniform(0.5, 1.5, s.shape[0])
    t = torch.from_numpy
    n_y, n_x = 2, 2
    yl, xl = Y // n_y, X // n_x
    parts = []
    for iy in range(n_y):
        for ix in range(n_x):
            blk = f[:, iy * yl:(iy + 1) * yl, ix * xl:(ix + 1) * xl]
            want = jsharded._stencil_interp_block(
                jnp.asarray(blk), jnp.asarray(s), jnp.asarray(u_s), jcfg,
                iy * yl, yl, ix * xl, xl, "raw")
            got = _stencil_interp_block(t(blk.copy()), t(s), t(u_s), cfg,
                                        iy * yl, yl, ix * xl, xl, "raw")
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-13, atol=1e-18)
            parts.append(got)
    f_s = sum(parts[1:], parts[0])
    whole = ib.interpolate_from_f(t(f), t(s), t(u_s), "raw", "reference")
    np.testing.assert_allclose(f_s.numpy(), whole.numpy(), rtol=1e-12,
                               atol=1e-18)
    cols = []
    for ix in range(n_x):
        want = jsharded._quirk_spread_block(
            jnp.asarray(f_s.numpy()), jnp.asarray(s), jnp.asarray(eps),
            jcfg, ix * xl, xl, band)
        got = _quirk_spread_block(f_s, t(s), t(eps), cfg, ix * xl, xl, band)
        assert got.shape == (2, band, xl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-20)
        cols.append(got)
    whole = ib.spread(f_s, t(s), t(eps), X, band, "reference")
    np.testing.assert_allclose(torch.cat(cols, 2).numpy(), whole.numpy(),
                               rtol=1e-12, atol=1e-20)
    # the quirk drops the images of the points near the x edges
    periodic = ib.spread(f_s, t(s), t(eps), X, band, "periodic")
    assert float((periodic - whole).abs().max()) > 1e-6


# --- (b) the sims against JAX's single-device quirk oracle ------------------

@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_per_step_quirk_matches_oracle(mesh):
    f, force, q = _oracle(tuple(sorted(NARROW.items())), 4)
    st = _run(NARROW, mesh, 1, 4)
    np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(st.force.numpy(), force, rtol=1e-9,
                               atol=1e-16)
    np.testing.assert_allclose(float(st.q), q, rtol=1e-10)


@pytest.mark.parametrize("kw,mesh", [(NARROW, (2, 1)), (CFG2, (1, 2))])
def test_temporal_quirk_matches_oracle(kw, mesh):
    f, force, q = _oracle(tuple(sorted(kw.items())), 8)
    st = _run(kw, mesh, 4, 8)
    np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(st.force.numpy(), force, rtol=1e-10,
                               atol=1e-18)
    np.testing.assert_allclose(float(st.q), q, rtol=1e-12, atol=1e-15)


def test_quirk_flux_is_engaged_and_bites():
    # 42 = 10 super-steps of K = 4 + 2 per-step exchanges on (2, 1); the
    # cilia of this geometry cross the x edges
    f, force, q = _oracle(tuple(sorted(NARROW.items())), 42)
    assert abs(q) > 1e-6
    st = _run(NARROW, (2, 1), 4, 42)
    np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-13, atol=1e-15)
    # force atol at f64 round-off, as for B8 in tests/test_sharded_
    # temporal.py:265-270: after 42 steps an entry near zero at the edge
    # of a delta support differs by about 1e-17
    np.testing.assert_allclose(st.force.numpy(), force, rtol=1e-10,
                               atol=1e-15)
    np.testing.assert_allclose(float(st.q), q, rtol=1e-12)
    # the periodic mesh run (the oracle's periodic mode) differs
    fp, _, _ = _oracle(tuple(sorted(NARROW.items())), 42, "periodic")
    per = _run(NARROW, (2, 1), 4, 42, "periodic")
    np.testing.assert_allclose(per.f.numpy(), fp, rtol=1e-13, atol=1e-15)
    assert float(np.abs(per.f.numpy() - st.f.numpy()).max()) > 1e-12


# --- (c) the plan -----------------------------------------------------------

@pytest.mark.parametrize("kw,mesh,periodic_leg", [
    (NARROW, (2, 1), "per_substep_tiled"),
    (CFG2, (1, 2), "per_substep_tiled"),
    (CFG2, (2, 1), "band_super_whole"),
    (CFG2, (2, 2), "per_substep_tiled"),
    (WIDE, (2, 2), "band_super_xsharded"),
])
def test_quirk_plan_matches_jax(kw, mesh, periodic_leg):
    cfg = SimConfig(**kw)
    jsim = jsharded.ShardedTemporalSim(
        JaxConfig(**kw), jsharded.make_mesh(*mesh), temporal=4,
        interpret=True, ib_x_edge="reference")
    plan = plan_sharded(cfg, 4, *mesh, ref.REFERENCE_WALLS, torch.float32,
                        ib_x_edge="reference")
    assert (plan.band_leg, plan.pad_b, plan.xpad) == (
        jsim._kernel_path, jsim._band_pad, jsim._xpad) == (
        "per_substep_tiled", 8, 128 if mesh[1] > 1 else 0)
    periodic = plan_sharded(cfg, 4, *mesh, ref.REFERENCE_WALLS,
                            torch.float32)
    assert periodic.band_leg == periodic_leg
    with pytest.raises(ValueError, match="ib_x_edge"):
        plan_sharded(cfg, 4, *mesh, ref.REFERENCE_WALLS, torch.float32,
                     ib_x_edge="wrap")
