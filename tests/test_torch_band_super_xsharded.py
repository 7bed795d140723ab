"""B8, the band super-step of one x-shard: the port against the JAX
package's make_band_super_substep_xsharded (interpret mode) on the CPU,
inputs from a numpy seed, f64.

(a) The layout: ops/temporal.xshard_layout gives the JAX factory's ghost
    margin (rounded to 128 columns, as on the TPU), block width, point
    blocks and window layout, uniform (xl a c_space multiple) and
    phase-general.
(b) The plain version against the JAX kernel on the same block and points
    (the JAX interpret-mode margin, unrounded, given to the layout), for
    the shard that owns the flux column and one that does not: f_band,
    bhalos and flux rtol 1e-12 / atol 1e-15, force rtol 1e-10 / atol 1e-12
    of its scale (tests/test_torch_band_super_tiled.py's tolerances; one
    entry at the edge of a delta support, |force| 6e-8 of a 6e-3 scale,
    differs by 9e-18 in the phase-general layout).
(c) The interior of each shard's block equals B5's whole-domain plain
    version on the same state to 1e-13 of each output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.ops.pallas_step import make_band_super_substep_xsharded
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import band_super_reference
from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
    band_super_xsharded, shard_points,
)
from cuda_iblb_11_tpu_torch.ops.temporal import xshard_layout

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

K = 2
LAYOUTS = {   # name -> (config, n_x)
    "uniform": (dict(c_num=16, c_space=128, ydim=256), 2),
    "phase_general": (dict(c_num=10, c_space=256, ydim=288), 4),
}
F64 = dict(dtype="float64", storage="raw")


def _inputs(kw, n_x, gx=None):
    cfg = SimConfig(**kw, **F64)
    xl = cfg.xdim // n_x
    lay = xshard_layout(cfg, 8, K, ref.REFERENCE_WALLS, torch.float64, xl,
                        n_x, gx=gx)
    rng = np.random.default_rng(3)
    w = np.asarray(W)[:, None, None]
    f = torch.from_numpy(w * (1.0 + 0.05 * rng.standard_normal(
        (9, cfg.force_band + 8, cfg.xdim))))
    force = torch.from_numpy(1e-4 * rng.standard_normal(
        (2, cfg.force_band, cfg.xdim)))
    sim = MucociliarySim(cfg, backend="torch", device="cpu")
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(137, K)
    xs = [x[0] for x in prep_band_super_points(
        cfg, K, lay.halo, torch.float64, u_s, eps, anchor, frac, 1)]
    return cfg, xl, lay, f, force, xs


def _shard(cfg, xl, lay, f, force, xs, ix):
    cols = torch.arange(ix * xl - lay.gx, (ix + 1) * xl + lay.gx) % cfg.xdim
    owned = ix * xl <= cfg.flux_x < (ix + 1) * xl
    flags = (cfg.flux_x - ix * xl + lay.gx if owned else 0, int(owned))
    return (flags, f[:, :, cols].contiguous(), force[:, :, cols].contiguous(),
            *shard_points(lay, xs, cfg, ix, xl))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("interpret", [True, False])
def test_layout_matches_jax_factory(name, interpret):
    kw, n_x = LAYOUTS[name]
    cfg = SimConfig(**kw, dtype="float32")
    xl = cfg.xdim // n_x
    sub = make_band_super_substep_xsharded(
        JaxConfig(**kw, dtype="float32"), 8, K, interpret=interpret, xl=xl,
        n_x=n_x)
    lay = xshard_layout(cfg, 8, K, ref.REFERENCE_WALLS, torch.float32, xl,
                        n_x, gx=sub.gx if interpret else None)
    assert (lay.gx, lay.halo, lay.width, lay.c_sub, lay.phase_general) == (
        sub.gx, sub.halo, sub.width, sub.c_sub, sub.phase_general)
    assert lay.phase_general == (name == "phase_general")
    if lay.phase_general:
        assert (lay.win_lo0, lay.wcov, lay.wwin) == (0, sub.wcov,
                                                     sub.wcov + sub.cw)
    else:
        assert (lay.m0, lay.c_step) == (sub.m0, sub.c_step)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_b8_plain_matches_jax(name):
    kw, n_x = LAYOUTS[name]
    jcfg = JaxConfig(**kw, **F64)
    xl = jcfg.xdim // n_x
    sub = make_band_super_substep_xsharded(jcfg, 8, K, dtype=jnp.float64,
                                           storage="raw", interpret=True,
                                           xl=xl, n_x=n_x)
    cfg, xl, lay, f, force, xs = _inputs(kw, n_x, gx=sub.gx)
    owner = cfg.flux_x // xl
    for ix in (owner, (owner + 1) % n_x):
        args = _shard(cfg, xl, lay, f, force, xs, ix)
        jf, jbh, jfo, jflux = sub(jnp.asarray(args[0], jnp.int32),
                                  *(jnp.asarray(a.numpy()) for a in args[1:]))
        tf, tbh, tfo, tflux = band_super_xsharded(*args, cfg, lay,
                                                  storage="raw")
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(tbh.numpy(), np.asarray(jbh)[:, :, 0],
                                   rtol=1e-12, atol=1e-15)
        scale = float(np.abs(np.asarray(jfo)).max())
        np.testing.assert_allclose(tfo.numpy(), np.asarray(jfo), rtol=1e-10,
                                   atol=1e-12 * scale)
        assert np.abs(np.asarray(jfo)).max() > 1e-8     # the IB is engaged
        np.testing.assert_allclose(tflux.numpy(), np.asarray(jflux),
                                   rtol=1e-12, atol=1e-15)
        assert bool(tflux.any()) == (ix == owner)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_b8_interiors_are_b5(name):
    kw, n_x = LAYOUTS[name]
    cfg, xl, lay, f, force, xs = _inputs(kw, n_x)
    whole = band_super_reference(f, force, *xs, cfg, lay.halo,
                                 storage="raw")
    inner = slice(lay.gx, lay.gx + xl)
    for ix in range(n_x):
        got = band_super_xsharded(*_shard(cfg, xl, lay, f, force, xs, ix),
                                  cfg, lay, storage="raw")
        for a, b in zip(got[:3], whole[:3]):
            scale = float(b.abs().max())
            err = float((a[..., inner] - b[..., ix * xl:(ix + 1) * xl])
                        .abs().max())
            assert err <= 1e-13 * scale
