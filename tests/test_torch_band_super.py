"""B5, the resident-band super-step, and what it rests on: the port against
the JAX package on the CPU (JAX in interpret mode, the port's plain
versions), inputs from a numpy seed, f64.

(a) beat_x_bound, the envelope that proves each cilium's delta support
    inside its window, equals JAX's for both beat patterns;
(b) prep_band_super_points lays the points out as JAX does (integers
    exact, reals equal);
(c) band_super_reference against make_band_super_substep at K = 2 and 4:
    f_band, bhalos and flux rtol 1e-12, force rtol 1e-10 / atol 1e-18
    (the tolerance of tests/test_band_super.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models import mucociliary as jmodel
from cuda_iblb_11_tpu.models.cilia import CiliaModel as JaxCilia
from cuda_iblb_11_tpu.ops.pallas_step import make_band_super_substep
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.models.cilia import beat_x_bound
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops.band_super import band_super_reference

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

KW = dict(c_num=3, c_space=128, ydim=256, dtype="float64", storage="raw")


@pytest.mark.parametrize("pattern", ["no_mucus", "mucus"])
@pytest.mark.parametrize("length", [96, 16])
def test_beat_x_bound_matches_jax(pattern, length):
    jcfg = JaxConfig(length=length, **KW)
    want = JaxCilia(jcfg, pattern=pattern).beat_x_bound()
    assert beat_x_bound(length, pattern) == want


def _points(K, it0):
    """The port's kinematics of K steps from it0: (u_s, eps, anchor, frac)
    [K, Ns, ...] and the plan's halo."""
    sim = MucociliarySim(SimConfig(**KW), backend="torch", device="cpu",
                         temporal=K)
    assert sim.plan.band_leg == "band_super_whole"
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(it0, K)
    return (u_s, eps, anchor, frac), sim.plan.halo


@pytest.fixture(scope="module")
def points():
    """Two super-steps of K = 4 points from it = 137, in both layouts."""
    K, n_super = 4, 2
    (u_s, eps, anchor, frac), halo = _points(K * n_super, 137)
    tcfg, jcfg = SimConfig(**KW), JaxConfig(**KW)
    port = prep_band_super_points(tcfg, K, halo, torch.float64, u_s, eps,
                                  anchor, frac, n_super)
    jax_ = jmodel.prep_band_super_points(
        jcfg, K, halo, jnp.float64, *(jnp.asarray(x.numpy())
                                      for x in (u_s, eps, anchor, frac)),
        n_super)
    return port, [np.asarray(x) for x in jax_]


def test_prep_band_super_points_matches_jax(points):
    port, jax_ = points
    for name, p, j in zip(("us", "eps", "axl", "fx", "ay", "fy"), port,
                          jax_):
        assert tuple(p.shape) == j.shape, name
        assert p.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float64): torch.float64}[j.dtype]
        np.testing.assert_array_equal(p.numpy(), j, err_msg=name)
    # the padded points are inert: no window cell within reach
    assert (port[2][..., 96:] == -20000).all()
    assert (port[4][..., 96:] == -20000).all()


@pytest.mark.parametrize("K", [2, 4])
def test_b5_plain_matches_jax(K):
    tcfg, jcfg = SimConfig(**KW), JaxConfig(**KW)
    band, xdim = tcfg.force_band, tcfg.xdim
    (u_s, eps, anchor, frac), halo = _points(K, 137)
    xs = [x[0] for x in prep_band_super_points(
        tcfg, K, halo, torch.float64, u_s, eps, anchor, frac, 1)]
    pad = -(-K // 8) * 8
    rng = np.random.default_rng(5)
    w = np.asarray(W)[:, None, None]
    f_ext = w * (1.0 + 0.05 * rng.standard_normal((9, band + pad, xdim)))
    force = 1e-4 * rng.standard_normal((2, band, xdim))
    sub = make_band_super_substep(jcfg, pad, K, dtype=jnp.float64,
                                  storage="raw")
    assert sub.halo == halo
    jf, jbh, jforce, jflux = sub(jnp.asarray(f_ext), jnp.asarray(force),
                                 *(jnp.asarray(x.numpy()) for x in xs))
    tf, tbh, tforce, tflux = band_super_reference(
        torch.from_numpy(f_ext), torch.from_numpy(force), *xs, tcfg, halo,
        storage="raw")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tbh.numpy(), np.asarray(jbh)[:, :, 0],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tforce.numpy(), np.asarray(jforce),
                               rtol=1e-10, atol=1e-18)
    assert np.abs(np.asarray(jforce)).max() > 1e-8   # the IB is engaged
    np.testing.assert_allclose(tflux.numpy(), np.asarray(jflux), rtol=1e-12,
                               atol=1e-15)
