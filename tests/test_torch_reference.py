"""The torch oracle (cuda_iblb_11_tpu_torch/ops/reference.py) against the
JAX oracle (cuda_iblb_11_tpu/ops/reference.py) at f64 on random fields.

Tolerance: rtol 1e-13, plus an absolute floor of 1e-13 times the array's
largest magnitude for entries near zero — the two frameworks sum in other
orders (einsum vs explicit sums), so agreement is to f64 round-off only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.lattice import W
from cuda_iblb_11_tpu.ops import reference as jref
from cuda_iblb_11_tpu_torch.ops import reference as tref

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

RTOL = 1e-13
Y, X = 24, 40


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _fields(seed, storage="raw"):
    """(f, force, rho, u) as numpy f64: f near equilibrium plus noise."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.02 * rng.standard_normal((Y, X))
    u = 0.01 * rng.standard_normal((2, Y, X))
    f = np.asarray(jref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * rng.standard_normal(f.shape) * W[:, None, None]
    if storage == "deviatoric":
        f = f - W[:, None, None]
    force = 1e-4 * rng.standard_normal((2, Y, X))
    return f, force, rho, u


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_moments_and_corrected_velocity(storage):
    f, force, _, _ = _fields(1, storage)
    for got, want in zip(tref.moments(_t(f), storage),
                         jref.moments(jnp.asarray(f), storage)):
        _close(got, want)
    for got, want in zip(
            tref.corrected_velocity(_t(f), _t(force), storage),
            jref.corrected_velocity(jnp.asarray(f), jnp.asarray(force),
                                    storage)):
        _close(got, want)


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_equilibrium(storage):
    _, _, rho, u = _fields(2)
    want = jref.equilibrium(jnp.asarray(rho), jnp.asarray(u), storage)
    _close(tref.equilibrium(_t(rho), _t(u), storage), want)
    # the deviation passed in (as the fused step's plain version does)
    _close(tref.equilibrium(_t(rho), _t(u), storage, drho=_t(rho - 1.0)),
           want)


@pytest.mark.parametrize("scheme", ["reference", "trt_split"])
def test_guo_forcing(scheme):
    _, force, _, u = _fields(3)
    _close(tref.guo_forcing(_t(u), _t(force), 2.8, 0.536, scheme),
           jref.guo_forcing(jnp.asarray(u), jnp.asarray(force), 2.8, 0.536,
                            scheme))


def test_trt_collide():
    f, force, rho, u = _fields(4)
    f0 = np.asarray(jref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    F = np.asarray(jref.guo_forcing(jnp.asarray(u), jnp.asarray(force),
                                    2.8, 0.536, "trt_split"))
    _close(tref.trt_collide(_t(f), _t(f0), _t(F), 2.8, 0.536),
           jref.trt_collide(jnp.asarray(f), jnp.asarray(f0), jnp.asarray(F),
                            2.8, 0.536))


@pytest.mark.parametrize("walls", [
    dict(),                                       # reference channel
    dict(top="noslip"),
    dict(bottom="periodic", top="periodic"),
    # cavity-style: no-slip sides, moving lid (corner precedence)
    dict(top="moving", left="noslip", right="noslip", u_wall=(0.1, 0.0)),
])
def test_stream_walls(walls):
    f, _, _, _ = _fields(5)
    _close(tref.stream(_t(f), tref.WallSpec(**walls)),
           jref.stream(jnp.asarray(f), jref.WallSpec(**walls)), rtol=0.0)


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
@pytest.mark.parametrize("forcing", ["reference", "trt_split"])
@pytest.mark.parametrize("top", ["slip", "noslip"])
def test_lb_substep(storage, forcing, top):
    f, force, _, _ = _fields(6, storage)
    got = tref.lb_substep(_t(f), _t(force), 2.8, 0.536,
                          tref.WallSpec(top=top), forcing, storage)
    want = jref.lb_substep(jnp.asarray(f), jnp.asarray(force), 2.8, 0.536,
                           jref.WallSpec(top=top), forcing, storage)
    for g, w in zip(got, want):
        _close(g, w)


def test_wallspec_validation():
    with pytest.raises(ValueError):
        tref.WallSpec(top="sticky")
    with pytest.raises(ValueError):
        tref.WallSpec(left="periodic", right="noslip")
