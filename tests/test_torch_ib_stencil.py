"""The stencil forms of ops/ib.py against the JAX package's
(cuda_iblb_11_tpu/ops/ib.py) in every x_edge mode, f64 at rtol 1e-12: the
same arithmetic, so round-off of two implementations; the spread is a
fixed-order matmul on the card where JAX scatter-adds, so its sums are
taken in another order.

The points (seeded numpy) include some within 1.5 cells of x = 0 and
x = X - 1 (where the modes differ), some at exact .5 coordinates (where
torch.round, like jnp.rint, must round half to even) and some near the
band top (where the spread drops rows above it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.ops import ib as jib
from cuda_iblb_11_tpu_torch.ops import ib

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

X, Y, BAND = 40, 24, 16


def _points(seed=0):
    rng = np.random.default_rng(seed)
    xs = np.concatenate([
        rng.uniform(-0.6, 1.5, 6),            # near x = 0
        rng.uniform(X - 2.5, X - 0.4, 6),     # near x = X - 1
        rng.uniform(2.0, X - 3.0, 8),
        [0.5, 1.5, X - 1.5, X - 0.5, 10.5, -0.5],   # exact halves
    ])
    ys = np.concatenate([
        rng.uniform(0.2, BAND - 1.0, 14),
        rng.uniform(BAND - 1.5, BAND - 0.2, 6),    # near the band top
        [2.5, 3.5, BAND - 1.5, 4.0, 7.5, 5.0],
    ])
    s = np.stack([xs, ys], axis=1)
    u_s = 1e-3 * rng.standard_normal(s.shape)
    eps = (rng.uniform(size=len(xs)) > 0.2).astype(np.float64)
    return s, u_s, eps


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["periodic", "reference_alias",
                                  "reference_drop"])
def test_stencil_matches_jax(mode):
    s, _, _ = _points(1)
    got = ib._stencil(torch.from_numpy(s), X, Y, mode)
    want = jib._stencil(jnp.asarray(s), X, Y, mode)
    for g, w in zip(got, want):
        g = g.numpy()
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            _close(g, w)


def test_stencil_rounds_half_to_even():
    # nearbyint(0.5) = 0, (1.5) = 2, (-0.5) = -0, (10.5) = 10: the centre
    # column of the stencil (offset 0, lattice direction 0)
    s = torch.tensor([[0.5, 2.5], [1.5, 3.5], [-0.5, 4.5], [10.5, 5.5]],
                     dtype=torch.float64)
    xw, yc, _, _ = ib._stencil(s, X, Y, "periodic")
    assert xw[:, 0].tolist() == [0, 2, 0, 10]
    assert yc[:, 0].tolist() == [2, 4, 4, 6]


@pytest.mark.parametrize("x_edge", ["periodic", "reference"])
def test_interpolate_matches_jax(x_edge):
    s, u_s, _ = _points(2)
    rng = np.random.default_rng(3)
    rho = 1.0 + 0.01 * rng.standard_normal((Y, X))
    u = 1e-3 * rng.standard_normal((2, Y, X))
    got = ib.interpolate(torch.from_numpy(rho), torch.from_numpy(u),
                         torch.from_numpy(s), torch.from_numpy(u_s), x_edge)
    _close(got, jib.interpolate(jnp.asarray(rho), jnp.asarray(u),
                                jnp.asarray(s), jnp.asarray(u_s), x_edge))


@pytest.mark.parametrize("x_edge", ["periodic", "reference"])
@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_interpolate_from_f_matches_jax(x_edge, storage):
    s, u_s, _ = _points(4)
    rng = np.random.default_rng(5)
    f = 1.0 / 9.0 + 1e-3 * rng.standard_normal((9, Y, X))
    if storage == "deviatoric":
        f = f - 1.0 / 9.0
    got = ib.interpolate_from_f(torch.from_numpy(f), torch.from_numpy(s),
                                torch.from_numpy(u_s), storage, x_edge)
    _close(got, jib.interpolate_from_f(jnp.asarray(f), jnp.asarray(s),
                                       jnp.asarray(u_s), storage, x_edge))


@pytest.mark.parametrize("x_edge", ["periodic", "reference"])
def test_spread_matches_jax(x_edge):
    s, _, eps = _points(6)
    F_s = 1e-3 * np.random.default_rng(7).standard_normal(s.shape)
    got = ib.spread(torch.from_numpy(F_s), torch.from_numpy(s),
                    torch.from_numpy(eps), X, BAND, x_edge)
    want = jib.spread(jnp.asarray(F_s), jnp.asarray(s), jnp.asarray(eps), X,
                      BAND, x_edge)
    assert got.shape == (2, BAND, X)
    _close(got, want)


def test_quirk_differs_from_periodic_at_the_x_edges():
    # the modes agree away from the edges and differ near them, so the
    # tests above can tell a mode from another
    s, u_s, eps = _points(8)
    ts, tu = torch.from_numpy(s), torch.from_numpy(u_s)
    F_s = torch.from_numpy(1e-3 * np.ones(s.shape))
    te = torch.from_numpy(eps)
    sp = {e: ib.spread(F_s, ts, te, X, BAND, e)
          for e in ("periodic", "reference")}
    edge = torch.zeros(X, dtype=torch.bool)
    edge[:2] = edge[-2:] = True
    assert not torch.allclose(sp["periodic"][:, :, edge],
                              sp["reference"][:, :, edge])
    assert torch.allclose(sp["periodic"][:, :, 4:-4],
                          sp["reference"][:, :, 4:-4], rtol=0, atol=0)
    rng = np.random.default_rng(9)
    f = torch.from_numpy(1.0 / 9.0 + 1e-3 * rng.standard_normal((9, Y, X)))
    a = ib.interpolate_from_f(f, ts, tu, "raw", "periodic")
    b = ib.interpolate_from_f(f, ts, tu, "raw", "reference")
    near = (ts[:, 0] < 1.5) | (ts[:, 0] > X - 2.5)
    assert not torch.allclose(a[near], b[near])
    assert torch.equal(a[~near], b[~near])
