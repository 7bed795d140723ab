"""The port's IB pieces (ops/ib.py, ops/ib_band.py) against the JAX
package's at f64.

Tolerance: rtol 1e-12, with an absolute floor of 1e-12 times the array's
largest magnitude — the contractions sum in other orders than XLA's.
Integer periodic folds must agree exactly (the delta factors built from
them are then compared at the same tolerance).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.ops import ib as jib
from cuda_iblb_11_tpu.ops import ib_band as jband
from cuda_iblb_11_tpu_torch.ops import ib as tib
from cuda_iblb_11_tpu_torch.ops import ib_band as tband

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

RTOL = 1e-12
XDIM, BAND, NS = 96, 40, 30


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _points(seed):
    """Anchors spread over the domain, including the periodic seam at
    x = 0 / XDIM and one wrap outside it on both sides."""
    rng = np.random.default_rng(seed)
    ax = rng.integers(-4, XDIM + 4, NS).astype(np.int32)
    ax[:6] = [0, 1, XDIM - 1, XDIM, -1, -XDIM // 2]
    ay = rng.integers(1, BAND - 2, NS).astype(np.int32)
    anchor = np.stack([ax, ay], axis=-1)
    frac = rng.uniform(-0.5, 0.5, (NS, 2))
    return anchor, frac


def test_tf32_is_off(monkeypatch):
    # the GPU form of the JAX package's _PREC = HIGH (ib_band.py:35-40):
    # the IB contractions run in full f32 whatever precision the caller
    # set ("high" lets torch use TF32 on the card and bf16 passes on the
    # CPU), the caller's setting comes back after them, and importing the
    # module leaves it alone
    b = torch.backends
    seen = []
    matmul = torch.matmul

    def spy(*args):
        seen.append((torch.get_float32_matmul_precision(),
                     b.cuda.matmul.fp32_precision,
                     b.mkldnn.matmul.fp32_precision, b.cudnn.allow_tf32))
        return matmul(*args)

    anchor, frac = _points(0)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, BAND, XDIM)))
    u_s = torch.from_numpy(rng.standard_normal((NS, 2)))
    eps = torch.from_numpy(rng.uniform(0.5, 1.0, NS))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        importlib.reload(tband)
        caller = (torch.get_float32_matmul_precision(),
                  b.cuda.matmul.fp32_precision,
                  b.mkldnn.matmul.fp32_precision, b.cudnn.allow_tf32)
        assert caller == ("high", "tf32", "tf32", True)
        factors = tband.delta_factors(
            (torch.from_numpy(anchor), torch.from_numpy(frac)), XDIM, BAND,
            torch.float64)
        monkeypatch.setattr(torch, "matmul", spy)
        f_s = tband.interpolate_from_moments(q, u_s, factors)
        tband.spread(f_s, eps, factors)
        tib.spread(f_s, torch.from_numpy(rng.uniform(0, XDIM, (NS, 2))),
                   eps, XDIM, BAND)
        monkeypatch.undo()
        assert len(seen) == 3
        assert set(seen) == {("highest", "ieee", "ieee", False)}
        assert (torch.get_float32_matmul_precision(),
                b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision,
                b.cudnn.allow_tf32) == caller
    finally:
        torch.set_float32_matmul_precision(saved)


def test_delta_1d():
    r = np.linspace(-2.0, 2.0, 4001)
    _close(tib.delta_1d(torch.from_numpy(r)), jib.delta_1d(jnp.asarray(r)))


@pytest.mark.parametrize("seed", [0, 1])
def test_anchored_delta_factors_fold_across_x0(seed):
    anchor, frac = _points(seed)
    want = jband._delta_factors_anchored(
        jnp.asarray(anchor), jnp.asarray(frac), XDIM, BAND, jnp.float64)
    got = tband.delta_factors(
        (torch.from_numpy(anchor), torch.from_numpy(frac)), XDIM, BAND,
        torch.float64)
    for g, w in zip(got, want):
        _close(g, w)
    # a point anchored on the seam reaches both x = 0 and x = XDIM - 1
    dx = got[1].numpy()
    assert dx[0, XDIM - 1] > 0 and dx[0, 1] > 0


def _factors(seed):
    anchor, frac = _points(seed)
    j = jband.delta_factors((jnp.asarray(anchor), jnp.asarray(frac)), XDIM,
                            BAND, jnp.float64)
    t = tband.delta_factors((torch.from_numpy(anchor),
                             torch.from_numpy(frac)), XDIM, BAND,
                            torch.float64)
    return j, t


def test_interpolate_from_moments():
    jf, tf = _factors(2)
    rng = np.random.default_rng(2)
    q = np.concatenate([1.0 + 0.01 * rng.standard_normal((1, BAND, XDIM)),
                        0.01 * rng.standard_normal((2, BAND, XDIM))])
    u_s = 0.01 * rng.standard_normal((NS, 2))
    _close(tband.interpolate_from_moments(torch.from_numpy(q),
                                          torch.from_numpy(u_s), tf),
           jband.interpolate_from_moments(jnp.asarray(q), jnp.asarray(u_s),
                                          jf))


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_interpolate_from_f(storage):
    jf, tf = _factors(3)
    rng = np.random.default_rng(3)
    f = 0.1 + 0.01 * rng.standard_normal((9, BAND + 8, XDIM))
    u_s = 0.01 * rng.standard_normal((NS, 2))
    _close(tband.interpolate(torch.from_numpy(f), torch.from_numpy(u_s), tf,
                             BAND, storage),
           jband.interpolate(jnp.asarray(f), None, jnp.asarray(u_s), BAND,
                             storage=storage, factors=jf))


def test_spread():
    jf, tf = _factors(4)
    rng = np.random.default_rng(4)
    f_s = 1e-3 * rng.standard_normal((NS, 2))
    eps = (rng.uniform(size=NS) > 0.2).astype(np.int32)
    _close(tband.spread(torch.from_numpy(f_s), torch.from_numpy(eps), tf),
           jband.spread(jnp.asarray(f_s), None, jnp.asarray(eps), XDIM,
                        BAND, factors=jf))


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_flux_increment_and_from_cols(storage):
    rng = np.random.default_rng(5)
    ydim, flux_x = BAND + 16, XDIM - 5
    f = 0.1 + 0.01 * rng.standard_normal((9, ydim, XDIM))
    force = 1e-3 * rng.standard_normal((2, BAND, XDIM))
    _close(tib.flux_increment(torch.from_numpy(f), torch.from_numpy(force),
                              flux_x, storage=storage),
           jib.flux_increment(jnp.asarray(f), jnp.asarray(force), flux_x,
                              storage=storage))
    col = np.stack([1.0 + 0.01 * rng.standard_normal(ydim),
                    0.01 * rng.standard_normal(ydim)])
    col128 = np.zeros((2, ydim, 128))
    col128[:, :, 0] = col   # the JAX kernel's lane-padded layout
    _close(tib.flux_from_cols(torch.from_numpy(col), torch.from_numpy(force),
                              flux_x),
           jib.flux_from_cols(jnp.asarray(col128), jnp.asarray(force),
                              flux_x))


def test_pad_band():
    rng = np.random.default_rng(6)
    fb = rng.standard_normal((2, BAND, XDIM))
    for ydim in (BAND - 8, BAND, BAND + 24):
        _close(tband.pad_band(torch.from_numpy(fb), ydim),
               jband.pad_band(jnp.asarray(fb), ydim))
