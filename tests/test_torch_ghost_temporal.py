"""B7, the sharded K-step bulk with ghost rows: the port's plain version
against the JAX package's make_ghost_temporal_substep (interpret mode) on
the CPU, inputs from a numpy seed, f64.

(a) An inject shard (the band/bulk seam inside it, or at its bottom row),
    a shard wholly above the band and the top shard (both top walls), at
    K = 2 and, with 128 ghost columns a side (an x-sharded block), K = 4: the
    rows the shard owns above the seam, [pad + lb, pad + yl), at rtol
    1e-13; the flux at rtol 1e-6 (the JAX kernel adds its per-tile sums in
    float32 even in f64, pallas_step.py:2029).
(b) The mirror of tests/test_kernel_mirror.py:45-77: the bulk rows as one
    shard with B4's case as its flags (the seam at its bottom row, the top
    wall, the flux column) and NaN ghost rows give B4's rows and flux bit
    for bit, and stay finite: the seal holds and the garbage stays in the
    pad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.ops.pallas_step import make_ghost_temporal_substep
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
    ghost_temporal, ghost_temporal_reference,
)
from cuda_iblb_11_tpu_torch.ops.temporal import GHOST_PAD, check_ghost
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk_reference

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

KW = dict(c_num=8, c_space=48, ydim=320, dtype="float64", storage="raw")
YL, XL = 64, 192          # a (5, 2) mesh's shard


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    w = np.asarray(W)[:, None, None]
    return w * (1.0 + 0.05 * rng.standard_normal((9, cfg.ydim, cfg.xdim)))


def _case(cfg, f, y0, xpad, K, seed):
    """Shard (y0, x0 = 0)'s block (xpad ghost columns a side), its ghost
    rows and seam halos, periodic in y and x."""
    pad = GHOST_PAD
    xl = XL if xpad else cfg.xdim
    cols = np.arange(-xpad, xl + xpad) % cfg.xdim
    rows = np.arange(y0 - pad, y0 + YL + pad) % cfg.ydim
    blk = f[:, rows][:, :, cols]
    rng = np.random.default_rng(seed)
    bh = (f[None, :, cfg.force_band - 1][:, :, cols]
          * (1.0 + 1e-3 * rng.standard_normal((K, 9, len(cols)))))
    return (blk[:, pad:pad + YL], blk[:, :pad], blk[:, pad + YL:], bh)


@pytest.mark.parametrize("K,y0,xpad,top", [
    (2, 96, 0, "slip"), (2, 192, 0, "slip"),        # inject, above
    (2, 256, 0, "slip"), (2, 256, 0, "noslip"),     # the top wall
    (4, 96, 128, "slip"), (4, 128, 128, "slip"),    # x-extended blocks
    (4, 256, 128, "noslip")])
def test_b7_plain_matches_jax(K, y0, xpad, top):
    cfg, jcfg = SimConfig(**KW), JaxConfig(**KW)
    band, pad = cfg.force_band, GHOST_PAD
    walls = ref.WallSpec(top=top)
    f = _state(cfg, seed=K + y0)
    f_loc, bot, top_g, bh = _case(cfg, f, y0, xpad, K, seed=3)
    width = f_loc.shape[2]
    sub = make_ghost_temporal_substep(jcfg, YL, K, walls, jnp.float64,
                                      storage="raw", interpret=True,
                                      width=width)
    assert sub.pad == pad
    lb = min(max(band - y0, 0), YL)
    inject, is_top = int(y0 <= band < y0 + YL), int(y0 + YL == cfg.ydim)
    lane = xpad + cfg.flux_x % (XL if xpad else cfg.xdim)
    jf, jflux = sub(jnp.asarray([inject, is_top, (pad + lb) // sub.ty, lane,
                                 1], jnp.int32),
                    jnp.asarray(f_loc), jnp.asarray(bot), jnp.asarray(top_g),
                    jnp.asarray(bh[:, :, None, :]).repeat(8, axis=2))
    tf, tflux = ghost_temporal_reference(
        (inject, is_top, pad + lb, lane, 1), *(torch.from_numpy(a) for a in
                                               (f_loc, bot, top_g, bh)),
        cfg, walls, storage="raw")
    own = np.s_[:, pad + lb:pad + YL]
    np.testing.assert_allclose(tf.numpy()[own], np.asarray(jf)[own],
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(tflux.numpy(), np.asarray(jflux), rtol=1e-6,
                               atol=0.0)
    assert np.abs(tflux.numpy()).max() > 0 or lb == YL


@pytest.mark.parametrize("top", ["slip", "noslip"])
def test_b7_with_b4_flags_is_b4(top):
    cfg = SimConfig(**KW)
    band, pad, K = cfg.force_band, GHOST_PAD, 4
    walls = ref.WallSpec(top=top)
    f = torch.from_numpy(_state(cfg, seed=5))
    rng = np.random.default_rng(6)
    bh = (f[None, :, band - 1] * (1.0 + 1e-3 * torch.from_numpy(
        rng.standard_normal((K, 9, cfg.xdim))))).contiguous()
    nan = torch.full((9, pad, cfg.xdim), float("nan"), dtype=torch.float64)
    b4, flux4 = temporal_bulk_reference(f[:, band:], bh, cfg, walls)
    blk, flux7 = ghost_temporal((1, 1, pad, cfg.flux_x, 1), f[:, band:], nan,
                                nan, bh, cfg, walls)
    assert torch.equal(blk[:, pad:-pad], b4)
    assert torch.equal(flux7, flux4)
    assert torch.isfinite(blk[:, pad:-pad]).all()
    assert not torch.isfinite(blk[:, :pad]).all()    # the garbage stayed


def test_b7_rules_and_flux_owner():
    check_ghost(16, 16)
    with pytest.raises(ValueError, match="K=17"):
        check_ghost(17, 64)
    with pytest.raises(ValueError, match="yl >= 16"):
        check_ghost(4, 8)
    # a shard that does not own the flux column sums nothing
    cfg = SimConfig(**KW)
    f = _state(cfg, seed=7)
    f_loc, bot, top_g, bh = (torch.from_numpy(np.ascontiguousarray(a))
                             for a in _case(cfg, f, 192, 0, 2, seed=8))
    _, flux = ghost_temporal((0, 0, GHOST_PAD, 3, 0), f_loc, bot, top_g, bh,
                             cfg)
    assert not flux.any()
