"""B0, the collide-only slab kernel: the port's plain version against the
JAX package's make_collide_rows_kernel (interpret mode) on the CPU, inputs
from a numpy seed, f64, rtol 1e-13; the wrapper's CPU route on strided
slabs (an edge row and an edge column read in place); and a table of slabs
(collide_slabs, one launch on the card) on the CPU: each f1 the per-slab
plain version's, and JAX's kernel's on the row blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.ops.pallas_step import make_collide_rows_kernel
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.ops.collide_rows import (
    collide_rows, collide_rows_reference, collide_slabs,
    collide_slabs_reference,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

KW = dict(c_num=4, c_space=48, ydim=64)


def _slab(storage, rows, seed):
    rng = np.random.default_rng(seed)
    xdim = KW["c_num"] * KW["c_space"]
    w = np.asarray(W)[:, None, None]
    f = w * (1.0 + 0.05 * rng.standard_normal((9, rows, xdim)))
    if storage == "deviatoric":
        f = f - w
    force = 1e-3 * rng.standard_normal((2, rows, xdim))
    return f, force


@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_b0_plain_matches_jax(forcing, storage):
    f, force = _slab(storage, 8, seed=1)
    kern = make_collide_rows_kernel(JaxConfig(**KW), 8, jnp.float64,
                                    forcing=forcing, storage=storage,
                                    interpret=True)
    want = np.asarray(kern(jnp.asarray(f), jnp.asarray(force)))
    got = collide_rows_reference(torch.from_numpy(f),
                                 torch.from_numpy(force), SimConfig(**KW),
                                 forcing, storage)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-16)


def test_b0_wrapper_reads_strided_slabs_on_the_cpu():
    # an edge row and an edge column of a state go through in place: the
    # same values as the contiguous copies, and no launch off the card
    f, force = _slab("raw", 16, seed=2)
    f, force = torch.from_numpy(f), torch.from_numpy(force)
    cfg = SimConfig(**KW)
    before = collide_slabs.launches
    for sl in (np.s_[:, 3:4, :], np.s_[:, :, -1:]):
        got = collide_rows(f[sl], force[sl], cfg)
        want = collide_rows_reference(f[sl].contiguous(),
                                      force[sl].contiguous(), cfg)
        assert torch.equal(got, want)
    assert collide_slabs.launches == before


@pytest.mark.parametrize("storage", ["raw", "deviatoric"])
def test_b0_slab_table_matches_per_slab_and_jax(storage):
    # whole-width row blocks of 8 rows (as JAX's kernel takes them), an
    # edge row, edge columns, a strided block and an empty slab, read in
    # place
    f, force = _slab(storage, 16, seed=3)
    ft, gt = torch.from_numpy(f), torch.from_numpy(force)
    cfg = SimConfig(**KW)
    cuts = [np.s_[:, 0:8, :], np.s_[:, 8:16, :], np.s_[:, 5:6, :],
            np.s_[:, :, 0:1], np.s_[:, :, -1:], np.s_[:, 2:9, 4:40:3],
            np.s_[:, 4:4, :]]
    slabs = [(ft[c], gt[c]) for c in cuts]
    before = collide_slabs.launches
    got = collide_slabs(slabs, cfg, "trt_split", storage)
    want = collide_slabs_reference(slabs, cfg, "trt_split", storage)
    assert collide_slabs.launches == before    # no launch off the card
    assert len(got) == len(cuts)
    for g, w, (a, b) in zip(got, want, slabs):
        assert g.shape == a.shape and torch.equal(g, w)
        assert torch.equal(w, collide_rows_reference(a, b, cfg, "trt_split",
                                                     storage))
    for c, g in zip(cuts[:2], got):
        rows = g.shape[1]
        kern = make_collide_rows_kernel(JaxConfig(**KW), rows, jnp.float64,
                                        forcing="trt_split", storage=storage,
                                        interpret=True)
        jw = np.asarray(kern(jnp.asarray(f[c]), jnp.asarray(force[c])))
        np.testing.assert_allclose(g.numpy(), jw, rtol=1e-13, atol=1e-16)
