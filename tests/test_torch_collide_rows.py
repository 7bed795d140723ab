"""B0, the collide-only slab kernel: the port's plain version against the
JAX package's make_collide_rows_kernel (interpret mode) on the CPU, inputs
from a numpy seed, f64, rtol 1e-13; and the wrapper's CPU route on strided
slabs (an edge row and an edge column read in place)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.ops.pallas_step import make_collide_rows_kernel
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.ops.collide_rows import (
    collide_rows, collide_rows_reference,
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
    before = collide_rows.launches
    for sl in (np.s_[:, 3:4, :], np.s_[:, :, -1:]):
        got = collide_rows(f[sl], force[sl], cfg)
        want = collide_rows_reference(f[sl].contiguous(),
                                      force[sl].contiguous(), cfg)
        assert torch.equal(got, want)
    assert collide_rows.launches == before
