"""The port's CiliaModel (batched over steps, f64 kinematics) against the
JAX CiliaModel evaluated one step at a time.

Integers (overlap mask, anchors) must match exactly.  Floats: rtol 1e-12,
with an absolute floor of 1e-12 times the array's largest magnitude —
the Fourier sums are f64 einsums summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.cilia import CiliaModel as JaxCilia
from cuda_iblb_11_tpu_torch.models import cilia as tcilia
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

RTOL = 1e-12
CFG = SimConfig(c_num=4, c_space=48)   # XDIM 192, T 100000, p_step 25000
# it where cilium 3's total it + 3*p_step equals T (phase == T quirk), it
# where cilium 0's does, the start, and steps around a wrap of the beat
ITS = [0, 1, 17, 25_000, 100_000, 99_999, 100_001, 12_345]


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_phase_equals_T_is_exercised():
    totals = np.array(ITS)[:, None] + np.arange(CFG.c_num) * CFG.p_step
    assert (totals == CFG.T).sum() >= 2


def test_tables_match_jax_module():
    from cuda_iblb_11_tpu.models import cilia as jcilia

    for name in ("A_MN_NO_MUCUS", "B_MN_NO_MUCUS", "A_MN_MUCUS",
                 "B_MN_MUCUS"):
        np.testing.assert_array_equal(getattr(tcilia, name),
                                      getattr(jcilia, name))
    np.testing.assert_array_equal(tcilia.node_arclengths(96),
                                  jcilia.node_arclengths(96))


@pytest.mark.parametrize("pattern", ["no_mucus", "mucus"])
def test_positions_and_velocities(pattern):
    jm = JaxCilia(CFG, dtype=jnp.float64, pattern=pattern)
    tm = CiliaModel(CFG, dtype=torch.float64, pattern=pattern)
    its = torch.tensor(ITS)
    pos = tm.positions(its)
    vel = tm.velocities(its)
    assert pos.dtype == vel.dtype == torch.float64
    for k, it in enumerate(ITS):
        _close(pos[k], jm.positions(jnp.int32(it)))
        if it > 0:
            _close(vel[k], jm.velocities(jnp.int32(it)))
    # kinematics: zero velocity at it = 0 (main.cu:147-151)
    _, v = tm.kinematics(its)
    assert torch.all(v[0] == 0)


@pytest.mark.parametrize("cfg", [CFG, SimConfig(c_num=6, c_space=48)])
def test_place_and_mask_and_anchors(cfg):
    jm = JaxCilia(cfg, dtype=jnp.float32)
    tm = CiliaModel(cfg, dtype=torch.float32)
    its = torch.tensor(ITS)
    pos, vel = tm.kinematics(its)
    s, u_s, eps = tm.place_and_mask(pos, vel)
    anchor, frac = tm.anchored_nodes(pos)
    assert eps.dtype == anchor.dtype == torch.int32
    masked = 0
    for k, it in enumerate(ITS):
        jpos, jvel, _ = jm.kinematics(jnp.int32(it), None)
        js, ju, je = jm.place_and_mask(jpos, jvel)
        ja, jf = jm.anchored_nodes(jpos)
        np.testing.assert_array_equal(eps[k].numpy(), np.asarray(je))
        np.testing.assert_array_equal(anchor[k].numpy(), np.asarray(ja))
        # f32 placement: the cast of identical f64 positions is exact
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js))
        _close(u_s[k].double(), np.asarray(ju, np.float64))
        _close(frac[k].double(), np.asarray(jf, np.float64))
        masked += int((eps[k] == 0).sum())
    if cfg.c_num * cfg.c_space < 2 * 2 * cfg.length:
        assert masked > 0   # the overlap mask is exercised
