"""The strict-parity quirk mode (ib_x_edge="reference") of the port's
MucociliarySim against the JAX model's (backend "jnp"), f64 on the CPU:
64 steps, f, force and q at rtol 1e-12 with an absolute floor of 1e-12 of
each array's scale (measured about 2e-14: round-off of the same arithmetic,
the spread summed as a matmul where JAX scatter-adds, grown a little by the
IB feedback).  The K-step quirk leg (per sub-step, the stencil IB after
each B3 step) against the single step at the same gate.
"""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu_torch import MucociliarySim
from cuda_iblb_11_tpu_torch import SimConfig as PortConfig
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.temporal import plan_auto

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

CFG64 = SimConfig(c_num=4, c_space=48, ydim=192, dtype="float64")
STEPS = 64


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.fixture(scope="module")
def port_k1():
    sim = MucociliarySim(CFG64, device="cpu", ib_x_edge="reference")
    return sim, sim.run_chunk(sim.init_state(), STEPS)


def test_quirk_matches_jax_jnp(port_k1):
    jsim = JaxSim(CFG64, backend="jnp", ib_x_edge="reference")
    js = jsim.run_chunk(jsim.init_state(), STEPS)
    _, st = port_k1
    for name in ("f", "force", "q"):
        _close(getattr(st, name), getattr(js, name))
    assert st.it == STEPS
    # the quirk changes the result: the periodic run is another one
    per = MucociliarySim(CFG64, device="cpu")
    assert abs(float(per.run_chunk(per.init_state(), STEPS).q)
               - float(st.q)) > 1e-6 * abs(float(st.q))


def test_quirk_k_step_leg_matches_single_step(port_k1):
    sim1, st1 = port_k1
    sim = MucociliarySim(CFG64, device="cpu", ib_x_edge="reference",
                         temporal=4)
    rc = sim.resolved_config()
    assert rc["temporal"] == 4 and rc["band_leg"] == "per_substep"
    st = sim.run_chunk(sim.init_state(), STEPS)
    for name in ("f", "force", "q"):
        _close(getattr(st, name), getattr(st1, name))
    assert sim1.resolved_config()["band_leg"] == "single_step"


def test_quirk_resolved_config_names_the_stencil_path(port_k1):
    sim, _ = port_k1
    rc = sim.resolved_config()
    assert rc["ib_path"] == "stencil_quirk"
    assert rc == {**rc, "backend": "torch", "temporal": 1}
    jrc = JaxSim(CFG64, backend="jnp",
                 ib_x_edge="reference").resolved_config()
    assert set(rc) == set(jrc) and jrc["ib_path"] == rc["ib_path"]


@pytest.mark.parametrize("grid", [dict(c_num=6, c_space=48),
                                  dict(c_num=16, c_space=128, ydim=2048)])
@pytest.mark.parametrize("budget", [None, 50 * 2**20])
def test_quirk_auto_plans_k16_per_substep(grid, budget):
    # the quirk mode never takes a band super-step (its windowed IB is
    # periodic): auto gives K = 16 on the per-sub-step leg at the
    # reference's 288 x 192 and at 2048^2, with or without the card's L2
    plan, reason = plan_auto(PortConfig(**grid), ref.REFERENCE_WALLS,
                             torch.float32, ib_x_edge="reference",
                             budget=budget)
    assert (plan.K, plan.band_leg) == (16, "per_substep")
    assert reason == "auto: K=16 (largest eligible)"
