"""The port's sharded path on the CPU (every shard on the one CPU device,
the kernels' plain versions) against the JAX package's single-device jnp
oracle, MucociliarySim(backend="jnp"), in f64: the configurations and
tolerances of tests/test_sharded_temporal.py (f rtol 1e-13 / atol 1e-15,
force rtol 1e-10, q rtol 1e-12), with each case's band leg asserted.

(a) ShardedTemporalSim: (2, 1) K = 2, 4 (band_super_whole); (4, 1) with
    remainder steps; the band spanning shards (ydim 192, 256 on (2, 1) and
    384 on (4, 1)); B8 on (1, 2) and (2, 2) (band_super_xsharded); the
    per-sub-step leg on (2, 2); the phase-general B8 on (2, 4).
(b) ShardedPallasSim, one step per exchange, on (2, 2).
(c) The plan function held to the H100's 52,428,800-byte L2 as a budget
    at 2048^2 and 8192^2 f32 (B8 + B7, B5 + B7, the per-sub-step leg), and
    the sims' own plan, which takes no budget (B8 on 8192^2 (2, 2)); the
    mesh, place/gather and refusals.
"""

import functools

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.state import initial_state
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.temporal import plan_sharded
from cuda_iblb_11_tpu_torch.parallel import (
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

H100_L2 = 52_428_800
F64 = dict(dtype="float64", storage="raw")
CFG2 = dict(c_num=3, c_space=128, ydim=288)


@functools.lru_cache(maxsize=None)
def _oracle(items, n):
    sim = JaxSim(JaxConfig(**dict(items), **F64), backend="jnp")
    st = sim.run_chunk(sim.init_state(), n)
    return np.asarray(st.f), np.asarray(st.force), float(st.q)


def _run(kw, mesh, K, n, leg):
    cfg = SimConfig(**kw, **F64)
    m = make_mesh(*mesh, devices=["cpu"])
    sim = (ShardedPallasSim(cfg, m) if K == 1
           else ShardedTemporalSim(cfg, m, temporal=K))
    assert sim.resolved_config()["band_leg"] == leg
    assert sim.resolved_config()["mesh"] == list(mesh)
    st = sim.run_chunk(sim.init_state(), n)
    assert st.it == n
    return sim, sim.gather_state(st)


def _check(kw, mesh, K, n, leg, force_atol=1e-18):
    f, force, q = _oracle(tuple(sorted(kw.items())), n)
    _, st = _run(kw, mesh, K, n, leg)
    np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(st.force.numpy(), force[:, :st.force.shape[1]],
                               rtol=1e-10, atol=force_atol)
    np.testing.assert_allclose(float(st.q), q, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("K", [2, 4])
def test_temporal_2x1_matches_oracle(K):
    _check(CFG2, (2, 1), K, 8, "band_super_whole")


def test_temporal_four_shards_with_remainder():
    # 10 = 2 super-steps (K = 4) + 2 single steps
    _check(dict(CFG2, ydim=576), (4, 1), 4, 10, "band_super_whole")


@pytest.mark.parametrize("ydim,n_y", [(192, 2), (256, 2), (384, 4)])
def test_temporal_band_spanning_shards(ydim, n_y):
    sim, _ = _run(dict(CFG2, ydim=ydim), (n_y, 1), 4, 0, "band_super_whole")
    assert sim.plan.band_gather
    _check(dict(CFG2, ydim=ydim), (n_y, 1), 4, 8, "band_super_whole")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_temporal_xsharded_band_super(mesh):
    # B8: 2 super-steps + 2 remainder steps; force atol at round-off (the
    # windows' overlap-add re-associates the sums where the oracle's force
    # is exactly zero), as tests/test_sharded_temporal.py:265-270
    _check(dict(c_num=16, c_space=128, ydim=256), mesh, 4, 10,
           "band_super_xsharded", force_atol=1e-15)


def test_temporal_per_substep_tiled_leg():
    _check(CFG2, (2, 2), 4, 10, "per_substep_tiled")


def test_temporal_phase_general_band_super():
    # xl = 640 is no c_space = 256 multiple: the phase-general layout;
    # B8's force atol, as above (one entry at the edge of a delta support
    # differs by 2e-17)
    _check(dict(c_num=10, c_space=256, ydim=288), (2, 4), 4, 8,
           "band_super_xsharded_phase", force_atol=1e-15)


def test_per_step_sharded_matches_oracle():
    _check(CFG2, (2, 2), 1, 6, "sharded_per_step")


def test_flux_is_engaged_and_matches_oracle():
    # 40 steps: the flux column has moved by then (it is exactly 0 over
    # the first few steps, as the oracle's); K = 4 on (2, 2), whose chunk
    # ends in remainder steps on the per-step path
    f, _, q = _oracle(tuple(sorted(CFG2.items())), 42)
    assert abs(q) > 1e-6
    _, st = _run(CFG2, (2, 2), 4, 42, "per_substep_tiled")
    np.testing.assert_allclose(st.f.numpy(), f, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(float(st.q), q, rtol=1e-12)


# --- (c) the rules, the mesh and the state ---------------------------------

@pytest.mark.parametrize("ydim,c_num,mesh,want", [
    (2048, 16, (2, 2), ("band_super_xsharded", 512, 2048)),
    (2048, 16, (1, 2), ("band_super_xsharded", 512, 2048)),
    (2048, 16, (2, 1), ("band_super_whole", None, None)),
    (8192, 64, (2, 2), ("per_substep_tiled", None, None)),
    (8192, 64, (8, 8), ("band_super_xsharded", 512, 2048)),
])
def test_l2_rule_picks_the_legs_on_the_h100(ydim, c_num, mesh, want):
    cfg = SimConfig(c_num=c_num, c_space=128, ydim=ydim)
    plan = plan_sharded(cfg, 16, *mesh, ref.REFERENCE_WALLS, torch.float32,
                        budget=H100_L2)
    lay = plan.xshard
    assert (plan.band_leg, lay and lay.gx, lay and lay.width) == want
    assert plan.K == 16 and plan.pad_s == 16
    if plan.band_leg == "per_substep_tiled":
        # the 5,120-column block (93.9 MB) is over the budget, not the rule
        free = plan_sharded(cfg, 16, *mesh, ref.REFERENCE_WALLS,
                            torch.float32)
        assert free.band_leg == "band_super_xsharded"
        assert free.xshard.width == 5120


def test_mesh_at_8192_takes_b8_on_every_device():
    # the sims plan no budget on any device: 8192^2 on (2, 2) takes B8 on
    # the 5,120-column block, where the card's L2 as a budget took the
    # per-sub-step leg (the test above)
    cfg = SimConfig(c_num=64, c_space=128, ydim=8192)
    sim = ShardedTemporalSim(cfg, make_mesh(2, 2, devices=["cpu"]),
                             temporal=16)
    assert sim.plan == plan_sharded(cfg, 16, 2, 2, ref.REFERENCE_WALLS,
                                    torch.float32)
    assert sim.resolved_config()["band_leg"] == "band_super_xsharded"
    assert sim.plan.xshard.width == 5120


def test_reference_channel_on_2x1_takes_the_tiled_leg():
    # 288 x 192: yl 96 < band + pad (the band gathers across shards) and
    # the 304-column window exceeds the domain
    cfg = SimConfig(c_num=6, c_space=48)
    plan = plan_sharded(cfg, 16, 2, 1, ref.REFERENCE_WALLS, torch.float32,
                        budget=H100_L2)
    assert plan.band_leg == "per_substep_tiled" and plan.band_gather


def test_mesh_and_state_round_trip():
    m = make_mesh(2, 3, devices=["cpu", "cpu"])
    assert m.devices == [torch.device("cpu")] * 6
    assert m.describe() == "2,3 over 1 device(s)"
    assert make_mesh(1, 2).n_devices == 1      # no card here: the CPU
    cfg = SimConfig(**CFG2, **F64)
    sim = ShardedPallasSim(cfg, make_mesh(2, 3, devices=["cpu"]))
    st = initial_state(cfg, torch.float64)
    st = st._replace(f=torch.randn(st.f.shape, dtype=torch.float64),
                     force=torch.randn(st.force.shape, dtype=torch.float64))
    ms = sim.place_state(st)
    assert len(ms.f) == 6 and ms.f[4].shape == (9, 144, 128)
    assert len(ms.force) == 3 and ms.force[1].shape == (2, 128, 128)
    back = sim.gather_state(ms)
    assert torch.equal(back.f, st.f) and torch.equal(back.force, st.force)
    assert back.f.data_ptr() != st.f.data_ptr()


def test_refusals():
    cfg = SimConfig(**CFG2, **F64)
    cpu = make_mesh(2, 1, devices=["cpu"])
    with pytest.raises(ValueError, match="single-shard"):
        ShardedTemporalSim(cfg, make_mesh(1, 1, devices=["cpu"]), temporal=4)
    with pytest.raises(ValueError, match="divide"):
        ShardedPallasSim(cfg, make_mesh(5, 1, devices=["cpu"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShardedPallasSim(cfg, cpu, ib_x_edge="reference")
    with pytest.raises(ValueError, match="CUDA"):
        ShardedPallasSim(cfg, cpu, backend="cuda")
    with pytest.raises(ValueError, match="yl >= 16"):
        ShardedTemporalSim(cfg, make_mesh(24, 1, devices=["cpu"]),
                           temporal=4)
    with pytest.raises(ValueError, match="K=32"):
        ShardedTemporalSim(cfg, cpu, temporal=32)
