"""The slice as a whole: the port's MucociliarySim against the JAX one.

(a) f64, plain backend on the CPU, against JAX backend="jnp" over 20 steps:
    f, force and q at rtol 1e-10 (absolute floor 1e-10 of each array's
    scale) — f64 round-off, grown a little by the IB feedback.
(b) f32 reference configuration (1 6 48) for 500 steps against the f64
    golden validation/flux_early_f64_c6.dat within 1e-3 relative, the gate
    of tests/test_golden_flux.py.
(c) checkpoint crossover in both directions, at the tolerance of (a).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu.io import checkpoint as jckpt
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu_torch import MucociliarySim
from cuda_iblb_11_tpu_torch.core.state import state_from_numpy
from cuda_iblb_11_tpu_torch.io import checkpoint as tckpt

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

RTOL = 1e-10
CFG64 = SimConfig(c_num=4, c_space=48, ydim=192, dtype="float64")
GOLD = os.path.join(os.path.dirname(__file__), "..", "validation",
                    "flux_early_f64_c6.dat")


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _close_state(port, jax_state):
    _close(port.f, jax_state.f)
    _close(port.force, jax_state.force)
    _close(port.q, jax_state.q)
    assert port.it == int(jax_state.it)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX jnp f64 states after 10 and 20 steps, as numpy (run_chunk
    donates its input state)."""
    sim = JaxSim(CFG64, backend="jnp")
    s10 = sim.run_chunk(sim.init_state(), 10)
    s10_np = type(s10)(*map(np.asarray, s10))
    s20 = sim.run_chunk(s10, 10)
    return sim, s10_np, type(s20)(*map(np.asarray, s20))


def _port_sim():
    return MucociliarySim(CFG64, backend="torch", device="cpu",
                          dtype=torch.float64)


def test_f64_matches_jax_jnp_20_steps(jax_runs):
    _, _, s20 = jax_runs
    sim = _port_sim()
    st = sim.run_chunk(sim.init_state(), 20)
    assert st.f.dtype == torch.float64
    _close_state(st, s20)
    assert float(st.q) != 0.0
    # the lasts carry and the output fields follow the JAX model too
    jsim = jax_runs[0]
    _close(st.lasts, np.asarray(s20.lasts))
    js20 = type(s20)(*map(jnp.asarray, s20))
    for g, w in zip(sim.fields(st), jsim.fields(js20)):
        _close(g, w)
    for g, w in zip(sim.boundary_fields(st), jsim.boundary_fields(js20)):
        _close(g, w)


def test_f32_reference_config_matches_f64_golden():
    cfg = SimConfig(c_num=6, c_space=48, dtype="float32")
    sim = MucociliarySim(cfg, device="cpu")
    assert sim.backend == "torch" and sim.storage == "deviatoric"
    st = sim.run_chunk(sim.init_state(), 500)
    gold = np.loadtxt(GOLD)
    q_ref = float(gold[gold[:, 0] == 500, 1][0])
    q = float(st.q)
    assert abs(q - q_ref) < 1e-3 * abs(q_ref), (q, q_ref)
    _, u = sim.fields(st)
    assert torch.isfinite(u).all()


def test_checkpoint_jax_to_port(jax_runs, tmp_path):
    _, s10, s20 = jax_runs
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, s10, CFG64)
    state, saved = tckpt.load(path, CFG64)
    # the port's own SimConfig, field for field the JAX one
    assert type(saved) is not type(CFG64)
    assert dataclasses.asdict(saved) == dataclasses.asdict(CFG64)
    st = _port_sim().run_chunk(state, 10)
    _close_state(st, s20)


def test_checkpoint_port_to_jax(jax_runs, tmp_path):
    jsim, _, s20 = jax_runs
    sim = _port_sim()
    path = str(tmp_path / "port.npz")
    tckpt.save(path, sim.run_chunk(sim.init_state(), 10), CFG64)
    state, _ = jckpt.load(path, CFG64)
    assert state.it.dtype == jnp.int32 and state.f.dtype == jnp.float64
    st = jsim.run_chunk(state, 10)
    _close(np.asarray(st.f), s20.f)
    _close(np.asarray(st.q), s20.q)


def test_state_from_numpy_roundtrip(jax_runs):
    _, s10, _ = jax_runs
    st = state_from_numpy(*map(np.asarray, s10), device="cpu")
    assert st.it == 10 and st.f.dtype == torch.float64
    np.testing.assert_array_equal(st.f.numpy(), np.asarray(s10.f))


def test_run_chunk_leaves_input_state_alone():
    sim = _port_sim()
    st0 = sim.run_chunk(sim.init_state(), 3)
    f0 = st0.f.clone()
    sim.run_chunk(st0, 4)
    assert torch.equal(st0.f, f0) and st0.it == 3


def test_resolved_config_and_unported_modes():
    jsim = JaxSim(CFG64, backend="jnp")
    sim = MucociliarySim(CFG64, device="cpu", temporal="auto")
    rc = sim.resolved_config()
    assert set(rc) == set(jsim.resolved_config())
    assert rc["band_leg"] == "single_step" and rc["temporal"] == 1
    # auto takes a K-step leg on the cuda backend only, as JAX on pallas
    assert (rc["temporal_reason"]
            == "auto: backend 'torch' has no temporal path")
    assert rc["backend"] == "torch" and "cpu" in rc["backend_reason"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MucociliarySim(CFG64, device="cpu", temporal=4,
                       ib_x_edge="reference")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MucociliarySim(CFG64, device="cpu", ib_x_edge="reference")
    with pytest.raises(ValueError):
        MucociliarySim(CFG64, device="cpu", backend="cuda")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        MucociliarySim(CFG64)   # device defaults to cuda
