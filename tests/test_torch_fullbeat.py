"""The port's full-beat f64 run (cuda_iblb_11_tpu_torch/
make_fullbeat_golden.py) and its check against the JAX golden
(probe_f64.py's fullbeat leg), on the CPU at 8 steps: the port's npz
equals the JAX jnp f64 run of the same steps to 1e-12 and carries the JAX
golden's keys and dtypes; the fullbeat leg holds the port against a golden
in the JAX format made by the JAX run and passes its 1e-8 gate.  The
100,000-step run is the card's (cuda_iblb_11_tpu_torch/records/f64.json,
gated by tests/test_torch_records.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops import ib_band as jax_ib_band
from cuda_iblb_11_tpu.ops import reference as jax_ref
from cuda_iblb_11_tpu_torch import make_fullbeat_golden, probe_f64

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GOLDEN = os.path.join(REPO, "validation", "fullbeat_f64_192sq.npz")
STEPS = 8


@pytest.fixture(scope="module")
def jax_golden(tmp_path_factory):
    """The JAX script's golden (scripts/make_fullbeat_golden.py:43-58) of
    STEPS steps, in its format."""
    cfg = JaxConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
    sim = JaxSim(cfg, backend="jnp")
    st = sim.run_chunk(sim.init_state(), STEPS)
    force = jax_ib_band.pad_band(st.force, cfg.ydim)
    _, u = jax_ref.corrected_velocity(st.f, force, sim.storage)
    assert u.dtype == jnp.float64
    path = str(tmp_path_factory.mktemp("jax") / "golden.npz")
    np.savez_compressed(
        path, u=np.asarray(u, np.float64), q=float(st.q), steps=STEPS,
        xdim=cfg.xdim, ydim=cfg.ydim, c_num=cfg.c_num, c_space=cfg.c_space)
    return path


def test_golden_equals_the_jax_run(tmp_path, jax_golden):
    out = tmp_path / "port.npz"
    assert make_fullbeat_golden.main(["--steps", str(STEPS), "--device",
                                      "cpu", "--out", str(out)]) == 0
    got, want = np.load(out), np.load(jax_golden)
    ref = np.load(JAX_GOLDEN)
    # the committed JAX golden's keys and dtypes
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype and got[k].ndim == ref[k].ndim, k
    assert got["u"].shape == ref["u"].shape
    for k in ("steps", "xdim", "ydim", "c_num", "c_space"):
        assert int(got[k]) == int(want[k]), k
    assert int(got["steps"]) == STEPS
    rel = np.linalg.norm(got["u"] - want["u"]) / np.linalg.norm(want["u"])
    assert rel <= 1e-12, rel
    assert abs(float(got["q"]) - float(want["q"])) <= 1e-12 * abs(
        float(want["q"]))


def test_fullbeat_leg_against_a_jax_golden(tmp_path, jax_golden):
    leg = probe_f64.leg_fullbeat("cpu", jax_golden,
                                 str(tmp_path / "own.npz"))
    assert leg["steps"] == STEPS and leg["grid"] == [192, 192]
    assert leg["card"] is None and leg["device"] == "cpu"
    assert leg["vel_rel_l2_vs_jax_f64"] <= 1e-12
    assert leg["q_rel_vs_jax_f64"] <= 1e-12
    assert leg["passed"] and leg["gate"] == 1e-8
    assert leg["sim"]["dtype"] == "float64" and leg["sim"]["storage"] == "raw"
    assert leg["sim"]["temporal"] == 1
    assert (tmp_path / "own.npz").exists()


def test_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    for main in (lambda: make_fullbeat_golden.main(
                     ["--steps", "2", "--out", str(tmp_path / "g.npz")]),
                 lambda: probe_f64.main(["rate2048", "--json",
                                         str(tmp_path / "x.json")])):
        with pytest.raises(RuntimeError, match="is_available"):
            main()
    assert not list(tmp_path.iterdir())
