"""The port's accuracy-horizon module (cuda_iblb_11_tpu_torch/
accuracy_horizon.py) on the CPU: the f32-vs-f64 gate at 192^2 with 4 cilia
after 500 steps on the torch backend (< 1e-5, tests/test_accuracy_horizon.py
:50-57; the card holds 500 / 2,000 / 4,000 on the hand kernels,
tests/test_torch_cuda.py), its velocity against the JAX script's on the
same state (1e-12), the power-law fit, the lockstep walk, the record
writer and a leg on a few steps."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.ops import ib_band as jax_ib_band
from cuda_iblb_11_tpu.ops import reference as jax_ref
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch import accuracy_horizon as ah
from cuda_iblb_11_tpu_torch.ops import probes

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

CFG64 = SimConfig(c_num=4, c_space=48, dtype="float64", storage="raw")
TINY = dict(c_num=4, c_space=48, length=16, ydim=48)


def test_f32_velocity_error_500_steps():
    s64 = MucociliarySim(CFG64, device="cpu")
    s32 = MucociliarySim(CFG64.replace(dtype="float32", storage="auto"),
                         device="cpu")
    u64 = ah.velocity(s64, s64.run_chunk(s64.init_state(), 500))
    u32 = ah.velocity(s32, s32.run_chunk(s32.init_state(), 500))
    assert u32.dtype == u64.dtype == torch.float64
    assert ah.rel_l2(u32, u64) < 1.0e-5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_velocity_matches_the_jax_script(dtype):
    cfg = SimConfig(dtype=dtype, **TINY)
    sim = MucociliarySim(cfg, device="cpu")
    st = sim.run_chunk(sim.init_state(), 6)
    got = ah.velocity(sim, st).numpy()
    force = jax_ib_band.pad_band(jnp.asarray(st.force.numpy()), cfg.ydim)
    _, want = jax_ref.corrected_velocity(
        jnp.asarray(st.f.numpy()).astype(jnp.float64),
        force.astype(jnp.float64), sim.storage)
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 1e-6
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


def test_fit_power_recovers_a_known_law():
    n = np.array([500, 1000, 2000, 4000, 8000])
    a, p = ah.fit_power(n, 8.2e-9 * n ** 1.03)
    assert a == pytest.approx(8.2e-9, rel=1e-9)
    assert p == pytest.approx(1.03, rel=1e-9)
    rows = [{"pair": "x", "steps": int(k), "rel_l2": 2e-7 * k ** 0.5}
            for k in n] + [{"pair": "y", "steps": 5, "rel_l2": 1.0}]
    fits = ah.fits(rows)
    assert set(fits) == {"x"}           # "y" has one row
    assert fits["x"]["p"] == pytest.approx(0.5, rel=1e-9)


def test_walk_two_horizons():
    cfg64 = SimConfig(dtype="float64", storage="raw", **TINY)
    sims = {"f64": MucociliarySim(cfg64, device="cpu"),
            "f32": MucociliarySim(cfg64.replace(dtype="float32",
                                                storage="auto"),
                                  device="cpu")}
    rows, states = ah.walk(sims, (2, 5), "tiny")
    assert [(r["pair"], r["steps"]) for r in rows] == [
        ("f32_vs_f64", 2), ("f32_vs_f64_flux", 2),
        ("f32_vs_f64", 5), ("f32_vs_f64_flux", 5)]
    assert {r["label"] for r in rows} == {"tiny"}
    assert states["f64"].it == states["f32"].it == 5
    # the walk's last rows are those of the two runs made in one go
    direct = {k: s.run_chunk(s.init_state(), 5) for k, s in sims.items()}
    e = ah.rel_l2(ah.velocity(sims["f32"], direct["f32"]),
                  ah.velocity(sims["f64"], direct["f64"]))
    q64 = float(direct["f64"].q)
    qd = abs(float(direct["f32"].q) - q64) / max(abs(q64), 1e-30)
    assert 0 < rows[2]["rel_l2"] == pytest.approx(e, rel=1e-12)
    assert rows[3]["rel_l2"] == pytest.approx(qd, rel=1e-12, abs=1e-18)


def test_write_record_merges_legs(tmp_path):
    path = str(tmp_path / "sub" / "rec.json")
    probes.write_record(path, "a", {"x": 1})
    probes.write_record(path, "b", {"y": 2})
    probes.write_record(path, "a", {"x": 3})
    with open(path) as fh:
        assert json.load(fh) == {"a": {"x": 3}, "b": {"y": 2}}
    assert os.listdir(tmp_path / "sub") == ["rec.json"]


def test_leg_on_a_few_steps(tmp_path):
    entry = ah.run_leg("192sq", "cpu", (2, 3, 4))
    assert entry["card"] is None and entry["device"] == "cpu"
    assert {"torch", "cuda", "date"} <= set(entry)
    assert entry["grid"] == [192, 192] and entry["horizons"] == [2, 3, 4]
    assert entry["reduced"] and "horizons" in entry["reduced"][0]
    assert list(entry["sims"]) == ["f64_oracle", "f32", "f32_auto"]
    assert entry["sims"]["f64_oracle"]["dtype"] == "float64"
    assert entry["sims"]["f32_auto"]["temporal_requested"] == "auto"
    pairs = {r["pair"] for r in entry["rows"]}
    assert pairs == {"f32_vs_f64_oracle", "f32_vs_f64_oracle_flux",
                     "f32_auto_vs_f64_oracle", "f32_auto_vs_f64_oracle_flux",
                     "f32_auto_vs_f32", "f32_auto_vs_f32_flux"}
    assert "f32_vs_f64_oracle" in entry["fits"]
    out = tmp_path / "ah.json"
    with pytest.raises(SystemExit):
        ah.main(["cpu_full", "--device", "cpu", "--json", str(out)])
    assert not out.exists()


def test_entry_point_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="is_available"):
        ah.main(["192sq", "--json", str(tmp_path / "x.json")])
    assert not list(tmp_path.iterdir())
