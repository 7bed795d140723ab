"""The port's cavity sweep (cuda_iblb_11_tpu_torch/validate_cavity.py) on
the CPU at a few hundred steps: each case's centreline at Ghia's y equals
the JAX cavity model's after the same steps (f64, 1e-12 of the lid
speed), its deviation from Ghia is the one the JAX script computes, and
the sweep lists its cut; without a card the entry point raises.  The
sweep at full length is the card's (cuda_iblb_11_tpu_torch/records/
cavity_metrics.json, gated by tests/test_torch_records.py)."""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.models.cavity import LidDrivenCavity as JaxCavity
from cuda_iblb_11_tpu_torch import validate_cavity as vc

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)


def test_ghia_tables_are_the_jax_scripts():
    # scripts/validate_cavity.py:30-44, transcribed
    assert vc.RUNS == {100: (64, 30000), 400: (96, 80000),
                       1000: (128, 200000)}
    assert set(vc.GHIA) == set(vc.RUNS) == set(vc.GATES)
    for y, ux in vc.GHIA.values():
        assert len(y) == len(ux) == 7 and list(y) == sorted(y)


@pytest.mark.parametrize("re_n", [100, 1000])
def test_case_matches_the_jax_cavity(re_n):
    n = 32
    steps = 300
    got = vc.run_case(re_n, n, steps, torch.float64, "cpu")
    jc = JaxCavity(n=n, re=float(re_n), u_lid=vc.U_LID)
    ux, _ = jc.centreline_profiles(jc.run(jc.init_f(), steps))
    gy, gux = vc.GHIA[re_n]
    want = np.interp(gy, (np.arange(n) + 0.5) / n, np.asarray(ux))
    np.testing.assert_allclose(got["ux_centreline_at_ghia_y"], want,
                               rtol=0, atol=1e-12)
    assert got["max_dev_ux"] == pytest.approx(
        float(np.max(np.abs(want - np.asarray(gux)))), abs=1e-12)
    assert got["tau"] == jc.tau and got["steps"] == steps
    assert got["gate"] == vc.GATES[re_n]
    assert got["passed"] == (got["max_dev_ux"] <= got["gate"])


def test_sweep_records_the_cut():
    entry = vc.sweep("cpu", 0.002)
    assert entry["card"] is None and entry["dtype"] == "float32"
    assert entry["reduced"] == ["steps scaled by 0.002"]
    assert sorted(int(k) for k in entry["cases"]) == [100, 400, 1000]
    case = entry["cases"]["100"]
    assert case["grid"] == 64 and case["steps"] == 60 and case["finite"]


def test_entry_point_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="is_available"):
        vc.main(["--json", str(tmp_path / "x.json")])
    assert not list(tmp_path.iterdir())
