"""The port's validate_flux (cuda_iblb_11_tpu_torch/validate_flux.py)
against the JAX script scripts/validate_flux.py on the CPU, loaded as
tests/test_plotting.py loads a script:

- the printed curve of 200 f64 steps in 10 samples equals the JAX
  script's, and every sample's Q equals the JAX run's to rtol 1e-10;
- the comparison with a nominal curve in flux_nom.dat's format (a file
  the test writes, fed to the JAX script through its load_nominal):
  the same shape correlation, final Q and monotone fraction;
- the record of an f32 run: both legs, each leg's early samples against
  validation/flux_early_f64_c6.dat in lattice units (f64 <= 1e-9, f32
  <= 2e-5), f32 against f64, the TPU curve's distance, every key;
- without a card the entry point raises.

The 100,000-step beat is the card's (cuda_iblb_11_tpu_torch/records/
validate_flux.json, gated by tests/test_torch_records.py)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu_torch import validate_flux

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(REPO, "scripts", "validate_flux.py")
ARGS = ["--steps", "200", "--samples", "10", "--dtype", "float64"]


def _jax_script():
    spec = importlib.util.spec_from_file_location("validate_flux_jax",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _curve(text):
    lines = text.splitlines()
    head = lines.index("# t_ms\tQ_scaled")
    return np.array([[float(v) for v in ln.split("\t")]
                     for ln in lines[head + 1:]])


def _run_jax(monkeypatch, capsys, args, nominal=None):
    """The JAX script's main() on ``args``: (stdout, stderr, the Q of each
    sample in full precision)."""
    from cuda_iblb_11_tpu.models import mucociliary

    qs = []
    run_chunk = mucociliary.MucociliarySim.run_chunk

    def sampled(self, state, n):
        state = run_chunk(self, state, n)
        qs.append(float(state.q))
        return state

    monkeypatch.setattr(mucociliary.MucociliarySim, "run_chunk", sampled)
    mod = _jax_script()
    monkeypatch.setattr(mod, "load_nominal", lambda: nominal)
    monkeypatch.setattr(sys, "argv", ["validate_flux.py"] + args)
    capsys.readouterr()
    mod.main()
    out = capsys.readouterr()
    monkeypatch.undo()
    return out.out, out.err, qs


def _run_port(capsys, args, tmp_path):
    path = tmp_path / "vf.json"
    capsys.readouterr()
    assert validate_flux.main(args + ["--device", "cpu", "--json",
                                      str(path)]) == 0
    out = capsys.readouterr()
    with open(path) as fh:
        return out.out, out.err, json.load(fh)["reference_channel"]


def test_curve_equals_the_jax_script(monkeypatch, capsys, tmp_path):
    jout, _, jqs = _run_jax(monkeypatch, capsys, ARGS)
    pout, _, rec = _run_port(capsys, ARGS, tmp_path)
    assert pout.startswith("# t_ms\tQ_scaled\n")
    assert pout.splitlines() == jout.splitlines()
    want, got = _curve(jout), _curve(pout)
    assert got.shape == (11, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    leg = rec["legs"]["float64"]
    np.testing.assert_allclose(leg["q"], jqs, rtol=1e-10, atol=0)
    # the record's curve is the printed one, unrounded
    np.testing.assert_allclose(np.array(leg["curve"]), got, rtol=1e-5)
    assert set(rec["legs"]) == {"float64"} and "f32_vs_f64" not in rec


def test_comparison_equals_the_jax_script(monkeypatch, capsys, tmp_path):
    # a nominal in flux_nom.dat's layout: 101 rows of t_ms, Q x_scale
    t = np.linspace(0.0, 0.2, 101)
    nom_file = tmp_path / "flux_nom.dat"
    np.savetxt(nom_file, np.stack([t, 3.0 * t + 0.02 * np.sin(40 * t)], 1))
    nom = validate_flux.load_nominal(str(nom_file))
    assert nom.shape == (101, 2)
    assert validate_flux.load_nominal(str(tmp_path / "absent.dat")) is None
    # the default lies in the checkout, where nothing is committed yet
    assert validate_flux.NOMINAL == os.path.join(REPO, "validation",
                                                 "flux_nom.dat")
    assert validate_flux.load_nominal() is None

    args = ["--steps", "24", "--samples", "12", "--dtype", "float64"]
    jout, jerr, _ = _run_jax(monkeypatch, capsys, args, nominal=nom)
    monkeypatch.setattr(validate_flux, "load_nominal", lambda: nom)
    pout, perr, rec = _run_port(capsys, args, tmp_path)
    lines = [ln for ln in jerr.splitlines() if ln.startswith("# ")]
    assert len(lines) == 3 and "shape correlation" in lines[0]
    assert lines == [ln for ln in perr.splitlines()
                     if ln.startswith(("# shape", "# final Q",
                                       "# monotone"))]
    ts, qs = np.array(rec["legs"]["float64"]["curve"]).T
    cmp = rec["nominal"]
    assert cmp == validate_flux.compare_nominal(ts, qs, nom)
    assert f"{cmp['shape_correlation']:.4f}" in lines[0]
    assert f"ours={cmp['final_q']:.2f}  nominal={cmp['final_q_nominal']:.2f}" \
        in lines[1]
    assert f"{cmp['monotone_fraction']:.3f}" in lines[2]
    # 10 samples or fewer: no comparison, as in the JAX script
    assert validate_flux.compare_nominal(ts[:10], qs[:10], nom) is None


def test_record_of_an_f32_run(capsys, tmp_path):
    _, _, rec = _run_port(capsys, ["--steps", "200", "--samples", "10"],
                          tmp_path)
    assert rec["card"] is None and rec["device"] == "cpu"
    assert rec["config"] == {"c_num": 6, "c_space": 48}
    assert rec["nominal"] is None and rec["reduced"]
    assert set(rec["legs"]) == {"float32", "float64"}
    for dt, leg in rec["legs"].items():
        assert leg["steps"] == 200 and leg["grid"] == [192, 288]
        assert leg["finite"] and leg["sim"]["temporal"] == 1
        assert leg["sim"]["dtype"] == dt and leg["sim"]["backend"] == "torch"
        assert leg["sim"]["storage"] == ("raw" if dt == "float64"
                                         else "deviatoric")
        # the CPU launches no kernel
        assert set(leg["launches"].values()) == {0}
        early = leg["early"]
        assert early["golden"] == "validation/flux_early_f64_c6.dat"
        assert [r["it"] for r in early["rows"]] == [100, 200]
        assert early["max_rel"] <= (1e-9 if dt == "float64" else 2e-5)
        assert len(leg["curve"]) == 11 and len(leg["q"]) == 10
    q32, q64 = (np.array(rec["legs"][d]["q"]) for d in ("float32",
                                                         "float64"))
    cmp = rec["f32_vs_f64"]
    np.testing.assert_allclose(cmp["rel"], np.abs(q32 - q64) / np.abs(q64))
    assert cmp["final_rel"] == pytest.approx(cmp["rel"][-1])
    assert cmp["max_rel"] < 1e-4
    tpu = rec["tpu_curve"]
    assert tpu["curve"] == "validation/flux_trt_split_c6.dat"
    assert set(tpu) == {"curve", "shape_correlation",
                        "max_normalized_deviation", "t_ms", "q_ratio"}


def test_compare_curve_of_a_curve_with_itself():
    ref = validate_flux.load_curve(validate_flux.TPU_CURVE)
    assert ref.shape == (101, 2)
    cmp = validate_flux.compare_curve(ref[:, 0], ref[:, 1], ref)
    assert cmp["shape_correlation"] == pytest.approx(1.0)
    assert cmp["max_normalized_deviation"] == 0.0
    assert cmp["q_ratio"] == 1.0 and cmp["t_ms"] == ref[-1, 0]


def test_entry_point_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        validate_flux.main(["--steps", "2", "--samples", "1", "--json",
                            str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
