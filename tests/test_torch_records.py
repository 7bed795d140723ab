"""The card's committed records (cuda_iblb_11_tpu_torch/records/, written
by the port's validation modules on an NVIDIA H100) hold the gates the
port is accepted by.  Each record names the card and its power limit as
nvidia-smi gives them, the torch and CUDA versions, the date and its cuts
against the JAX run; and:

- at 192^2 with 4 cilia over the whole 100,000-step beat, f32 single-step
  and f32 auto against the f64 run: flux < 1% and velocity < 2e-3
  (tests/test_accuracy_horizon.py:126-127), the same at 384 x 192, and
  < 1e-5 / 3e-5 / 8e-5 at 500 / 2,000 / 4,000 steps with the 4,000-step
  error < 12 x the 500-step one (:50-73);
- 2048^2 temporal auto against single-step <= 1e-5 at every horizon to
  32,768 steps;
- the card's f64 beat against the JAX golden validation/
  fullbeat_f64_192sq.npz: velocity and flux <= 1e-8
  (tests/test_f64_tpu.py:103-104);
- the cavity within 0.02 / 0.02 / 0.03 lid units of Ghia at Re 100 / 400
  / 1000 at the JAX sweep's full length;
- the four BigData configurations, each overlapped run leaving the serial
  run's bytes;
- the metachrony sweep at 2048^2 (16 cilia), 8 points over the whole
  beat in f32 and f64: f32 Q within 1% of f64 at every point, each beat
  6,250 B5 and 6,250 B4 launches and no B2 on band_super_whole at K = 16,
  the distance to the JAX record and both dtypes' argmax reported;
- the reference channel's beat (validate_flux) in f32 and f64, 100
  samples each: f32 final Q within 1% of f64, f64's first 2,000 steps
  within 1e-9 and f32's within 2e-5 of validation/flux_early_f64_c6.dat,
  one B2 launch a step, the distance to the TPU's curve reported.
"""

import json
import os
import re

import pytest

from cuda_iblb_11_tpu_torch.validate_cavity import GATES, RUNS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(REPO, "cuda_iblb_11_tpu_torch", "records")
CARD = re.compile(r"^NVIDIA .+, \d+\.\d+ W$")
BEAT = 100_000
F32_PAIRS = ("f32_vs_f64_oracle", "f32_auto_vs_f64_oracle")


def _load(name):
    with open(os.path.join(RECORDS, f"{name}.json")) as fh:
        return json.load(fh)


def _rows(entry):
    return {(r["pair"], r["steps"]): r["rel_l2"] for r in entry["rows"]}


@pytest.mark.parametrize("name", ["accuracy_horizon", "f64",
                                  "cavity_metrics", "bigdata_e2e",
                                  "metachrony", "validate_flux"])
def test_record_names_the_card_and_its_cuts(name):
    record = _load(name)
    assert record
    for key, entry in record.items():
        assert CARD.match(entry["card"]), (key, entry["card"])
        assert entry["device"] in entry["card"]
        assert entry["torch"] and entry["cuda"], key
        assert re.match(r"^\d{4}-\d\d-\d\d$", entry["date"]), key
        assert isinstance(entry["reduced"], list), key


def test_probe_vpu_record_holds_the_identity_ab():
    rec = _load("probe_vpu")
    assert CARD.match(rec["card"])
    ab = rec["identity_collide_ab"]
    assert ab["variant_flags"] == ["-DIBLB_IDENTITY_COLLIDE"]
    assert ab["full"]["band_leg"] == ab["identity"]["band_leg"] \
        == "band_super_whole"
    assert ab["identity_mlups"] > ab["full_mlups"] > 0
    assert ab["collide_ps_per_site"] == pytest.approx(
        1e6 / ab["full_mlups"] - 1e6 / ab["identity_mlups"])
    assert ab["device_collide_ps_per_site"] > 0


def test_full_beat_f32_against_f64():
    for leg in ("full", "mid"):
        entry = _load("accuracy_horizon")[leg]
        assert entry["horizons"][-1] == BEAT and entry["reduced"] == []
        rows = _rows(entry)
        for pair in F32_PAIRS:
            assert rows[(pair + "_flux", BEAT)] < 0.01, (leg, pair)
            assert rows[(pair, BEAT)] < 2e-3, (leg, pair)
        sims = entry["sims"]
        assert sims["f64_oracle"]["dtype"] == "float64"
        assert sims["f64_oracle"]["storage"] == "raw"
        assert sims["f32"]["band_leg"] == "single_step"
        assert sims["f32_auto"]["temporal"] == 16
        assert sims["f32_auto"]["band_leg"] == (
            "per_substep" if leg == "full" else "band_super_whole")
        assert {s["backend"] for s in sims.values()} == {"cuda"}


def test_192sq_gates_at_500_2000_4000():
    rows = _rows(_load("accuracy_horizon")["full"])
    for pair in F32_PAIRS:
        for n, gate in ((500, 1e-5), (2000, 3e-5), (4000, 8e-5)):
            assert rows[(pair, n)] < gate, (pair, n)
        assert rows[(pair, 4000)] < 12.0 * rows[(pair, 500)], pair


def test_2048_auto_against_single_step():
    entry = _load("accuracy_horizon")["2048"]
    assert entry["horizons"] == [512, 2048, 8192, 32768]
    assert entry["reduced"] == [] and entry["grid"] == [2048, 2048]
    rows = _rows(entry)
    for n in entry["horizons"]:
        assert rows[("temporal_auto_vs_single_step_f32", n)] <= 1e-5, n
    auto = entry["sims"]["temporal_auto"]
    assert (auto["temporal"], auto["band_leg"]) == (16, "band_super_whole")
    assert entry["sims"]["single_step_f32"]["band_leg"] == "single_step"


def test_f64_beat_against_the_jax_golden():
    leg = _load("f64")["fullbeat"]
    assert leg["steps"] == BEAT and leg["grid"] == [192, 192]
    assert leg["golden"] == "validation/fullbeat_f64_192sq.npz"
    assert leg["vel_rel_l2_vs_jax_f64"] <= 1e-8
    assert leg["q_rel_vs_jax_f64"] <= 1e-8
    assert leg["passed"] and leg["mlups_steady"] > 0
    assert (leg["sim"]["backend"], leg["sim"]["dtype"],
            leg["sim"]["storage"]) == ("cuda", "float64", "raw")
    # the beat is held against the golden in this record alone
    assert "f64_vs_jax_golden" not in _load("accuracy_horizon")["full"]


def test_f64_rate_at_2048():
    leg = _load("f64")["rate2048"]
    assert set(leg["runs"]) == {"f64_auto", "f64_single_step", "f32_auto"}
    for r in leg["runs"].values():
        # the rate over every timed window, not the best of them
        assert r["finite"] and len(r["wall_s_windows"]) == leg["windows"]
        assert r["mlups_steady"] == pytest.approx(
            2048 * 2048 * leg["window_steps"] * leg["windows"]
            / sum(r["wall_s_windows"]) / 1e6)
    assert leg["sims"]["f64_auto"]["band_leg"] == "band_super_whole"
    assert leg["velocity_rel_l2"]["f64_auto_vs_f64_single_step"] <= 1e-10


def test_cavity_sweep_against_ghia():
    entry = _load("cavity_metrics")["sweep"]
    assert entry["reduced"] == [] and entry["dtype"] == "float32"
    assert sorted(int(k) for k in entry["cases"]) == sorted(RUNS)
    for re_n, case in entry["cases"].items():
        n, steps = RUNS[int(re_n)]
        assert (case["grid"], case["steps"]) == (n, steps)
        assert case["finite"]
        assert case["max_dev_ux"] <= GATES[int(re_n)], re_n


def test_bigdata_four_configurations():
    entry = _load("bigdata_e2e")["bigdata"]
    assert entry["config"]["grid"] == "2048x2048"
    assert (entry["config"]["iterations"], entry["config"]["p_num"],
            entry["config"]["interval"]) == (10_000, 10, 1000)
    assert len(entry["reduced"]) == 2
    keys = {(r["format"], r["overlap"]) for r in entry["runs"]}
    assert keys == {("dat", True), ("dat", False), ("npz", True),
                    ("npz", False)}
    assert len(entry["runs"]) == 4 * entry["repeats"] >= 8
    for fmt, faster in entry["summary"]["faster"].items():
        assert faster["same_bytes"], fmt
    for r in entry["runs"]:
        assert r["bytes_written"] > 0 and r["mlups_end_to_end"] > 0
        assert r["resolved"]["band_leg"] == "band_super_whole"
        # every snapshot pair's write timed, on the worker thread exactly
        # when overlapped
        assert len(r["writes"]) == 10
        assert all(w["main_thread"] is not r["overlap"] for w in r["writes"])
    alone = entry["writer_alone"]["dat"]
    assert len(alone["main"]) == len(alone["worker"]) >= 3


def test_metachrony_sweep_f32_against_f64():
    entry = _load("metachrony")["sweep"]
    points = [1, 2, 3, 4, 6, 8, 12, 16]
    assert entry["reduced"] == [] and entry["grid"] == [2048, 2048]
    assert (entry["c_num"], entry["c_space"]) == (16, 128)
    assert entry["points"] == points
    assert (entry["steps"], entry["chunks"], entry["temporal"]) == (
        BEAT, 10, 16)
    for dt in ("float32", "float64"):
        runs = entry["runs"][dt]
        assert set(runs) == {str(cf) for cf in points}
        for cf, p in runs.items():
            assert p["launches"] == {"B5 band_super": 6250,
                                     "B4 temporal_bulk": 6250,
                                     "B2 fused_step": 0}, (dt, cf)
            sim = p["sim"]
            assert (sim["band_leg"], sim["temporal"], sim["backend"],
                    sim["dtype"]) == ("band_super_whole", 16, "cuda", dt)
            assert p["finite"] and p["steps"] == BEAT and p["mlups"] > 0
            assert len(p["q_chunks"]) == 10
        qs = {int(cf): p["q_per_beat"] for cf, p in runs.items()}
        assert entry["argmax_c_fraction"][dt] == max(qs, key=qs.get)
    for cf in map(str, points):
        q32, q64 = (entry["runs"][d][cf]["q_per_beat"]
                    for d in ("float32", "float64"))
        assert abs(q32 - q64) < 0.01 * abs(q64), cf
        assert entry["f32_vs_f64"][cf] == pytest.approx(abs(q32 - q64)
                                                        / abs(q64))
    # reported beside the gate, not gated: the JAX package's TPU record
    assert entry["jax_record"] == "validation/metachrony.json"
    assert entry["jax_argmax_c_fraction"] == 4
    assert set(entry["jax_distance"]["float64"]) == set(entry["f32_vs_f64"])


def test_reference_channel_beat():
    entry = _load("validate_flux")["reference_channel"]
    assert entry["reduced"] == []
    assert entry["config"] == {"c_num": 6, "c_space": 48}
    legs = entry["legs"]
    assert set(legs) == {"float32", "float64"}
    for dt, leg in legs.items():
        assert (leg["steps"], leg["samples"]) == (BEAT, 100)
        assert leg["grid"] == [192, 288] and len(leg["q"]) == 100
        assert leg["finite"] and leg["final_q"] == leg["q"][-1]
        assert leg["launches"]["B2 fused_step"] == BEAT
        assert sum(leg["launches"].values()) == BEAT
        assert (leg["sim"]["backend"], leg["sim"]["temporal"],
                leg["sim"]["dtype"]) == ("cuda", 1, dt)
        rows = leg["early"]["rows"]
        assert [r["it"] for r in rows] == list(range(100, 2001, 100))
        assert leg["early"]["max_rel"] <= (1e-9 if dt == "float64"
                                           else 2e-5), dt
    assert legs["float64"]["sim"]["storage"] == "raw"
    assert entry["f32_vs_f64"]["final_rel"] < 0.01
    assert entry["f32_vs_f64"]["final_rel"] == pytest.approx(
        abs(legs["float32"]["final_q"] - legs["float64"]["final_q"])
        / abs(legs["float64"]["final_q"]))
    tpu = entry["tpu_curve"]
    assert tpu["curve"] == "validation/flux_trt_split_c6.dat"
    assert tpu["t_ms"] > 60 and tpu["shape_correlation"] > 0
