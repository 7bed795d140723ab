"""The step profiler (cuda_iblb_11_tpu_torch/profile_step.py) on the CPU:
it runs, and its device fields say "not measured" (None) without a card."""

import pytest
import torch

from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch import profile_step

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)


@pytest.mark.parametrize("ranges, want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)], 4.0),   # overlap and a gap
    ([(4.0, 5.0), (0.0, 10.0)], 10.0),              # nested, unsorted
])
def test_union_us(ranges, want):
    assert profile_step._union_us(ranges) == want


def test_profile_sim_on_cpu():
    sim = MucociliarySim(SimConfig(c_num=4, c_space=48, length=16, ydim=48),
                         device="cpu", dtype=torch.float32)
    row = profile_step.profile_sim(sim, steps=2)
    assert row["steps"] == 2 and row["wall_ms"] > 0
    assert row["profiled_wall_ms"] > 0
    assert row["device_busy_ms"] is None and row["idle_share"] is None
    assert row["device_kernels"] == 0 and row["launch_calls"] == 0
    assert row["top_kernels"] == []
    assert row["aten_ops"] > 10   # the eager step is many small ops
    # the single-step path's spans, from the unprofiled run
    host = row["host_us_per_step"]
    assert set(host) == {"iblb.run_chunk", "iblb.steps_single",
                         "iblb.kinematics", "iblb.B2", "iblb.ib"}
    assert 0 < host["iblb.B2"] < host["iblb.steps_single"] \
        <= host["iblb.run_chunk"] <= 1e3 * row["wall_ms"]


@pytest.mark.parametrize("K", [2, 4])
def test_profile_sim_temporal_on_cpu(K):
    # the --temporal option's path: the sim resolves a K-step leg and the
    # profiler runs whole super-steps of it
    sim = MucociliarySim(SimConfig(c_num=4, c_space=48, length=16, ydim=112),
                         device="cpu", dtype=torch.float32, temporal=K)
    assert sim.temporal == K
    row = profile_step.profile_sim(sim, steps=K)
    assert row["steps"] == K and row["wall_ms"] > 0
    assert row["device_busy_ms"] is None and row["aten_ops"] > 10
    host = row["host_us_per_step"]
    assert {"iblb.steps_temporal", "iblb.B4"} <= set(host)
    assert "iblb.steps_single" not in host


def test_main_parses_temporal(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_sim(cfg, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(profile_step, "MucociliarySim", fake_sim)
    for arg, want in (("auto", "auto"), ("16", 16)):
        with pytest.raises(Stop):
            profile_step.main(["--grids", "288x192", "--temporal", arg])
        assert seen["temporal"] == want and seen["backend"] == "cuda"


def test_main_takes_the_8192_grid(monkeypatch):
    # the grid on which --temporal auto takes the x-tiled band leg (B6)
    seen = {}

    class Stop(Exception):
        pass

    def fake_sim(cfg, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(profile_step, "MucociliarySim", fake_sim)
    with pytest.raises(Stop):
        profile_step.main(["--grids", "8192x8192", "--temporal", "auto"])
    cfg = seen["cfg"]
    assert (cfg.xdim, cfg.ydim, cfg.c_num) == (8192, 8192, 64)


def test_profile_sim_on_a_mesh_on_cpu():
    # --mesh: the sharded sim (both shards on the CPU) through the same
    # profiler
    from cuda_iblb_11_tpu_torch.runner import _make_mesh_sim

    cfg = SimConfig(c_num=3, c_space=128, length=16, ydim=288,
                    dtype="float32")
    sim = _make_mesh_sim(cfg, "auto", "trt_split", 2, "2,1", "periodic",
                         "no_mucus", torch.device("cpu"))
    assert sim.resolved_config()["mesh"] == [2, 1] and sim.temporal == 2
    row = profile_step.profile_sim(sim, steps=2)
    assert row["steps"] == 2 and row["wall_ms"] > 0
    assert row["device_busy_ms"] is None and row["aten_ops"] > 10
    # the mesh keeps no spans but the kinematics it borrows from the model
    assert set(row["host_us_per_step"]) == {"iblb.kinematics"}
