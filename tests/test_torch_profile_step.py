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
    assert row["device_busy_ms"] is None and row["idle_share"] is None
    assert row["device_kernels"] == 0 and row["launch_calls"] == 0
    assert row["top_kernels"] == []
    assert row["aten_ops"] > 10   # the eager step is many small ops


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
