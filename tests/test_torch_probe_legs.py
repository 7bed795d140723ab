"""probe_legs.py on the CPU: each pair's two sims run one configuration on
the plan without a budget and on the budgeted plan (the whole band
super-step against the x-tiled one, B8 against the per-sub-step leg of a
mesh), on small configurations with the plain versions; and its refusal
without a card."""

import pytest
import torch

from cuda_iblb_11_tpu_torch import probe_legs
from cuda_iblb_11_tpu_torch.ops.temporal import band_super_resident

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)


@pytest.mark.parametrize("pair,want", [
    ((12, 192, "float64", None, 4), ("band_super_whole",
                                     "band_super_xtiled")),
    ((16, 256, "float32", (2, 2), 4), ("band_super_xsharded",
                                       "per_substep_tiled")),
])
def test_leg_sims_take_the_two_legs(monkeypatch, pair, want):
    monkeypatch.setattr(probe_legs, "K", 2)
    monkeypatch.setattr(probe_legs, "PAIRS", {"small": pair})
    # a budget one byte below the footprint of the unbudgeted plan's band
    # super-step (the whole band, or the x-shard block)
    dtype, cpu = getattr(torch, pair[2]), torch.device("cpu")
    free = probe_legs.leg_sims("small", cpu, None, backend="torch")["whole"]
    p, band = free.plan, free.cfg.force_band
    fp = (band_super_resident(p.xshard.width, band + p.pad_s, band, 0, dtype)
          if pair[3] else band_super_resident(
              free.cfg.xdim, band + p.pad_s, band, 2 * p.halo, dtype))
    sims = probe_legs.leg_sims("small", cpu, fp - 1, backend="torch")
    assert (sims["whole"].resolved_config()["band_leg"],
            sims["budgeted"].resolved_config()["band_leg"]) == want
    assert sims["whole"].temporal == sims["budgeted"].temporal == 2
    # the same steps on both legs agree (the plain versions, f64 round-off
    # in the mesh's IB sums; f32 on the mesh)
    n = 4
    us = [s.fields(s.run_chunk(s.init_state(), n))[1] for s in sims.values()]
    rel = float(torch.linalg.norm((us[0] - us[1]).double())
                / torch.linalg.norm(us[1].double()))
    assert rel <= (1e-12 if pair[2] == "float64" else 1e-5)


def test_probe_legs_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_legs.main(["--json", str(tmp_path / "p.json")])
    assert not list(tmp_path.iterdir())
