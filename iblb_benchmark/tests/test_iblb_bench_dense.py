"""Configurations whose cilia overlap (r_max = 2 length // c_space > 1, as
upstream's 48 apart at length 96): each rehearses correct with its overlap
mask and not without it.  rehearse.TINY's cilia (16 nodes, 64 apart)
switch the mask off, so these runs keep the configuration's ratio of
length to c_space.  (The mask against the reference's over a beat:
tests/test_torch_overlap_mask.py.)"""

import json
import os

import pytest
import torch

from iblb_benchmark import harness
from iblb_benchmark.reference.kinematics import Beat
from iblb_benchmark.reference.params import Params
from iblb_benchmark.tests import rehearse

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
    CELLS = [w["name"] for w in json.load(fh)["workloads"]]


def _dense():
    """The cells whose configuration's cilia overlap."""
    out = []
    for name in CELLS:
        sim = harness.load_cell(name).config["sim"]
        if 2 * sim["length"] // sim["c_space"] > 1:
            out.append(name)
    return out


def _mask_off(sim):
    """The program with its overlap mask switched off."""
    sim.cilia.r_max = 0
    return sim


@pytest.mark.parametrize("mask", ["on", "off"])
@pytest.mark.parametrize("name", _dense())
def test_a_dense_configuration_rehearses_with_its_mask(name, mask):
    """The configuration's length : c_space at 16 nodes, with 40 cilia,
    which the band super-step's windows need: the mask switches nodes off
    in the intervals the check follows, the run is correct, and the same
    run with the program's mask switched off is not."""
    cell = harness.load_cell(name)
    sim = cell.config["sim"]
    length = rehearse.TINY["length"]
    over = dict(rehearse.TINY, c_num=40,
                c_space=length * sim["c_space"] // sim["length"])
    r = harness.run(cell, 2**31 + 11, 0.05, False, device="cpu",
                    sim_overrides=over, temporal=rehearse.temporal(cell),
                    wrap=_mask_off if mask == "off" else None)
    run = r["run"]
    if cell.traffic["temporal"] == "auto":
        assert run["resolved"]["band_leg"] == rehearse.LEG
    p = Params.from_sim({**sim, **over})
    last = run["first_step"] + run["steps"]
    for it0 in (run["first_step"], last):
        _, _, eps = Beat(p, "cpu").placed(
            torch.arange(it0, it0 + run["interval"]), torch.float32)
        assert (eps == 0).any(dim=1).all()
    if mask == "on":
        assert r["correct"] and r["failed"] == 0, r["checks"]
    else:
        assert not r["correct"] and r["failed"] == 2, r["checks"]
