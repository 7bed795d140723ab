"""The control: the program with its lower-precision path switched on
(the dtype the cell's file names: bfloat16 storage for a float32 cell,
float32 for the float64 one) comes out not correct under each cell's
limits, while the program as the cell runs it comes out correct, here at a
size a test run holds (the CPU, the program's plain versions, three
seeds).  On the card the same comparison runs at the cells' own sizes:
``python3 -m iblb_benchmark.control`` (the readings in PERF.md); the test
marked ``cuda`` runs one cell's benchmark command there."""

import json
import os
import subprocess
import sys

import pytest
import torch

from iblb_benchmark import control, harness
from iblb_benchmark.tests import rehearse
from iblb_benchmark.tests.test_iblb_bench_rehearsal import CELLS

SEEDS = (5, 61, 2**31 + 3)


def _readings(name, dtype=None):
    cell = harness.load_cell(name)
    return cell, control.readings(
        cell, SEEDS, 0.05, dtype=dtype, device="cpu",
        sim_overrides=dict(rehearse.TINY),
        temporal=rehearse.temporal(cell))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell, sound = _readings(name)
    limits = cell.spec["limits"]
    for r in sound:
        assert all(r[k] <= limits[k] for k in limits), r
    _, ctl = _readings(name, cell.spec["control"]["dtype"])
    for r in ctl:
        assert r["dtype"] == cell.spec["control"]["dtype"]
        assert any(r[k] > limits[k] for k in limits), r


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "iblb_benchmark.run", "--workload",
         CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "1"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
    assert {"b4_roofline", "b5_roofline", "device_idle_share"} \
        <= set(r["metrics"])
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert os.path.isdir(os.path.join(harness.ROOT, "build", "kernels"))
