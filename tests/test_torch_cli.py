"""The port's CLI end to end on the CPU against the JAX CLI (--backend jnp)
on the same arguments.

Flux: both f32; the values agree to rtol 1e-6 (f32 round-off of two
implementations, measured ~3e-7 at 50 steps), and the file prints 6
significant digits, so each row may also differ by one unit of its 6th
digit.  SimLog: the reference's header lines and the configuration lines
the two packages share must be identical.
"""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.cli import main as jax_main
from cuda_iblb_11_tpu_torch.cli import main

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

ARGS = ["1", "4", "48", "1.0", "1.0", "5", "0.0005", "2", "0", "0"]
FLUX = "Flux/1_4_48_1_1x5-flux.dat"
SIMLOG = "Raw/4/1/SimLog.txt"
SHARED = ("Size", "Iterations", "Reynolds", "Relaxation", "Spatial", "Time",
          "Mach", "Phase", "Big Data", "Running", "Forcing", "Dtype",
          "Storage", "IB path")


def _shared_lines(path):
    return [ln for ln in path.read_text().splitlines()
            if ln.startswith(SHARED)]


def test_cli_matches_jax_cli(tmp_path):
    assert jax_main(ARGS + ["--output", str(tmp_path / "jax"), "--quiet",
                            "--backend", "jnp", "--dtype", "float32"]) == 0
    assert main(ARGS + ["--output", str(tmp_path / "port"), "--quiet",
                        "--device", "cpu", "--dtype", "float32"]) == 0
    a = np.loadtxt(tmp_path / "jax" / FLUX)
    b = np.loadtxt(tmp_path / "port" / FLUX)
    assert a.shape == b.shape == (3, 2)   # it = 0, 25, final 50
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    digit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(a[:, 1]),
                                                  1e-300))) - 5)
    assert np.all(np.abs(a[:, 1] - b[:, 1]) <= 1e-6 * np.abs(a[:, 1]) + digit)
    assert b[-1, 1] > 0
    ja = _shared_lines(tmp_path / "jax" / SIMLOG)
    pa = _shared_lines(tmp_path / "port" / SIMLOG)
    assert len(pa) == len(SHARED) and pa == ja
    log = (tmp_path / "port" / SIMLOG).read_text()
    assert "Kernel path: single_step" in log and "Device: cpu" in log


def test_cli_checkpoint_resume_continues_the_run(tmp_path):
    # 50 steps straight vs 25 + resume from the npz checkpoint (f64, so the
    # printed digits cannot waver): identical flux files
    args = ARGS + ["--quiet", "--device", "cpu", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "a")]) == 0
    half = ARGS[:6] + ["0.00025"] + ARGS[7:]
    b = str(tmp_path / "b")
    assert main(half[:7] + ["1"] + half[8:] + [
        "--quiet", "--device", "cpu", "--dtype", "float64", "--output", b,
        "--checkpoint-every", "25"]) == 0
    assert main(args + ["--output", b, "--resume",
                        f"{b}/Raw/4/1/checkpoint.npz"]) == 0
    assert ((tmp_path / "a" / FLUX).read_text()
            == (tmp_path / "b" / FLUX).read_text())
    assert "Resumed from checkpoint at iteration 25" in (
        tmp_path / "b" / SIMLOG).read_text()


def test_cli_temporal_k_matches_single_step(tmp_path):
    # --temporal 4 runs the K-step path (its plain versions on the CPU):
    # each 25-step interval is six super-steps and one single step.  f64,
    # so the flux agrees with the single-step run to round-off.
    args = ARGS + ["--quiet", "--device", "cpu", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "k1"),
                        "--temporal", "1"]) == 0
    assert main(args + ["--output", str(tmp_path / "k4"),
                        "--temporal", "4"]) == 0
    a = np.loadtxt(tmp_path / "k1" / FLUX)
    b = np.loadtxt(tmp_path / "k4" / FLUX)
    np.testing.assert_allclose(b, a, rtol=1e-5)
    log = (tmp_path / "k4" / SIMLOG).read_text()
    assert "Temporal K: 4" in log and "Kernel path: per_substep" in log
    # a K = 1 run resumed with K = 4: the same flux, and the SimLog says
    # the run switched kernel paths
    half = ARGS[:6] + ["0.00025", "1"] + ARGS[8:]
    c = str(tmp_path / "c")
    assert main(half + ["--quiet", "--device", "cpu", "--dtype", "float64",
                        "--output", c, "--temporal", "1",
                        "--checkpoint-every", "25"]) == 0
    assert main(args + ["--output", c, "--temporal", "4", "--resume",
                        f"{c}/Raw/4/1/checkpoint.npz"]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "c" / FLUX), a,
                               rtol=1e-5)
    assert ("NOTE: resumed with temporal K=4 (original run: K=1)"
            in (tmp_path / "c" / SIMLOG).read_text())


@pytest.mark.parametrize("flag", [
    ["--mesh", "2,4"], ["--checkpoint-format", "orbax"],
    ["--profile-dir", "trace"],
    ["--temporal", "4", "--ib-x-edge", "reference"],   # the quirk K-step leg
    ["--ib-x-edge", "reference"],
])
def test_cli_unported_modes_refuse(tmp_path, flag, capsys):
    rc = main(ARGS + ["--output", str(tmp_path), "--quiet", "--device",
                      "cpu"] + flag)
    assert rc == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_cli_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        main(ARGS + ["--output", str(tmp_path), "--quiet"])
