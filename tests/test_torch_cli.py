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
    ["--checkpoint-format", "orbax"],
    ["--resume", "."],                               # an orbax directory
])
def test_cli_unported_modes_refuse(tmp_path, flag, capsys):
    rc = main(ARGS + ["--output", str(tmp_path), "--quiet", "--device",
                      "cpu"] + flag)
    assert rc == 2
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("temporal,leg", [("1", "single_step"),
                                          ("4", "per_substep")])
def test_cli_quirk_mode_runs_and_names_its_path(tmp_path, temporal, leg):
    # --ib-x-edge reference on one device: the step without emission and
    # the stencil IB (the K-step leg per sub-step), against the JAX CLI in
    # the same mode at the flux gate of test_cli_matches_jax_cli
    out = tmp_path / "port"
    assert main(ARGS + ["--output", str(out), "--quiet", "--device", "cpu",
                        "--dtype", "float32", "--ib-x-edge", "reference",
                        "--temporal", temporal]) == 0
    log = (out / SIMLOG).read_text()
    assert "IB path: stencil_quirk" in log
    assert f"Kernel path: {leg}" in log
    assert jax_main(ARGS + ["--output", str(tmp_path / "jax"), "--quiet",
                            "--backend", "jnp", "--dtype", "float32",
                            "--ib-x-edge", "reference"]) == 0
    a = np.loadtxt(tmp_path / "jax" / FLUX)
    b = np.loadtxt(out / FLUX)
    digit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(a[:, 1]),
                                                  1e-300))) - 5)
    assert np.all(np.abs(a[:, 1] - b[:, 1]) <= 1e-6 * np.abs(a[:, 1]) + digit)
    assert "IB path: stencil_quirk" in (tmp_path / "jax" / SIMLOG).read_text()


def test_cli_quirk_flux_differs_from_periodic(tmp_path):
    # the quirk changes the cilia's x-edge coupling, so the flux moves
    flux = {}
    for mode in ("periodic", "reference"):
        out = tmp_path / mode
        assert main(ARGS + ["--output", str(out), "--quiet", "--device",
                            "cpu", "--dtype", "float64", "--ib-x-edge",
                            mode]) == 0
        flux[mode] = np.loadtxt(out / FLUX)[-1, 1]
    assert abs(flux["reference"] - flux["periodic"]) > 1e-4 * abs(
        flux["periodic"])


def test_cli_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        main(ARGS + ["--output", str(tmp_path), "--quiet"])


def test_cli_mesh_matches_unsharded(tmp_path):
    # --mesh 2,1 on the CPU (both shards on the one device, the plain
    # versions): f64, so the flux equals the unsharded run's to 1e-12, one
    # step per exchange (auto on the torch backend) and with K = 4 (the
    # per-sub-step leg: the reference channel's window exceeds 192
    # columns); SimLog names the mesh and the leg
    args = ARGS + ["--quiet", "--device", "cpu", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "one")]) == 0
    a = np.loadtxt(tmp_path / "one" / FLUX)
    for label, extra, leg in (("m1", [], "sharded_per_step"),
                              ("m4", ["--temporal", "4"],
                               "per_substep_tiled")):
        out = tmp_path / label
        assert main(args + ["--output", str(out), "--mesh", "2,1"]
                    + extra) == 0
        np.testing.assert_allclose(np.loadtxt(out / FLUX), a, rtol=1e-12)
        log = (out / SIMLOG).read_text()
        assert "Mesh: 2,1 over 1 device(s)" in log
        assert f"Kernel path: {leg}" in log


def test_cli_quirk_mesh_matches_unsharded(tmp_path):
    # --ib-x-edge reference on a (2, 1) mesh (the stencil IB on the
    # shards): f64, the flux of the unsharded quirk run to 1e-10, one step
    # per exchange and with K = 4 (the per-sub-step leg, the quirk's on
    # every mesh); bf16 storage runs there too
    args = ARGS + ["--quiet", "--device", "cpu", "--dtype", "float64",
                   "--ib-x-edge", "reference"]
    assert main(args + ["--output", str(tmp_path / "one")]) == 0
    a = np.loadtxt(tmp_path / "one" / FLUX)
    for label, extra, leg in (("m1", [], "sharded_per_step"),
                              ("m4", ["--temporal", "4"],
                               "per_substep_tiled")):
        out = tmp_path / label
        assert main(args + ["--output", str(out), "--mesh", "2,1"]
                    + extra) == 0
        np.testing.assert_allclose(np.loadtxt(out / FLUX), a, rtol=1e-10)
        log = (out / SIMLOG).read_text()
        assert "Mesh: 2,1 over 1 device(s)" in log
        assert "IB path: stencil_quirk" in log
        assert f"Kernel path: {leg}" in log
    out = tmp_path / "bf16"
    assert main(ARGS + ["--quiet", "--device", "cpu", "--dtype", "bfloat16",
                        "--ib-x-edge", "reference", "--mesh", "2,1",
                        "--output", str(out)]) == 0
    log = (out / SIMLOG).read_text()
    assert "Dtype: bfloat16" in log and "IB path: stencil_quirk" in log
    assert np.isfinite(np.loadtxt(out / FLUX)).all()


def test_cli_mesh_resumes_a_single_device_checkpoint(tmp_path):
    # a JAX single-device npz (25 steps) resumed by the port on a (2, 1)
    # mesh, checkpointing again: the same flux as the port's straight run
    args = ARGS + ["--quiet", "--dtype", "float64"]
    assert main(args + ["--device", "cpu",
                        "--output", str(tmp_path / "a")]) == 0
    half = ARGS[:6] + ["0.00025", "1"] + ARGS[8:]
    b = str(tmp_path / "b")
    assert jax_main(half + ["--quiet", "--dtype", "float64", "--backend",
                            "jnp", "--output", b, "--checkpoint-every",
                            "25"]) == 0
    assert main(args + ["--device", "cpu", "--output", b, "--mesh", "2,1",
                        "--resume", f"{b}/Raw/4/1/checkpoint.npz",
                        "--checkpoint-every", "25"]) == 0
    np.testing.assert_allclose(np.loadtxt(tmp_path / "b" / FLUX),
                               np.loadtxt(tmp_path / "a" / FLUX), rtol=1e-12)
    log = (tmp_path / "b" / SIMLOG).read_text()
    assert "Resumed from checkpoint at iteration 25" in log
    assert "Mesh: 2,1 over 1 device(s)" in log
    # the mesh's checkpoint is the global state at it = 50, in the format
    # a single-device run resumes
    from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt

    st, _ = ckpt.load(f"{b}/Raw/4/1/checkpoint.npz")
    assert st.it == 50 and st.f.shape == (9, 192, 192)
    assert st.force.shape == (2, 128, 192)


def test_cli_mesh_auto_is_unsharded_on_one_device(tmp_path):
    assert main(ARGS + ["--quiet", "--device", "cpu", "--output",
                        str(tmp_path), "--mesh", "auto"]) == 0
    log = (tmp_path / SIMLOG).read_text()
    assert "Mesh: unsharded (auto: single visible device" in log
    assert "Kernel path: single_step" in log


def test_cli_profile_dir_traces_the_first_interval(tmp_path, capsys):
    # --profile-dir: a torch.profiler Chrome trace of the first interval in
    # the directory, the JAX runner's message, and the same flux as a run
    # without it
    base = ARGS + ["--quiet", "--device", "cpu", "--dtype", "float32",
                   "--temporal", "1"]
    trace = tmp_path / "trace"
    assert main(base + ["--output", str(tmp_path / "a")]) == 0
    assert main([a for a in base if a != "--quiet"]
                + ["--output", str(tmp_path / "b"), "--profile-dir",
                   str(trace)]) == 0
    assert f"Profiler trace written to {trace}" in capsys.readouterr().out
    with open(trace / "trace.json") as fh:
        assert "traceEvents" in fh.read(4096)
    assert ((tmp_path / "a" / FLUX).read_bytes()
            == (tmp_path / "b" / FLUX).read_bytes())
