"""The port's output files through the unchanged scripts/plot_fields.py:
the CLI on --device cpu with BigData = 1 (fluid and cilia snapshots and
the flux file) and validate_flux's stdout curve, each parsed and rendered
as tests/test_plotting.py renders the JAX package's files."""

import glob
import importlib.util
import os

import pytest

from cuda_iblb_11_tpu_torch import cli, validate_flux
from cuda_iblb_11_tpu_torch.core.config import SimConfig

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("matplotlib") is None,
    reason="matplotlib unavailable")

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "plot_fields.py")
# 4 cilia 48 apart (192 x 192), 20 steps (I_pow 0.0002), 2 snapshot pairs
ARGV = ["1", "4", "48", "1.0", "1.0", "5", "0.0002", "2", "0", "1"]


def _mod():
    spec = importlib.util.spec_from_file_location("plot_fields", _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_outputs_render(tmp_path):
    out = tmp_path / "run"
    assert cli.main(ARGV + ["--device", "cpu", "--output", str(out),
                            "--quiet"]) == 0
    cfg = SimConfig.from_argv(ARGV)
    fluid = sorted(glob.glob(str(out / "Raw" / "**" / "*-fluid.dat"),
                             recursive=True))
    cilia = sorted(glob.glob(str(out / "Cilia" / "**" / "*-cilia.dat"),
                             recursive=True))
    flux = glob.glob(str(out / "Flux" / "*-flux.dat"))
    assert len(fluid) == len(cilia) == 2 and len(flux) == 1
    mod = _mod()
    f = mod.read_fluid(fluid[-1])
    assert f["umag"].shape == (cfg.ydim, cfg.xdim)
    s, _, eps = mod.read_cilia(cilia[-1])
    assert s.shape == (cfg.ns, 2) and eps.shape == (cfg.ns,)
    for args, name in (
            (["fluid", fluid[-1], "--cilia", cilia[-1]], "f.png"),
            (["cilia", cilia[-1]], "c.png"),
            (["flux", flux[0]], "q.png"),
            (["movie", os.path.dirname(fluid[0]), "--fps", "4"], "m.gif")):
        assert mod.main(args + ["--out", str(tmp_path / name),
                                "--dpi", "50"]) == 0
        assert (tmp_path / name).stat().st_size > 1000, name


def test_validate_flux_curve_renders(tmp_path, capsys):
    capsys.readouterr()
    assert validate_flux.main(["--steps", "24", "--samples", "12",
                               "--dtype", "float64", "--device", "cpu",
                               "--json", str(tmp_path / "vf.json")]) == 0
    curve = tmp_path / "curve.dat"
    curve.write_text(capsys.readouterr().out)
    assert curve.read_text().startswith("# t_ms\tQ_scaled\n")
    assert _mod().main(["flux", str(curve), "--out", str(tmp_path / "q.png"),
                        "--dpi", "50"]) == 0
    assert (tmp_path / "q.png").stat().st_size > 1000
