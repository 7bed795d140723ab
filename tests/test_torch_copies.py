"""The port's own copies of the JAX package's JAX-free modules stay equal to
the originals: SimConfig and every derived quantity, the lattice constants,
the output writers (byte for byte), the native C++ writers' build and
output, and the timing helpers.
"""

import dataclasses
import os

import numpy as np
import pytest

from cuda_iblb_11_tpu.core import config as jconfig
from cuda_iblb_11_tpu.core import lattice as jlattice
from cuda_iblb_11_tpu.io import writers as jwriters
from cuda_iblb_11_tpu.utils import timing as jtiming
from cuda_iblb_11_tpu_torch.core import config as tconfig
from cuda_iblb_11_tpu_torch.core import lattice as tlattice
from cuda_iblb_11_tpu_torch.io import native as tnative
from cuda_iblb_11_tpu_torch.io import writers as twriters
from cuda_iblb_11_tpu_torch.utils import timing as ttiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CLI argvs of the port's tests and smoke script
ARGVS = [
    ["1", "4", "48", "1.0", "1.0", "5", "0.0005", "2", "0", "0"],
    ["1", "4", "48", "1.0", "1.0", "5", "0.00025", "1", "0", "0"],
    ["1", "6", "48", "1.0", "1.0", "5", "0.02", "4", "0", "0"],
    ["2", "3", "64", "0.5", "2.0", "3", "1.5", "10", "1", "1"],
]
# the keyword configurations, the three smoke sizes among them
KWARGS = [
    dict(c_num=6, c_space=48, ydim=192),
    dict(c_num=16, c_space=128, ydim=2048),
    dict(c_num=64, c_space=128, ydim=8192),
    dict(c_num=4, c_space=48, ydim=256, dtype="float64", storage="raw"),
    dict(c_num=3, c_space=128, ydim=256, length=16, dtype="bfloat16"),
    dict(c_num=2, c_space=96, t_num=1, t_pow=2, i_pow=1, p_num=1),
]


def _properties(cls):
    return sorted(n for n, v in vars(cls).items() if isinstance(v, property))


def _same_config(j, t):
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in _properties(jconfig.SimConfig):
        a, b = getattr(j, name), getattr(t, name)
        assert type(a) is type(b) and a == b, name


def test_config_has_the_same_fields_and_properties():
    assert ([f.name for f in dataclasses.fields(jconfig.SimConfig)]
            == [f.name for f in dataclasses.fields(tconfig.SimConfig)])
    assert _properties(jconfig.SimConfig) == _properties(tconfig.SimConfig)
    for name in ("L_0", "T_0"):
        assert getattr(jconfig, name) == getattr(tconfig, name)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:3]))
def test_config_from_argv_matches_jax(argv):
    _same_config(jconfig.SimConfig.from_argv(argv),
                 tconfig.SimConfig.from_argv(argv))


@pytest.mark.parametrize("kw", KWARGS, ids=lambda k: str(sorted(k.items())))
def test_config_derived_quantities_match_jax(kw):
    j, t = jconfig.SimConfig(**kw), tconfig.SimConfig(**kw)
    _same_config(j, t)
    _same_config(j.replace(ydim=320), t.replace(ydim=320))
    j.validate()
    t.validate()


def test_config_rejects_what_jax_rejects():
    for kw in (dict(c_num=1), dict(storage="bogus")):
        for mod in (jconfig, tconfig):
            with pytest.raises(ValueError):
                mod.SimConfig(**kw).validate()
    for mod in (jconfig, tconfig):
        with pytest.raises(SystemExit):
            mod.SimConfig.from_argv(ARGVS[0][:9])


def test_lattice_constants_match_jax():
    names = sorted(n for n in vars(jlattice) if n.isupper())
    assert names == sorted(n for n in vars(tlattice) if n.isupper())
    for n in names:
        a, b = getattr(jlattice, n), getattr(tlattice, n)
        assert type(a) is type(b), n
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=n)


def _fields(seed, dtype=np.float64):
    cfg = tconfig.SimConfig(c_num=4, c_space=48, ydim=16)
    rng = np.random.default_rng(seed)
    rho = (1.0 + 0.01 * rng.standard_normal((cfg.ydim, cfg.xdim))
           ).astype(dtype)
    u = (0.01 * rng.standard_normal((2, cfg.ydim, cfg.xdim))).astype(dtype)
    ns = cfg.ns
    s = np.stack([rng.uniform(0, cfg.xdim, ns), rng.uniform(0, 100, ns)], 1)
    u_s = 0.01 * rng.standard_normal((ns, 2))
    eps = rng.integers(0, 2, ns).astype(np.int32)
    return cfg, rho, u, s, u_s, eps


def _both(cfg):
    return jconfig.SimConfig(**dataclasses.asdict(cfg)), cfg


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_writers_write_the_same_bytes(tmp_path, dtype):
    cfg, rho, u, s, u_s, eps = _fields(7, dtype)
    jcfg, tcfg = _both(cfg)
    for name, mod, c in (("jax", jwriters, jcfg), ("port", twriters, tcfg)):
        mod.write_fluid_snapshot(str(tmp_path / f"{name}-fluid.dat"), c,
                                 rho, u)
        mod.write_cilia_snapshot(str(tmp_path / f"{name}-cilia.dat"), c, s,
                                 u_s, eps)
        flux = mod.FluxWriter(str(tmp_path / f"{name}-flux.dat"), c)
        for it, q in ((0, 0.0), (25, 1.234567e-3), (50, -9.87654e-5)):
            flux.append(it, q)
        log = mod.SimLog(str(tmp_path / name / "SimLog.txt"), c)
        log.write_header(extra={"Backend": "x"})
        log.write_runtime(3725.25)
    for kind in ("fluid.dat", "cilia.dat", "flux.dat"):
        assert ((tmp_path / f"jax-{kind}").read_bytes()
                == (tmp_path / f"port-{kind}").read_bytes()), kind
    # the header's first line is the wall-clock date
    ja = (tmp_path / "jax" / "SimLog.txt").read_text().splitlines()[1:]
    pa = (tmp_path / "port" / "SimLog.txt").read_text().splitlines()[1:]
    assert ja == pa and len(pa) > 10
    a = jwriters.OutputPaths("root", jcfg)
    b = twriters.OutputPaths("root", tcfg)
    assert (a.flux_path, a.simlog_path, a.raw_dir, a.cilia_dir) == (
        b.flux_path, b.simlog_path, b.raw_dir, b.cilia_dir)


def test_writers_npz_hold_the_same_arrays(tmp_path):
    cfg, rho, u, s, u_s, eps = _fields(8)
    jcfg, tcfg = _both(cfg)
    for name, mod, c in (("jax", jwriters, jcfg), ("port", twriters, tcfg)):
        mod.write_fluid_snapshot_npz(str(tmp_path / f"{name}-f.npz"), c,
                                     rho, u)
        mod.write_cilia_snapshot_npz(str(tmp_path / f"{name}-c.npz"), c, s,
                                     u_s, eps)
    for kind in ("f", "c"):
        a = np.load(tmp_path / f"jax-{kind}.npz")
        b = np.load(tmp_path / f"port-{kind}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_native_builds_under_build_and_matches_the_writers(tmp_path):
    path = tnative.library_path()
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    assert os.path.exists(path)
    cfg, rho, u, s, u_s, eps = _fields(9)
    tnative.write_fluid_snapshot(str(tmp_path / "c-fluid.dat"), cfg, rho, u)
    twriters.write_fluid_snapshot(str(tmp_path / "py-fluid.dat"), cfg, rho,
                                  u)
    tnative.write_cilia_snapshot(str(tmp_path / "c-cilia.dat"), cfg, s, u_s,
                                 eps)
    twriters.write_cilia_snapshot(str(tmp_path / "py-cilia.dat"), cfg, s,
                                  u_s, eps)
    for kind in ("fluid", "cilia"):
        assert ((tmp_path / f"c-{kind}.dat").read_bytes()
                == (tmp_path / f"py-{kind}.dat").read_bytes())
    a = tnative.monotonic_seconds()
    assert tnative.monotonic_seconds() >= a


def test_timing_matches_jax():
    assert (ttiming.predict_completion(1000.0, 12.5, 8)
            == jtiming.predict_completion(1000.0, 12.5, 8))
    for mod in (jtiming, ttiming):
        m = mod.ThroughputMeter(cells=100)
        assert m.mlups == 0.0 and m.steps_per_s == 0.0
        m.start()
        m.stop(10)
        assert m.steps == 10 and m.elapsed > 0
        with pytest.raises(RuntimeError):
            m.stop(1)
