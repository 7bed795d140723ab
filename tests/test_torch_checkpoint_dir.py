"""The sharded directory checkpoint (io/checkpoint.save_dir, load_dir), the
port's counterpart of JAX's orbax format, in one process on the CPU:

(a) the bits round-trip in f32, f64 and bf16, from a mesh and from one
    device; a save that fails partway leaves the previous checkpoint
    whole; a restore onto another mesh and onto one device gives the saved
    global state exactly; the compatibility error;
(b) --resume DIR through the CLI continues the run to the uninterrupted
    run's Flux bytes, unsharded and on a mesh;
(c) across the packages: a port directory loaded without a sim and saved
    as npz loads in JAX's checkpoint.load with equal arrays (f32), and a
    JAX save_orbax directory is refused with the npz message.
"""

import os

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.cli import main
from cuda_iblb_11_tpu_torch.core.state import initial_state
from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt
from cuda_iblb_11_tpu_torch.parallel import (
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

CFG2 = dict(c_num=3, c_space=128, ydim=288)     # 384 x 288
PREC = {"float32": "deviatoric", "float64": "raw", "bfloat16": "deviatoric"}
ARGS = ["1", "4", "48", "1.0", "1.0", "5", "0.0005", "2", "0", "0"]
HALF = ARGS[:6] + ["0.00025", "1"] + ARGS[8:]   # 25 steps, one interval
FLUX = "Flux/1_4_48_1_1x5-flux.dat"
RAW = "Raw/4/1"


def _cfg(dtype="float64"):
    return SimConfig(**CFG2, dtype=dtype, storage=PREC[dtype])


def _state(cfg, seed=0):
    """A global state of seeded values (every bit pattern of f differs)."""
    g = torch.Generator().manual_seed(seed)
    st = initial_state(cfg)
    return st._replace(
        f=torch.randn(st.f.shape, generator=g,
                      dtype=torch.float64).to(st.f.dtype),
        force=torch.randn(st.force.shape, generator=g,
                          dtype=torch.float64).to(st.force.dtype),
        lasts=torch.randn(st.lasts.shape, generator=g,
                          dtype=torch.float64).to(st.lasts.dtype),
        q=torch.tensor(0.125, dtype=st.q.dtype), it=37)


def _mesh_sim(cfg, mesh):
    return ShardedPallasSim(cfg, make_mesh(*mesh, devices=["cpu"]))


def _equal(a, b):
    assert a.it == b.it
    for name in ("f", "force", "lasts", "q"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_bits_round_trip(tmp_path, dtype):
    cfg = _cfg(dtype)
    st = _state(cfg)
    sim = _mesh_sim(cfg, (2, 3))
    path = str(tmp_path / "ck")
    ckpt.save_dir(path, sim.place_state(st), cfg, sim)
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp",
                                        ckpt.SIDECAR]
    back, saved = ckpt.load_dir(path, cfg, sim=sim)
    assert saved == cfg
    _equal(sim.gather_state(back), st)
    assert back.f[0].dtype == torch.__dict__[dtype]
    # one device's FlowState, the same way
    ckpt.save_dir(path, st, cfg)
    _equal(ckpt.load_dir(path, cfg)[0], st)


def test_failed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    cfg = _cfg()
    sim = _mesh_sim(cfg, (2, 2))
    good = _state(cfg, seed=1)
    path = str(tmp_path / "ck")
    ckpt.save_dir(path, sim.place_state(good), cfg, sim)

    real = ckpt._dcp

    def broken(fn, state_dict, at, comm):
        real(fn, {k: v for k, v in list(state_dict.items())[:1]}, at, comm)
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_dcp", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_dir(path, sim.place_state(_state(cfg, seed=2)), cfg, sim)
    monkeypatch.undo()
    _equal(ckpt.load_dir(path, cfg)[0], good)
    # the next save clears the half-written one and swaps in whole
    newer = _state(cfg, seed=3)
    ckpt.save_dir(path, sim.place_state(newer), cfg, sim)
    _equal(ckpt.load_dir(path, cfg)[0], newer)
    assert sorted(os.listdir(tmp_path)) == ["ck"]


@pytest.mark.parametrize("saved,target", [
    ((2, 3), (4, 1)), ((2, 3), (1, 2)), ((4, 1), (2, 3)), ((1, 1), (2, 2)),
    ((2, 2), None),
])
def test_restore_onto_another_layout(tmp_path, saved, target):
    # a target block spans several saved blocks and the reverse; None:
    # one device, the whole FlowState
    cfg = _cfg()
    st = _state(cfg, seed=4)
    path = str(tmp_path / "ck")
    if saved == (1, 1):
        ckpt.save_dir(path, st, cfg)
    else:
        sim = _mesh_sim(cfg, saved)
        ckpt.save_dir(path, sim.place_state(st), cfg, sim)
    if target is None:
        back, _ = ckpt.load_dir(path, cfg)
        _equal(back, st)
        return
    sim = _mesh_sim(cfg, target)
    back, _ = ckpt.load_dir(path, cfg, sim=sim)
    assert [x.shape for x in back.f] == [(9, sim.yl, sim.xl)] * len(back.f)
    _equal(sim.gather_state(back), st)


def test_incompatible_config_is_refused(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "ck")
    ckpt.save_dir(path, _state(cfg), cfg)
    other = cfg.replace(c_num=4)
    with pytest.raises(ValueError, match=r"incompatible in fields \['c_num'"):
        ckpt.load_dir(path, other)
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.load(_npz(tmp_path, cfg), other)


def _npz(tmp_path, cfg):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, _state(cfg), cfg)
    return path


@pytest.mark.parametrize("mesh", [None, "2,1"])
def test_cli_resumes_a_directory(tmp_path, mesh):
    # 50 steps straight against 25 with a directory checkpoint, resumed
    # with --resume DIR: the same Flux bytes; on a mesh the temporal path
    flags = ["--quiet", "--device", "cpu"] + (
        ["--mesh", mesh, "--temporal", "4"] if mesh else [])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert main(ARGS + flags + ["--output", a]) == 0
    assert main(HALF + flags + ["--output", b, "--checkpoint-every", "25",
                                "--checkpoint-format", "orbax"]) == 0
    ck = os.path.join(b, RAW, "checkpoint_orbax")
    assert os.path.isfile(os.path.join(ck, ckpt.SIDECAR))
    assert main(ARGS + flags + ["--output", b, "--resume", ck]) == 0
    with open(os.path.join(a, FLUX), "rb") as fa, \
            open(os.path.join(b, FLUX), "rb") as fb:
        assert fa.read() == fb.read()
    log = open(os.path.join(b, RAW, "SimLog.txt")).read()
    assert "Resumed from checkpoint at iteration 25" in log


def test_directory_to_npz_loads_in_jax(tmp_path):
    from cuda_iblb_11_tpu.io import checkpoint as jax_ckpt

    cfg = _cfg("float32")
    st = _state(cfg, seed=5)
    sim = ShardedTemporalSim(cfg, make_mesh(2, 2, devices=["cpu"]),
                             temporal=4)
    path = str(tmp_path / "ck")
    ckpt.save_dir(path, sim.place_state(st), cfg, sim)
    whole, saved = ckpt.load_dir(path)
    ckpt.save(str(tmp_path / "ck.npz"), whole, saved)
    js, jcfg = jax_ckpt.load(str(tmp_path / "ck.npz"))
    assert jcfg.c_num == cfg.c_num and jcfg.dtype == "float32"
    for name in ("f", "force", "lasts", "q"):
        want = getattr(st, name).numpy()
        got = np.asarray(getattr(js, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert int(js.it) == st.it


def test_jax_orbax_directory_is_refused(tmp_path):
    import jax.numpy as jnp

    from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
    from cuda_iblb_11_tpu.core.state import FlowState as JaxState
    from cuda_iblb_11_tpu.io import checkpoint as jax_ckpt

    jcfg = JaxConfig(c_num=4, c_space=48, dtype="float32")
    st = JaxState(f=jnp.zeros((9, 192, 192), jnp.float32),
                  force=jnp.zeros((2, jcfg.force_band, 192), jnp.float32),
                  lasts=jnp.zeros((4, jcfg.length, 2), jnp.float32),
                  q=jnp.zeros((), jnp.float32), it=jnp.asarray(3))
    path = str(tmp_path / "orbax")
    jax_ckpt.save_orbax(path, st, jcfg)
    with pytest.raises(ValueError, match="npz is the format both read"):
        ckpt.load_dir(path)
    with pytest.raises(ValueError, match="npz is the format both read"):
        main(ARGS + ["--quiet", "--device", "cpu", "--output",
                     str(tmp_path / "out"), "--resume", path])
