"""The port's metachrony sweep (cuda_iblb_11_tpu_torch/sweep_metachrony.py)
and its sweep.sh, against the JAX package on the CPU:

- each point at a narrow size (4 cilia 48 apart, 16 nodes a cilium, 64
  rows: the JAX script's SimConfig fields cut down, where K = 16 still
  takes the whole band super-step), c_fraction 1, 2 and 4, 160 steps in
  10 chunks, in f64: Q equals the JAX jnp run's to rtol 1e-10, at
  temporal 1 and at temporal 16 (the plain versions);
- main() on --device cpu writes a record with every key: both dtypes,
  f32 against f64, the distance to validation/metachrony.json (read here
  as a file), the argmax of each dtype beside JAX's;
- in f32 (the JAX sweep's dtype), the port's point at temporal 16 follows
  the JAX jnp f32 run's Q to rtol 1e-6, c_fraction 1, 2 and 4;
- run_point refuses a chunk that is not a multiple of K and a plan that
  is not the whole band super-step;
- cuda_iblb_11_tpu_torch/sweep.sh makes the calls scripts/sweep.sh makes,
  with the port's package in place of the JAX package (a stub ``python``
  first on PATH records them);
- without a card the entry point raises.

The 2048^2 sweep is the card's (cuda_iblb_11_tpu_torch/records/
metachrony.json, gated by tests/test_torch_records.py).

    python tests/test_torch_sweep_metachrony.py CF STEPS [C_NUM]

prints the JAX jnp run's Q at c_fraction CF after STEPS in f32 and f64
(raw storage), at the sweep's 2048 rows and cilium spacing with C_NUM
cilia (default 4: 512 x 2048), and f32 against f64: the CPU side of the
check that tells the port's f32 flux from f32's own at the sweep's size.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu_torch import sweep_metachrony as sm

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(c_num=4, c_space=48, length=16, ydim=64)
STEPS, CHUNKS = 160, 10
POINTS = (1, 2, 4)


def _jax_point(cf, dtype, steps, chunks, **size):
    """The JAX jnp run's Q at c_fraction ``cf``, chunked as the script."""
    sim = JaxSim(JaxConfig(c_fraction=cf, dtype=dtype, **size),
                 backend="jnp")
    st = sim.init_state()
    for _ in range(chunks):
        st = sim.run_chunk(st, steps // chunks)
    return float(st.q)


@pytest.fixture(scope="module")
def jax_q():
    """The JAX jnp f64 run's Q of each point."""
    return {cf: _jax_point(cf, "float64", STEPS, CHUNKS, **NARROW)
            for cf in POINTS}


@pytest.mark.parametrize("temporal", [1, 16])
@pytest.mark.parametrize("cf", POINTS)
def test_point_equals_the_jax_run(jax_q, cf, temporal):
    p = sm.run_point(cf, "float64", "cpu", steps=STEPS, chunks=CHUNKS,
                     temporal=temporal, **NARROW)
    assert p["q_per_beat"] == pytest.approx(jax_q[cf], rel=1e-10, abs=0)
    assert p["p_step"] == JaxConfig(c_fraction=cf, **NARROW).p_step
    assert p["finite"] and len(p["q_chunks"]) == CHUNKS
    assert p["q_chunks"][-1] == p["q_per_beat"]
    assert p["sim"]["band_leg"] == ("band_super_whole" if temporal > 1
                                    else "single_step")
    assert p["sim"]["temporal"] == temporal
    assert p["launches"] == dict.fromkeys(sm.COUNTED, 0)   # no card


@pytest.mark.parametrize("cf", POINTS)
def test_f32_point_follows_the_jax_f32_run(cf):
    p = sm.run_point(cf, "float32", "cpu", steps=STEPS, chunks=CHUNKS,
                     **NARROW)
    want = _jax_point(cf, "float32", STEPS, CHUNKS, **NARROW)
    assert p["sim"]["band_leg"] == "band_super_whole"
    assert p["q_per_beat"] == pytest.approx(want, rel=1e-6, abs=0)


def test_main_writes_every_key(tmp_path):
    path = tmp_path / "mc.json"
    points = (1, 4)
    assert sm.main(["--device", "cpu", "--out", str(path)], points=points,
                   steps=64, chunks=2, **NARROW) == 0
    with open(path) as fh:
        rec = json.load(fh)["sweep"]
    assert rec["card"] is None and rec["device"] == "cpu"
    assert rec["grid"] == [64, 192] and rec["steps"] == 64
    assert rec["points"] == list(points) and rec["temporal"] == 16
    assert "64 steps of the beat's 100000" in rec["reduced"]
    with open(os.path.join(REPO, "validation", "metachrony.json")) as fh:
        jax = {int(k): v["q_per_beat"] for k, v in json.load(fh).items()}
    assert rec["jax_record"] == "validation/metachrony.json"
    assert rec["jax_argmax_c_fraction"] == max(jax, key=jax.get) == 4
    for dt in ("float32", "float64"):
        runs = rec["runs"][dt]
        assert set(runs) == {"1", "4"}
        for cf, p in runs.items():
            assert {"q_per_beat", "p_step", "finite", "q_chunks", "steps",
                    "chunk", "seconds", "ms_per_step", "mlups", "launches",
                    "sim"} <= set(p)
            assert set(p["launches"]) == set(sm.COUNTED)
            assert p["sim"]["dtype"] == dt and p["chunk"] == 32
            assert rec["jax_distance"][dt][cf] == pytest.approx(
                (p["q_per_beat"] - jax[int(cf)]) / jax[int(cf)])
        qs = {int(cf): p["q_per_beat"] for cf, p in runs.items()}
        assert rec["argmax_c_fraction"][dt] == max(qs, key=qs.get)
    for cf in ("1", "4"):
        q32, q64 = (rec["runs"][d][cf]["q_per_beat"]
                    for d in ("float32", "float64"))
        assert rec["f32_vs_f64"][cf] == pytest.approx(abs(q32 - q64)
                                                      / abs(q64))
        assert rec["f32_vs_f64"][cf] < 1e-4


def test_run_point_refuses_another_path():
    with pytest.raises(ValueError, match="multiple of K"):
        sm.run_point(1, device="cpu", steps=168, chunks=2, **NARROW)
    # 192^2 with 4 cilia 48 apart: K = 16 takes the per-sub-step leg
    with pytest.raises(RuntimeError, match="per_substep"):
        sm.run_point(1, device="cpu", steps=32, chunks=2, c_num=4,
                     c_space=48, ydim=192)
    assert sm.expected_launches(100_000, 16) == {
        "B5 band_super": 6250, "B4 temporal_bulk": 6250, "B2 fused_step": 0}
    assert sm.expected_launches(64, 1)["B2 fused_step"] == 64


def _calls(script, args, tmp_path):
    """The argv of every ``python`` call ``script`` makes, through a stub
    first on PATH."""
    stub = tmp_path / "bin"
    stub.mkdir(exist_ok=True)
    log = tmp_path / "calls.log"
    log.unlink(missing_ok=True)
    (stub / "python").write_text(
        "#!/bin/sh\nprintf '%s\\037' \"$@\" >> \"$STUB_LOG\"\n"
        "printf '\\n' >> \"$STUB_LOG\"\n")
    (stub / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{stub}{os.pathsep}{os.environ['PATH']}",
               STUB_LOG=str(log))
    out = subprocess.run(["bash", script] + args, env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return [ln.split("\x1f")[:-1] for ln in log.read_text().splitlines()]


@pytest.mark.parametrize("args", [[], ["16", "128", "out/sweep"]])
def test_sweep_sh_makes_the_jax_scripts_calls(tmp_path, args):
    jax = _calls(os.path.join(REPO, "scripts", "sweep.sh"), args, tmp_path)
    port = _calls(os.path.join(REPO, "cuda_iblb_11_tpu_torch", "sweep.sh"),
                  args, tmp_path)
    assert len(jax) == 3
    assert port == [["-m", "cuda_iblb_11_tpu_torch.cli"] + c[2:]
                    for c in jax]
    assert [c[:2] for c in jax] == [["-m", "cuda_iblb_11_tpu.cli"]] * 3
    assert [c[2] for c in port] == ["1", "2", "3"]
    # further arguments reach every call of the port's script
    extra = _calls(os.path.join(REPO, "cuda_iblb_11_tpu_torch", "sweep.sh"),
                   ["6", "48", "o", "--device", "cpu"], tmp_path)
    assert len(extra) == 3
    assert all(c[-2:] == ["--device", "cpu"] for c in extra)


def test_entry_point_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        sm.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    cf, steps = int(sys.argv[1]), int(sys.argv[2])
    size = dict(sm.SIZE, c_num=int(sys.argv[3]) if len(sys.argv) > 3 else 4)
    q = {dt: _jax_point(cf, dt, steps, 1, **size)
         for dt in ("float32", "float64")}
    print(json.dumps(dict(c_fraction=cf, steps=steps, **size, jax_jnp=q,
                          f32_vs_f64=(q["float32"] - q["float64"])
                          / abs(q["float64"]))), flush=True)
