"""The probes P1-P3 (ops/probes.py) and their measurement modules
(probe_bw.py, probe_vpu.py) on the CPU: the plain versions against numpy,
the slope arithmetic on given times, the refusal of every probe entry
point without a card, and the package's operation counts against the JAX
package's jaxpr recount of the collide tree (scripts/probe_vpu.py,
loaded as tests/test_vpu_roofline.py loads it).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu_torch import probe_bw, probe_vpu
from cuda_iblb_11_tpu_torch.ops import probes

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def _x(shape=(9, 16, 32), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("scale", [False, True])
def test_copy_plain_version_matches_numpy(scale):
    x = _x()
    want = x * np.float32(probes.SCALE) if scale else x
    got = probes.probe_copy(torch.from_numpy(x), scale)   # CPU: plain
    np.testing.assert_array_equal(got.numpy(), want)
    t = torch.from_numpy(x.copy())
    probes.probe_copy(t, scale, out=t)                    # in place
    np.testing.assert_array_equal(t.numpy(), want)
    r = probes.probe_ring_copy(torch.from_numpy(x), 1024, 3)
    np.testing.assert_array_equal(r.numpy(), x)


@pytest.mark.parametrize("op", probes.CHAIN_OPS)
def test_chain_plain_version_matches_numpy(op):
    # the fma link rounds once: formed exactly in float64, then rounded
    x = _x((64,), 1)
    a, b = np.float32(probes.CHAIN_A), np.float32(probes.CHAIN_B)
    v = x.copy()
    for _ in range(300):
        v = {"fma": lambda w: (w.astype(np.float64) * np.float64(a)
                               + np.float64(b)).astype(np.float32),
             "add": lambda w: w + b, "mul": lambda w: w * a}[op](v)
    before = probes.probe_chain.launches
    got = probes.probe_chain(torch.from_numpy(x), 300, op).numpy()
    np.testing.assert_array_equal(got, v)
    assert probes.probe_chain.launches == before   # no kernel on the CPU


def test_chain_fma_link_rounds_once():
    # exact in float64: a float32 multiply and add rounds twice and parts
    # from it; the once-rounded link is the one nearest the exact value
    x = torch.from_numpy(_x((4096,), 2))
    once = probes.probe_chain_reference(x, 1, "fma").double()
    twice = (x * probes.CHAIN_A + probes.CHAIN_B).double()
    exact = (x.double() * float(np.float32(probes.CHAIN_A))
             + float(np.float32(probes.CHAIN_B)))
    assert not torch.equal(once, twice)
    assert torch.all((once - exact).abs() <= (twice - exact).abs())


def test_slope_arithmetic():
    # 262,144 elements x 2 flops x 4,000 extra links in 0.05 ms more:
    # 41.94 TFLOP/s; add counts one flop per link
    n = probe_vpu.SHAPE[0] * probe_vpu.SHAPE[1]
    assert n == 262_144
    tf = probe_vpu.slope_tflops(0.03, 0.08)
    assert tf == pytest.approx(n * 2 * 4000 / 0.05e-3 / 1e12)
    assert probe_vpu.slope_tflops(0.03, 0.08, op="add") == pytest.approx(
        tf / 2)


def test_probe_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    for fn in (lambda: probe_bw.measure(1), lambda: probe_vpu.measure(8),
               lambda: probe_bw.main(["--json", str(tmp_path / "a.json")]),
               lambda: probe_vpu.main(["--json", str(tmp_path / "b.json")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert not list(tmp_path.iterdir())


def test_wrappers_refuse_other_devices():
    x = torch.zeros(8, device="meta")
    for fn in (lambda: probes.probe_copy(x), lambda: probes.probe_ring_copy(x),
               lambda: probes.probe_chain(x, 4)):
        with pytest.raises(ValueError, match="device"):
            fn()
    with pytest.raises(ValueError, match="chain op"):
        probes.probe_chain(torch.zeros(4), 4, "div")


def _jax_probe():
    sys.path.insert(0, SCRIPTS)
    try:
        spec = importlib.util.spec_from_file_location(
            "probe_vpu_jax", os.path.join(SCRIPTS, "probe_vpu.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.pop(0)


def test_op_counts_match_the_jax_recount():
    n_free, n_forced = _jax_probe().collide_flops()
    assert probe_vpu.COLLIDE_FREE == n_free == 101
    # the forced tree: collide.cuh performs all of the JAX tree's
    # operations but the two named ones
    assert len(probe_vpu.JAX_ONLY_FORCED_OPS) == 2
    assert probe_vpu.COLLIDE_FORCED + len(probe_vpu.JAX_ONLY_FORCED_OPS) \
        == n_forced == 165
    assert probe_vpu.MOMENTS == 19
    assert probe_vpu.IB_POINT == 6 * 15 + 9 * 11 + 8
