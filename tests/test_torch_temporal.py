"""The K-step temporal mode of the port against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's side is the plain version of each kernel (a wrapper given
CPU tensors takes it).  Inputs are made from a numpy seed, in f64.

(a) B3, the per-sub-step band leg: sharded_fused_substep_reference
    against make_sharded_fused_substep, rtol 1e-12.
(b) B4, the temporal bulk: temporal_bulk_reference against
    make_temporal_bulk_substep at K = 2 and 4: f rtol 1e-12, flux rtol
    1e-6 (the JAX kernel adds its flux partials in float32).
(c) The eligibility: the K, band leg and ghost pads the port resolves
    equal the JAX package's on the configurations of test_temporal.py,
    test_band_super.py and test_auto_temporal.py and on the smoke sizes,
    in bf16 storage too.
(d) The whole temporal MucociliarySim (backend "torch", K = 4) against
    JAX (backend "pallas", K = 4) over 16 steps and over 11 (two
    super-steps and three single-step remainders), on both band legs:
    f rtol 1e-12 / atol 1e-15, force rtol 1e-10 / atol 1e-18, q rtol
    1e-12.
(e) A state the JAX temporal path produced, advanced by the port's
    temporal path, matches JAX advancing the same state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops import reference as jref
from cuda_iblb_11_tpu.ops.pallas_step import (
    make_sharded_fused_substep, make_temporal_bulk_substep,
)
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.core.state import state_from_numpy
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.temporal import plan_auto, plan_temporal
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk_reference

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

F64 = dict(dtype="float64", storage="raw")
BF16 = dict(dtype="bfloat16", storage="deviatoric")
KERNEL_CFG = dict(c_num=4, c_space=48, ydim=192, **F64)


def _cfgs(**kw):
    return JaxConfig(**kw), SimConfig(**kw)


def _walls(top):
    return jref.WallSpec(top=top), ref.WallSpec(top=top)


def _f(rng, rows, xdim):
    """Populations near the raw-storage rest state."""
    w = np.asarray(W)[:, None, None]
    return w * (1.0 + 0.05 * rng.standard_normal((9, rows, xdim)))


def _pad8(h):
    """[9, X] -> the JAX halo layout [9, 8, X], row 0 used."""
    return np.concatenate([h[:, None], np.zeros((9, 7, h.shape[-1]))], 1)


def _close(got, want, rtol=1e-12, atol=1e-15):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --- (a) B3 ------------------------------------------------------------

@pytest.mark.parametrize("flags,top,expose", [
    ((0, 1, 0), "slip", True),      # the band leg: bottom wall, open top
    ((0, 1, 1), "slip", True),      # both walls: the B2 configuration
    ((0, 1, 1), "noslip", True),
    ((64, 0, 0), "slip", False),    # an inner block: both halos pulled
])
def test_b3_plain_matches_jax(flags, top, expose):
    jcfg, tcfg = _cfgs(**KERNEL_CFG)
    jw, tw = _walls(top)
    band, xdim = tcfg.force_band, tcfg.xdim
    rows = band + 16
    rng = np.random.default_rng(3)
    f = _f(rng, rows, xdim)
    force = 1e-4 * rng.standard_normal((2, band, xdim))
    bhalo, thalo = _f(rng, 2, xdim).transpose(1, 0, 2)
    erow = band - 1 if expose else None
    emit = flags[0] == 0
    sub = make_sharded_fused_substep(
        jcfg, rows, jw, jnp.float64, storage="raw", expose_f1_row=erow,
        emit_moments=emit)
    out = sub(jnp.asarray(flags, jnp.int32), jnp.asarray(f),
              jnp.asarray(force), jnp.asarray(_pad8(bhalo)),
              jnp.asarray(_pad8(thalo)))
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    want = {"f": out.pop(0)}
    if expose:
        want["f1row"] = np.asarray(out.pop(0))[:, 0]
    if emit:
        want["q"] = out.pop(0)
        want["fluxcol"] = np.asarray(out.pop(0))[..., 0]
    t = torch.from_numpy
    got = dict(zip(("f", "f1row", "q", "fluxcol"),
                   sharded_fused_substep_reference(
                       flags, t(f), t(force), t(bhalo), t(thalo), tcfg, tw,
                       "trt_split", "raw", erow, emit)))
    assert {k for k, v in got.items() if v is not None} == set(want)
    for k in want:
        _close(got[k], want[k])


# --- (b) B4 ------------------------------------------------------------

@pytest.mark.parametrize("K,top", [(2, "slip"), (4, "noslip")])
def test_b4_plain_matches_jax(K, top):
    jcfg, tcfg = _cfgs(**KERNEL_CFG)
    jw, tw = _walls(top)
    rows, xdim = tcfg.ydim - tcfg.force_band, tcfg.xdim
    rng = np.random.default_rng(4)
    f = _f(rng, rows, xdim)
    bhalos = _f(rng, K, xdim).transpose(1, 0, 2)          # [K, 9, X]
    sub = make_temporal_bulk_substep(jcfg, rows, K, jw, jnp.float64,
                                     storage="raw")
    jf, jflux = sub(jnp.asarray(f),
                    jnp.asarray(np.stack([_pad8(h) for h in bhalos])))
    tf, tflux = temporal_bulk_reference(
        torch.from_numpy(f), torch.from_numpy(bhalos), tcfg, tw,
        "trt_split", "raw")
    _close(tf, jf)
    # the JAX kernel adds its per-tile flux partials in float32 whatever
    # the state's dtype (pallas_step.py:912-914, :963, out :1063); the
    # port sums in the state's dtype, so the flux agrees to f32 round-off
    # of a sum of a few tile partials
    assert jflux.dtype == jnp.float32 and tflux.dtype == torch.float64
    _close(tflux, jflux, rtol=1e-6, atol=0.0)


# --- (c) eligibility ---------------------------------------------------

PLAN_CASES = [
    # tests/test_temporal.py
    (dict(c_num=4, c_space=48, ydim=256, **F64), 2, "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=256, **F64), 4, "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=256, **F64), 8, "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=192, **F64), 4, "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=136, **F64), 4, "no_mucus"),
    (dict(c_num=12, c_space=128, ydim=192, **F64), 2, "no_mucus"),
    (dict(c_num=64, c_space=128, ydim=8192, dtype="float32"), 8,
     "no_mucus"),
    # tests/test_band_super.py
    (dict(c_num=3, c_space=128, ydim=256, **F64), 2, "no_mucus"),
    (dict(c_num=3, c_space=128, ydim=256, **F64), 4, "no_mucus"),
    (dict(c_num=2, c_space=128, ydim=256, **F64), 4, "no_mucus"),
    (dict(c_num=3, c_space=128, ydim=256, dtype="float32"), 4, "no_mucus"),
    (dict(c_num=3, c_space=128, ydim=256, **F64), 4, "mucus"),
    # tests/test_auto_temporal.py
    (dict(c_num=4, c_space=48, ydim=256, **F64), "auto", "no_mucus"),
    (dict(c_num=3, c_space=128, ydim=256, **F64), "auto", "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=136, **F64), "auto", "no_mucus"),
    (dict(c_num=2, c_space=96, dtype="float32"), "auto", "no_mucus"),
    # the smoke sizes: the CLI's 288 x 192 and 2048^2
    (dict(c_num=6, c_space=48, dtype="float32"), "auto", "no_mucus"),
    (dict(c_num=16, c_space=128, ydim=2048, dtype="float32"), "auto",
     "no_mucus"),
    # bf16 storage (16-row alignment): the smoke sizes and both legs
    (dict(c_num=6, c_space=48, **BF16), "auto", "no_mucus"),
    (dict(c_num=16, c_space=128, ydim=2048, **BF16), "auto", "no_mucus"),
    (dict(c_num=3, c_space=128, ydim=256, **BF16), 4, "no_mucus"),
    (dict(c_num=4, c_space=48, ydim=256, **BF16), 4, "no_mucus"),
]


def _jax_plan(jcfg, K, pattern):
    """(K, leg, pad, pad_s, halo) the JAX package resolves on the CPU, or
    None where it refuses."""
    try:
        sim = JaxSim(jcfg, backend="pallas", temporal=K, pattern=pattern)
    except ValueError:
        return None
    if sim.temporal == 1:
        return (1, "single_step", None, None, None)
    leg = sim.resolved_config()["band_leg"]
    sup = leg == "band_super_whole"
    return (sim.temporal, leg, sim._band_pad,
            sim._band_pad_s if sup else None,
            sim._band_super.halo if sup else None)


def _port_plan(tcfg, K, pattern):
    dtype = {"float32": torch.float32, "float64": torch.float64,
             "bfloat16": torch.bfloat16}[tcfg.dtype]
    walls = ref.REFERENCE_WALLS
    if K == "auto":
        plan, _ = plan_auto(tcfg, walls, dtype, pattern)
    else:
        try:
            plan = plan_temporal(tcfg, K, walls, dtype, pattern)
        except ValueError:
            return None
    if plan is None:
        return (1, "single_step", None, None, None)
    return (plan.K, plan.band_leg, plan.pad, plan.pad_s, plan.halo)


@pytest.mark.parametrize("kw,K,pattern", PLAN_CASES)
def test_plan_matches_jax_on_the_cpu(kw, K, pattern):
    jcfg, tcfg = _cfgs(**kw)
    assert _port_plan(tcfg, K, pattern) == _jax_plan(jcfg, K, pattern)


def test_plan_at_8192_takes_k16_where_the_tpu_budget_took_k8():
    # JAX's bulk kernel keeps 3K full-width rings in VMEM (80 MB budget):
    # at 8192 columns K = 16 does not fit, so auto walks down to K = 8.
    # The port's bulk keeps no rings and takes K = 16 (PERF.md lists the
    # dropped budget).
    kw = dict(c_num=64, c_space=128, ydim=8192, dtype="float32")
    jcfg, tcfg = _cfgs(**kw)
    assert _jax_plan(jcfg, "auto", "no_mucus")[:2] == (8, "band_super_whole")
    assert _port_plan(tcfg, "auto", "no_mucus")[:2] == (16,
                                                        "band_super_whole")


@pytest.mark.parametrize("kw,K", [
    (dict(c_num=16, c_space=128, ydim=2048, dtype="float64"), "auto"),
    (dict(c_num=64, c_space=128, ydim=8192, dtype="float32"), 8),
    (dict(c_num=64, c_space=128, ydim=8192, dtype="float64"), 4),
])
def test_plans_take_the_whole_band_where_the_l2_rule_split_it(kw, K):
    # the smoke sizes where the card's L2 as a budget took the x-tiled leg:
    # with no budget on any device the port plans the whole band
    # super-step, as JAX plans on the CPU (at JAX's K: its bulk's VMEM
    # rings cap K at 8192^2, 8 in f32 and 4 in f64), and auto's K = 16
    # takes it too
    jcfg, tcfg = _cfgs(**kw)
    got = _port_plan(tcfg, K, "no_mucus")
    assert got == _jax_plan(jcfg, K, "no_mucus")
    assert got[1] == "band_super_whole"
    assert _port_plan(tcfg, "auto", "no_mucus")[:2] == (16,
                                                        "band_super_whole")
    sim = MucociliarySim(tcfg, device="cpu", temporal=16)
    assert sim.plan.band_leg == "band_super_whole"


def test_no_module_plans_by_the_card_l2():
    # the simulations plan no footprint budget on any device: only the
    # probes' module reads the card's L2 size (l2_bytes, the budget that
    # builds the legs the leg probe measures against the whole ones)
    import pathlib

    import cuda_iblb_11_tpu_torch

    root = pathlib.Path(cuda_iblb_11_tpu_torch.__file__).parent
    readers = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                     if "L2_cache_size" in p.read_text())
    assert readers == ["ops/probes.py"]


def test_auto_resolves_to_one_off_the_cuda_backend():
    sim = MucociliarySim(SimConfig(c_num=6, c_space=48), device="cpu",
                         temporal="auto")
    assert sim.temporal == 1 and sim.plan is None
    assert "no temporal path" in sim.temporal_reason
    with pytest.raises(ValueError):
        MucociliarySim(SimConfig(c_num=4, c_space=48, ydim=136), device="cpu",
                       temporal=4)


# --- (d), (e) the whole temporal path ----------------------------------

LEGS = {
    "per_substep": dict(c_num=4, c_space=48, ydim=256, **F64),
    "band_super_whole": dict(c_num=3, c_space=128, ydim=256, **F64),
}


def _np_state(st):
    return type(st)(*map(np.asarray, st))


@pytest.fixture(scope="module", params=sorted(LEGS))
def jax_temporal(request):
    """JAX pallas K = 4: states after 8 and 16 steps (16 = 8 + 8) and after
    11 steps, as numpy."""
    jcfg = JaxConfig(**LEGS[request.param])
    sim = JaxSim(jcfg, backend="pallas", temporal=4)
    assert sim.resolved_config()["band_leg"] == request.param
    s8 = sim.run_chunk(sim.init_state(), 8)
    s8_np = _np_state(s8)
    s16 = _np_state(sim.run_chunk(s8, 8))
    s11 = _np_state(sim.run_chunk(sim.init_state(), 11))
    return request.param, s8_np, s16, s11


def _port_sim(leg):
    sim = MucociliarySim(SimConfig(**LEGS[leg]), backend="torch",
                         device="cpu", temporal=4)
    assert sim.temporal == 4 and sim.plan.band_leg == leg
    rc = sim.resolved_config()
    assert rc["band_leg"] == leg and rc["temporal"] == 4
    return sim


def _close_state(st, want):
    _close(st.f, want.f)
    _close(st.force, want.force, rtol=1e-10, atol=1e-18)
    _close(st.q, want.q, atol=0.0)
    assert st.it == int(want.it)


@pytest.mark.parametrize("n", [16, 11])
def test_temporal_sim_matches_jax(jax_temporal, n):
    leg, _, s16, s11 = jax_temporal
    sim = _port_sim(leg)
    st = sim.run_chunk(sim.init_state(), n)
    _close_state(st, s16 if n == 16 else s11)


def test_temporal_state_carried_across(jax_temporal):
    leg, s8, s16, _ = jax_temporal
    st = state_from_numpy(*s8, device="cpu")
    assert st.it == 8
    _close_state(_port_sim(leg).run_chunk(st, 8), s16)
