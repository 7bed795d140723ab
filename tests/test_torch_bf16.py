"""bf16 storage (the JAX package's fast mode, --dtype bfloat16) in the port
against the JAX package, on the CPU.  JAX runs its Pallas kernels in
interpret mode, as its own tests do; the port's side is the plain version
of each kernel (a wrapper given CPU tensors takes it).  Inputs are made
from a numpy seed: deviatoric f near equilibrium, rounded to bf16, and an
f32 force.  f is bf16, everything else f32.

(a) Each kernel's plain version in bf16 against the JAX kernel in bf16:
    B2 (make_fused_substep with emission), B2h (the quirk path's
    make_fused_substep without emission), B3 (make_sharded_fused_substep,
    the band leg's flags), B4 (make_temporal_bulk_substep, K = 2 and 4)
    and B5 (make_band_super_substep, K = 2 and 4).  f: at least 99.9% of
    elements bit-equal and at most one bf16 ulp apart, the ulp taken at
    no less than 2^-14 of the plane's largest magnitude
    (ops/precision.bf16_agreement).  Measured: B2 99.9946% bit-equal, B3
    99.9912%, B4 99.979% (K = 2) and 99.969% (K = 4), B5 99.980% and
    99.967%; every element within one floored ulp.  Unfloored, values
    near zero differ by more (B2: one element of 147,456, 2.6e-9 in a
    plane whose largest value is 6.0e-3, 5 ulps of its own size; B4 up to
    232): f32 cancellation leaves them a few ulps of their own size, far
    below the f32 round-off of the terms that made them.  The f32 outputs
    (q, fluxcol, the exposed row, bhalos, force, flux) at rtol 1e-6 with
    an absolute floor of 1e-6 of the array's largest magnitude (measured:
    at most 3.4e-7 of it, B5's force at K = 4).
(b) The slice as a whole: the port's MucociliarySim(dtype=bfloat16,
    backend="torch") against JAX's backend="pallas", each beside JAX's own
    jnp backend in bf16 and the port's f32.  At temporal 1 (200 steps,
    c_num 2, c_space 128, ydim 64) the port's f rel-L2 and Q distance from
    JAX Pallas are at most 1.25x JAX's own jnp-vs-Pallas bf16 distance and
    under half the port's bf16-vs-f32 distance.  Measured: f 3.19e-3
    against 3.19e-3 (jnp) and 1.16e-2 (f32), Q 3.6e-4 against 4.7e-4 and
    3.1e-3.  At temporal 4 on the smallest grid where JAX's band
    super-step engages (384 x 256, c_num 3, 48 steps, band_super_whole
    in both) the first gate holds (f 1.47e-3 against 4.46e-3, Q 1.4e-6
    against 3.8e-4), but the second cannot: the band super-step rounds f
    once per 4 steps, so the port's bf16 lies only 1.9e-3 from its f32,
    and two bf16 runs whose bits part one ulp at a time drift 1.5e-3
    apart.  There the port's bf16 must instead lie nearer JAX's bf16 than
    the port's f32 does, and agree with it bit for bit in at least 99.9%
    of f after the first super-step (measured 99.989%; the share falls
    by about 0.1% a super-step after that).
(c) A JAX bf16 state crosses to the port and back bit for bit; the port's
    bf16 npz holds the f bytes JAX's save writes, and the port resumes
    from JAX's npz (JAX's own load refuses it: ROADMAP Queue 3).
The bf16 plans are held to JAX's CPU plans in test_torch_temporal.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.io import checkpoint as jckpt
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops import reference as jref
from cuda_iblb_11_tpu.ops.pallas_step import (
    make_band_super_substep, make_fused_substep, make_sharded_fused_substep,
    make_temporal_bulk_substep,
)
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.core.state import (
    state_from_numpy, state_to_numpy,
)
from cuda_iblb_11_tpu_torch.io import checkpoint as tckpt
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import band_super_reference
from cuda_iblb_11_tpu_torch.ops.collide_stream import (
    collide_stream, collide_stream_reference,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference, sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.precision import bf16_agreement
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import temporal_bulk_reference

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

BF16 = dict(dtype="bfloat16", storage="deviatoric")
STEP_GRID = dict(c_num=2, c_space=128, ydim=64, length=16)   # band 48
SUPER_GRID = dict(c_num=3, c_space=128, ydim=256)             # band_super
TILE = 16          # JAX's bf16 kernels take 16-row tiles
SHARE, ULPS, RTOL = 0.999, 1.0, 1e-6


def _cfgs(**kw):
    kw = {**kw, **BF16}
    return JaxConfig(**kw), SimConfig(**kw)


def _f(rng, rows, xdim):
    """Deviatoric f near equilibrium (rows [9, rows, X]), as f32 numpy."""
    rho = 1.0 + 0.02 * rng.standard_normal((rows, xdim))
    u = 0.01 * rng.standard_normal((2, rows, xdim))
    f = np.asarray(jref.equilibrium(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-4 * rng.standard_normal(f.shape) * W[:, None, None]
    return (f - W[:, None, None]).astype(np.float32)


def _force(rng, band, xdim):
    return (1e-4 * rng.standard_normal((2, band, xdim))).astype(np.float32)


def _jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _pad8(h):
    """[9, X] -> JAX's [9, 8, X] halo block (row 0 used)."""
    return np.concatenate([h[:, None], np.zeros((9, 7, h.shape[-1]),
                                                h.dtype)], 1)


def _bits(a):
    """A JAX bf16 array as a port bf16 tensor of the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _same_f(got, want):
    share, _, ulps = bf16_agreement(got, _bits(want))
    assert share >= SHARE and ulps <= ULPS, (share, ulps)


def _close32(got, want):
    want = np.asarray(want, np.float64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


# --- (a) each kernel --------------------------------------------------

@pytest.mark.parametrize("top", ["slip", "noslip"])
def test_b2_plain_matches_jax_bf16(top):
    jcfg, tcfg = _cfgs(**STEP_GRID)
    rng = np.random.default_rng(0)
    f, force = _f(rng, tcfg.ydim, tcfg.xdim), _force(rng, tcfg.force_band,
                                                      tcfg.xdim)
    jfn = make_fused_substep(jcfg, jref.WallSpec(top=top),
                             dtype=jnp.bfloat16, interpret=True,
                             tile_y=TILE, storage="deviatoric",
                             emit_moments=True)
    jf, jq, jcol = jfn(_jb(f), jnp.asarray(force))
    tf, tq, tcol = fused_substep_reference(
        _tb(f), torch.from_numpy(force), tcfg, ref.WallSpec(top=top),
        "trt_split", "deviatoric")
    assert tf.dtype == torch.bfloat16
    _same_f(tf, jf)
    _close32(tq, jq)
    _close32(tcol, np.asarray(jcol)[:, :, 0])
    # the wrapper takes the plain version for CPU tensors, bf16 included
    before = fused_substep.launches
    got = fused_substep(_tb(f), torch.from_numpy(force), tcfg,
                        ref.WallSpec(top=top), storage="deviatoric")
    assert torch.equal(got[0], tf) and fused_substep.launches == before


def test_b2h_plain_matches_jax_bf16():
    # the quirk path's step: JAX builds make_fused_substep without
    # emission (its pipeline=False kernel refuses bf16)
    jcfg, tcfg = _cfgs(**STEP_GRID)
    rng = np.random.default_rng(1)
    f, force = _f(rng, tcfg.ydim, tcfg.xdim), _force(rng, tcfg.force_band,
                                                      tcfg.xdim)
    jfn = make_fused_substep(jcfg, jref.WallSpec(top="slip"),
                             dtype=jnp.bfloat16, interpret=True,
                             tile_y=TILE, storage="deviatoric")
    jf = jfn(_jb(f), jnp.asarray(force))
    args = (_tb(f), torch.from_numpy(force), tcfg.tau, tcfg.tau2,
            ref.WallSpec(top="slip"), "trt_split", "deviatoric")
    tf = collide_stream_reference(*args)
    _same_f(tf, jf)
    assert torch.equal(collide_stream(*args), tf)


@pytest.mark.parametrize("flags", [(0, 1, 0), (0, 1, 1)])
def test_b3_plain_matches_jax_bf16(flags):
    # the band leg's extended band: bottom wall, the f1 of row band-1
    # exposed, q and the flux column emitted
    jcfg, tcfg = _cfgs(**STEP_GRID)
    band, xdim = tcfg.force_band, tcfg.xdim
    rows = band + 16
    rng = np.random.default_rng(3)
    f, force = _f(rng, rows, xdim), _force(rng, band, xdim)
    bhalo, thalo = _f(rng, 2, xdim).transpose(1, 0, 2)
    sub = make_sharded_fused_substep(
        jcfg, rows, jref.WallSpec(top="slip"), jnp.bfloat16,
        storage="deviatoric", expose_f1_row=band - 1, emit_moments=True,
        interpret=True, tile_y=TILE)
    jf, jrow, jq, jcol = sub(jnp.asarray(flags, jnp.int32), _jb(f),
                             jnp.asarray(force), jnp.asarray(_pad8(bhalo)),
                             jnp.asarray(_pad8(thalo)))
    t = torch.from_numpy
    tf, trow, tq, tcol = sharded_fused_substep_reference(
        flags, _tb(f), t(force), t(bhalo), t(thalo), tcfg,
        ref.WallSpec(top="slip"), "trt_split", "deviatoric", band - 1, True)
    _same_f(tf, jf)
    _close32(trow, np.asarray(jrow)[:, 0])
    _close32(tq, jq)
    _close32(tcol, np.asarray(jcol)[..., 0])


@pytest.mark.parametrize("K,top", [(2, "slip"), (4, "noslip")])
def test_b4_plain_matches_jax_bf16(K, top):
    jcfg, tcfg = _cfgs(**SUPER_GRID)
    rows, xdim = tcfg.ydim - tcfg.force_band, tcfg.xdim
    rng = np.random.default_rng(4)
    f = _f(rng, rows, xdim)
    bhalos = np.ascontiguousarray(_f(rng, K, xdim).transpose(1, 0, 2))
    sub = make_temporal_bulk_substep(jcfg, rows, K, jref.WallSpec(top=top),
                                     jnp.bfloat16, storage="deviatoric",
                                     interpret=True)
    jf, jflux = sub(_jb(f), jnp.asarray(np.stack([_pad8(h)
                                                  for h in bhalos])))
    tf, tflux = temporal_bulk_reference(
        _tb(f), torch.from_numpy(bhalos), tcfg, ref.WallSpec(top=top),
        "trt_split", "deviatoric")
    assert tf.dtype == torch.bfloat16
    _same_f(tf, jf)
    _close32(tflux, jflux)


@pytest.mark.parametrize("K", [2, 4])
def test_b5_plain_matches_jax_bf16(K):
    jcfg, tcfg = _cfgs(**SUPER_GRID)
    band, xdim = tcfg.force_band, tcfg.xdim
    sim = MucociliarySim(tcfg, backend="torch", device="cpu", temporal=K)
    assert sim.plan.band_leg == "band_super_whole"
    halo, pad = sim.plan.halo, sim.plan.pad_s
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(137, K)
    # the points at the compute type, as the model builds them
    xs = [x[0] for x in prep_band_super_points(
        tcfg, K, halo, torch.float32, u_s, eps, anchor, frac, 1)]
    rng = np.random.default_rng(5)
    f_ext, force = _f(rng, band + pad, xdim), _force(rng, band, xdim)
    sub = make_band_super_substep(jcfg, pad, K, dtype=jnp.bfloat16,
                                  storage="deviatoric", interpret=True)
    assert sub.halo == halo
    jf, jbh, jforce, jflux = sub(_jb(f_ext), jnp.asarray(force),
                                 *(jnp.asarray(x.numpy()) for x in xs))
    tf, tbh, tforce, tflux = band_super_reference(
        _tb(f_ext), torch.from_numpy(force), *xs, tcfg, halo,
        storage="deviatoric")
    assert tf.dtype == torch.bfloat16
    _same_f(tf, jf)
    _close32(tbh, np.asarray(jbh)[:, :, 0])
    _close32(tforce, jforce)
    assert np.abs(np.asarray(jforce)).max() > 1e-8   # the IB is engaged
    _close32(tflux, jflux)


# --- (b) the slice as a whole ------------------------------------------

def _jax_state(kw, backend, temporal, steps):
    sim = JaxSim(JaxConfig(**kw), backend=backend, temporal=temporal)
    return sim, sim.run_chunk(sim.init_state(), steps)


def _dist(a_f, a_q, b_f, b_q):
    """(f rel-L2, Q relative) of run a from run b, in f64."""
    a_f, b_f = a_f.double(), b_f.double()
    return (float(torch.linalg.norm(a_f - b_f) / torch.linalg.norm(b_f)),
            abs(a_q - b_q) / abs(b_q))


def _whole(kw, temporal, steps):
    """f (bf16 as torch, f32) and Q of: JAX pallas bf16, JAX jnp bf16, the
    port's torch backend in bf16 and in f32."""
    out = {}
    for name, backend in (("pallas", "pallas"), ("jnp", "jnp")):
        _, st = _jax_state({**kw, **BF16}, backend,
                           temporal if backend == "pallas" else 1, steps)
        out[name] = (_bits(st.f), float(st.q))
    for dt in ("bfloat16", "float32"):
        sim = MucociliarySim(SimConfig(dtype=dt, **kw), backend="torch",
                             device="cpu", temporal=temporal)
        st = sim.run_chunk(sim.init_state(), steps)
        out[dt] = (st.f, float(st.q))
    return out


def test_sim_bf16_matches_jax_pallas_single_step():
    r = _whole(dict(c_num=2, c_space=128, ydim=64), 1, 200)
    port = _dist(*r["bfloat16"], *r["pallas"])
    jax_own = _dist(*r["jnp"], *r["pallas"])
    vs_f32 = _dist(*r["bfloat16"], *r["float32"])
    for p, j, v in zip(port, jax_own, vs_f32):
        assert p <= 1.25 * j and p < 0.5 * v, (port, jax_own, vs_f32)


def test_sim_bf16_matches_jax_pallas_band_super():
    kw = dict(SUPER_GRID)
    jsim = JaxSim(JaxConfig(**kw, **BF16), backend="pallas", temporal=4)
    tsim = MucociliarySim(SimConfig(**kw, **BF16), backend="torch",
                          device="cpu", temporal=4)
    assert jsim.resolved_config()["band_leg"] == "band_super_whole"
    assert tsim.resolved_config()["band_leg"] == "band_super_whole"
    # the first super-step: the rounding points agree bit for bit
    j4 = jsim.run_chunk(jsim.init_state(), 4)
    t4 = tsim.run_chunk(tsim.init_state(), 4)
    share, _, ulps = bf16_agreement(t4.f, _bits(j4.f))
    assert share >= SHARE and ulps <= ULPS, (share, ulps)
    # 48 steps
    jst = jsim.run_chunk(j4, 44)
    r = {"pallas": (_bits(jst.f), float(jst.q))}
    _, jj = _jax_state({**kw, **BF16}, "jnp", 1, 48)
    r["jnp"] = (_bits(jj.f), float(jj.q))
    tst = tsim.run_chunk(t4, 44)
    r["bfloat16"] = (tst.f, float(tst.q))
    fsim = MucociliarySim(SimConfig(dtype="float32", **kw), backend="torch",
                          device="cpu", temporal=4)
    fst = fsim.run_chunk(fsim.init_state(), 48)
    r["float32"] = (fst.f, float(fst.q))
    port = _dist(*r["bfloat16"], *r["pallas"])
    jax_own = _dist(*r["jnp"], *r["pallas"])
    f32_from_jax = _dist(*r["float32"], *r["pallas"])
    for p, j, g in zip(port, jax_own, f32_from_jax):
        assert p <= 1.25 * j and p < g, (port, jax_own, f32_from_jax)


# --- (c) state crossing and checkpoints ---------------------------------

@pytest.fixture(scope="module")
def jax_bf16_state():
    """JAX jnp bf16 after 20 steps at the step grid: (sim, state)."""
    return _jax_state({**dict(c_num=2, c_space=128, ydim=64), **BF16},
                      "jnp", 1, 20)


def test_jax_bf16_state_crosses_bit_for_bit(jax_bf16_state):
    _, st = jax_bf16_state
    f = np.asarray(st.f)
    assert f.dtype == ml_dtypes.bfloat16
    port = state_from_numpy(*(np.asarray(x) for x in st), device="cpu")
    assert port.f.dtype == torch.bfloat16
    assert port.force.dtype == torch.float32 and port.it == 20
    back = state_to_numpy(port)
    assert back["f"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(back["f"].view(np.uint16),
                                  f.view(np.uint16))
    np.testing.assert_array_equal(back["force"], np.asarray(st.force))
    # and as JAX reads them back: the same bf16 values
    np.testing.assert_array_equal(
        back["f"].view(ml_dtypes.bfloat16).astype(np.float32),
        f.astype(np.float32))


def test_bf16_npz_holds_jax_bytes_and_resumes(jax_bf16_state, tmp_path):
    jsim, st = jax_bf16_state
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, st, jsim.cfg)
    # JAX's own load refuses its bf16 npz (f is stored as |V2)
    with pytest.raises(TypeError, match="V2"):
        jckpt.load(jpath)
    state, cfg = tckpt.load(jpath, device="cpu")
    assert state.f.dtype == torch.bfloat16 and cfg.dtype == "bfloat16"
    tckpt.save(tpath, state, cfg)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert zt["f"].dtype == zj["f"].dtype == np.dtype("V2")
        assert zt["f"].tobytes() == zj["f"].tobytes()
        for k in ("force", "lasts", "q", "it"):
            np.testing.assert_array_equal(zt[k], zj[k])
    # the port resumes from JAX's npz as from the state in memory
    sim = MucociliarySim(cfg, backend="torch", device="cpu")
    a = sim.run_chunk(state, 10)
    b = sim.run_chunk(state_from_numpy(*(np.asarray(x) for x in st)), 10)
    assert torch.equal(a.f, b.f) and a.it == 30
    # the port's own npz reads back to the same bits
    again, _ = tckpt.load(tpath, cfg, device="cpu")
    assert torch.equal(again.f.view(torch.int16), state.f.view(torch.int16))


def cli_q_drift(chunks=4, chunk=500, kw=(("c_num", 6), ("c_space", 48))):
    """Q of bf16 against f32 at the reference channel's CLI size (the
    chip's 2,000-step CLI runs) after each chunk, for JAX jnp and the
    port's torch backend: {name: [rel, ...]}."""
    kw = dict(kw)
    q = {}
    for dt in ("float32", "bfloat16"):
        jsim = JaxSim(JaxConfig(dtype=dt, **kw), backend="jnp")
        tsim = MucociliarySim(SimConfig(dtype=dt, **kw), backend="torch",
                              device="cpu")
        for name, sim in (("jax jnp", jsim), ("port torch", tsim)):
            st, qs = sim.init_state(), []
            for _ in range(chunks):
                st = sim.run_chunk(st, chunk)
                qs.append(float(st.q))
            q[name, dt] = qs
    return {name: [abs(b - a) / abs(a) for a, b in
                   zip(q[name, "float32"], q[name, "bfloat16"])]
            for name in ("jax jnp", "port torch")}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_bf16.py: the bf16-vs-f32 Q
    # drift at the CLI's size, JAX jnp beside the port (about 2 minutes)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, rels in cli_q_drift().items():
        print(f"{name}: bf16 Q against f32 after 500, 1000, 1500, 2000 "
              f"steps: " + ", ".join(f"{r:.4%}" for r in rels))
