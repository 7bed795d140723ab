"""B6, the x-tiled band super-step, and the leg rule that takes it: the
port against the JAX package on the CPU (JAX in interpret mode, the port's
plain versions), inputs from a numpy seed, f64.

(a) band_super_resident, band_super_reach and band_super_block_windows
    equal the JAX package's integer functions (the reach as JAX rounds it
    on the TPU);
(b) the tile search and the leg rule: with JAX's 100 MiB budget the port
    picks the tile JAX's factory picks (interpret=False) at 8192^2; with
    the H100's L2 as the budget (52,428,800 bytes) the plans of 2048^2,
    8192^2 and 288 x 192 are those that JAX's search would take under it;
(c) band_super_tiled_reference against make_band_super_substep_tiled
    (interpret mode) at tests/test_temporal.py's tiled configuration
    (c_num 12, c_space 128, ydim 192, K = 2, tile 512, gx 400): f_band,
    bhalos and flux rtol 1e-12, force rtol 1e-10 / atol 1e-18 (as
    tests/test_torch_band_super.py);
(d) B6 against B5 (both plain) on the same inputs, held to 1e-13 of each
    output's scale: the tiles run their window products on other column
    ranges, so they may differ at round-off (7e-18 on f_band and 3e-18 on
    the force with gx 400; bit for bit with the plan's gx 512);
(e) the port's temporal sim on the x-tiled leg against the JAX sim with its
    band super-step swapped for the tiled factory (as tests/test_temporal.py
    does), 6 steps: f rtol 1e-12, force rtol 1e-10 / atol 1e-12 of its
    scale, q rtol 1e-12; the wrapper refuses a tile the design does not
    take; and the CLI's SimLog names the x-tiled leg when it runs.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops.pallas_step import (
    _band_super_block_windows, _band_super_reach, _band_super_resident,
    make_band_super_substep_tiled,
)
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.models.mucociliary import prep_band_super_points
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import band_super_reference
from cuda_iblb_11_tpu_torch.ops.band_super_tiled import (
    band_super_tiled, band_super_tiled_reference, tile_layout,
)
from cuda_iblb_11_tpu_torch.ops.temporal import (
    band_super_block_windows, band_super_reach, band_super_resident,
    pick_band_tile, plan_auto, plan_temporal,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

H100_L2 = 52_428_800          # torch.cuda.get_device_properties().L2_cache_size
TILED = dict(c_num=12, c_space=128, ydim=192, dtype="float64", storage="raw")
K2, TILE, GX_INTERPRET = 2, 512, 400
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "bfloat16": torch.bfloat16}


# --- (a) the integer rules ----------------------------------------------

@pytest.mark.parametrize("width,rows,band,extra", [
    (8192, 144, 128, 256), (2048, 144, 128, 0), (1280, 136, 128, 0),
    (1536, 136, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_band_super_resident_matches_jax(width, rows, band, extra, dtype):
    jd = jnp.dtype(dtype)
    cdt = jnp.promote_types(jd, jnp.float32)
    assert (band_super_resident(width, rows, band, extra, TORCH[dtype])
            == _band_super_resident(width, rows, band, extra, jd, cdt))


@pytest.mark.parametrize("cw,halo,K", [(128, 128, 16), (128, 128, 8),
                                       (128, 128, 2), (96, 128, 4),
                                       (256, 0, 16)])
def test_band_super_reach_matches_jax_on_the_tpu(cw, halo, K):
    assert band_super_reach(cw, halo, K) == _band_super_reach(cw, halo, K,
                                                              False)


@pytest.mark.parametrize("c_num,cw,halo,block_w,gx", [
    (12, 128, 128, 512, 400), (12, 128, 128, 512, 512),
    (64, 128, 128, 1024, 512), (16, 128, 128, 256, 512)])
def test_block_windows_match_jax(c_num, cw, halo, block_w, gx):
    n = c_num * cw // block_w
    assert band_super_block_windows(c_num, cw, halo, block_w, gx, n) == \
        _band_super_block_windows(c_num, cw, halo, block_w, gx, n)


# --- (b) the tile search and the leg rule -------------------------------

def _jax_search(cfg, rows, K, halo, dtype, budget):
    """make_band_super_substep_tiled's search (pallas_step.py:1643-1662)
    with JAX's own helpers, the 128-lane tile alignment dropped and the
    budget given."""
    jd = jnp.dtype(dtype)
    cdt = jnp.promote_types(jd, jnp.float32)
    cw, xdim, band = cfg.c_space, cfg.xdim, cfg.force_band
    gx = _band_super_reach(cw, halo, K, False)
    for m in range(xdim // (2 * cw), 0, -1):
        tx = m * cw
        if (xdim % tx == 0 and xdim // tx >= 2 and tx + 2 * gx <= xdim
                and _band_super_resident(tx + 2 * gx, rows, band, 0, jd,
                                         cdt) <= budget):
            return tx, gx
    return None


def test_tile_search_matches_jax_factory_at_8192():
    # JAX's 100 MiB budget: its factory (built for the TPU) and the port
    # pick the same tile and ghost margin
    kw = dict(c_num=64, c_space=128, ydim=8192, dtype="float32")
    sub = make_band_super_substep_tiled(JaxConfig(**kw), 8, 8,
                                        interpret=False)
    cfg = SimConfig(**kw)
    assert (sub.tile_x, sub.gx) == (4096, 512)
    assert pick_band_tile(cfg, cfg.force_band + 8, 8, sub.halo,
                          torch.float32, 100 << 20) == (4096, 512)
    plan = plan_temporal(cfg, 8, ref.REFERENCE_WALLS, torch.float32,
                         budget=100 << 20)
    assert (plan.band_leg, plan.tile_x, plan.gx) == ("band_super_xtiled",
                                                     4096, 512)


@pytest.mark.parametrize("kw,want", [
    (dict(c_num=64, c_space=128, ydim=8192, dtype="float32"),
     (16, "band_super_xtiled", 1024, 512)),
    (dict(c_num=64, c_space=128, ydim=8192, dtype="float64"),
     (16, "band_super_xtiled", 256, 512)),
    (dict(c_num=16, c_space=128, ydim=2048, dtype="float32"),
     (16, "band_super_whole", None, None)),
    (dict(c_num=16, c_space=128, ydim=2048, dtype="float64"),
     (16, "band_super_xtiled", 256, 512)),
    (dict(c_num=6, c_space=48, dtype="float32"),
     (16, "per_substep", None, None)),
])
def test_plan_on_the_h100_budget(kw, want):
    cfg = SimConfig(**kw)
    dtype = TORCH[kw["dtype"]]
    plan, reason = plan_auto(cfg, ref.REFERENCE_WALLS, dtype,
                             budget=H100_L2)
    assert (plan.K, plan.band_leg, plan.tile_x, plan.gx) == want
    if plan.band_leg == "band_super_xtiled":
        assert f"tile {plan.tile_x}, gx {plan.gx}" in reason
        assert (plan.tile_x, plan.gx) == _jax_search(
            JaxConfig(**kw), cfg.force_band + plan.pad_s, plan.K, plan.halo,
            kw["dtype"], H100_L2)
    # without a budget (the CPU) the whole leg stays wherever it fits
    free, _ = plan_auto(cfg, ref.REFERENCE_WALLS, dtype)
    assert free.band_leg == ("per_substep" if want[1] == "per_substep"
                             else "band_super_whole")


def test_no_tile_fits_falls_to_per_substep():
    cfg = SimConfig(**TILED)
    plan = plan_temporal(cfg, 2, ref.REFERENCE_WALLS, torch.float64,
                         budget=1 << 20)
    assert plan.band_leg == "per_substep" and plan.pad_s is None


# --- (c), (d) the kernel's plain version --------------------------------

@pytest.fixture(scope="module")
def tiled_inputs():
    """f_ext, force and the points of K = 2 real steps from it = 137 at
    the tiled configuration, as numpy and torch; the JAX tiled factory."""
    tcfg = SimConfig(**TILED)
    sim = MucociliarySim(tcfg, backend="torch", device="cpu", temporal=K2)
    plan = sim.plan
    assert plan.band_leg == "band_super_whole"
    _, u_s, eps, anchor, frac, _ = sim.step_kinematics(137, K2)
    xs = [x[0] for x in prep_band_super_points(
        tcfg, K2, plan.halo, torch.float64, u_s, eps, anchor, frac, 1)]
    band, xdim = tcfg.force_band, tcfg.xdim
    rng = np.random.default_rng(7)
    w = np.asarray(W)[:, None, None]
    f_ext = w * (1.0 + 0.05 * rng.standard_normal((9, band + plan.pad_s,
                                                   xdim)))
    force = 1e-4 * rng.standard_normal((2, band, xdim))
    sub = make_band_super_substep_tiled(JaxConfig(**TILED), plan.pad_s, K2,
                                        dtype=jnp.float64, storage="raw")
    assert (sub.tile_x, sub.gx, sub.halo) == (TILE, GX_INTERPRET, plan.halo)
    return tcfg, plan, f_ext, force, xs, sub


def _tiled(tiled_inputs, gx=GX_INTERPRET):
    tcfg, plan, f_ext, force, xs, _ = tiled_inputs
    return band_super_tiled_reference(
        torch.from_numpy(f_ext), torch.from_numpy(force), *xs, tcfg,
        plan.halo, TILE, gx, storage="raw")


def test_b6_plain_matches_jax_tiled(tiled_inputs):
    _, _, f_ext, force, xs, sub = tiled_inputs
    jf, jbh, jforce, jflux = sub(jnp.asarray(f_ext), jnp.asarray(force),
                                 *(jnp.asarray(x.numpy()) for x in xs))
    tf, tbh, tforce, tflux = _tiled(tiled_inputs)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(tbh.numpy(), np.asarray(jbh)[:, :, 0],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tforce.numpy(), np.asarray(jforce),
                               rtol=1e-10, atol=1e-18)
    assert np.abs(np.asarray(jforce)).max() > 1e-8   # the IB is engaged
    np.testing.assert_allclose(tflux.numpy(), np.asarray(jflux), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("gx", [GX_INTERPRET, 512])
def test_b6_plain_matches_b5_plain(tiled_inputs, gx):
    tcfg, plan, f_ext, force, xs, _ = tiled_inputs
    whole = band_super_reference(torch.from_numpy(f_ext),
                                 torch.from_numpy(force), *xs, tcfg,
                                 plan.halo, storage="raw")
    for name, a, b in zip(("f_band", "bhalos", "force", "flux"),
                          _tiled(tiled_inputs, gx), whole):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-13 * scale, name


def test_b6_refuses_tiles_outside_the_design(tiled_inputs):
    tcfg, plan, f_ext, force, xs, _ = tiled_inputs
    with pytest.raises(ValueError, match="multiple of c_space"):
        tile_layout(tcfg, plan.halo, 320, 512, K2)       # not c_space-whole
    with pytest.raises(ValueError, match="exceeds"):
        tile_layout(tcfg, plan.halo, 768, 400, K2)       # block > domain
    with pytest.raises(ValueError, match="ghost margin"):
        tile_layout(tcfg, plan.halo, 512, 392, K2)       # gx < W + 8K
    with pytest.raises(ValueError, match="ghost margin"):
        band_super_tiled(torch.from_numpy(f_ext), torch.from_numpy(force),
                         *xs, tcfg, plan.halo, 512, 384)
    lay = tile_layout(tcfg, plan.halo, 512, 400, K2)
    # every tile takes the lifts whose windows lie inside its block, in
    # one layout: window j at win_lo0 + j c_space
    assert lay.n_tiles == 3 and lay.txe == 1312 and lay.win_lo0 == 16
    assert {len(c) for c in lay.cilia} == {8}
    assert lay.cilia[0] == (10, 11, 0, 1, 2, 3, 4, 5)


# --- (e) the temporal sim on the x-tiled leg ------------------------------

def test_temporal_sim_xtiled_matches_jax_tiled():
    jcfg, tcfg = JaxConfig(**TILED), SimConfig(**TILED)
    jsim = JaxSim(jcfg, backend="pallas", temporal=K2)
    jsim._band_super = make_band_super_substep_tiled(
        jcfg, jsim._band_pad_s, K2, jsim.walls, jsim.dtype,
        forcing=jsim.forcing, storage=jsim.storage)
    want = jsim.run_chunk(jsim.init_state(), 6)

    sim = MucociliarySim(tcfg, backend="torch", device="cpu", temporal=K2)
    whole = band_super_resident(tcfg.xdim, tcfg.force_band + sim.plan.pad_s,
                                tcfg.force_band, 2 * sim.plan.halo,
                                torch.float64)
    plan = plan_temporal(tcfg, K2, sim.walls, sim.dtype, budget=whole - 1)
    assert (plan.band_leg, plan.tile_x, plan.gx) == ("band_super_xtiled",
                                                     TILE, 512)
    assert dataclasses.replace(plan, band_leg="band_super_whole",
                               tile_x=None, gx=None) == sim.plan
    sim.plan = plan
    assert sim.resolved_config()["band_leg"] == "band_super_xtiled"
    st = sim.run_chunk(sim.init_state(), 6)
    np.testing.assert_allclose(st.f.numpy(), np.asarray(want.f), rtol=1e-12,
                               atol=1e-15)
    # 1e-12 of the force's scale: after 6 steps a few entries near the
    # edge of the delta support (|force| ~ 5e-8 of a 5e-3 scale) carry
    # 2e-17 of round-off, the port's whole leg against JAX's alike
    scale = float(np.abs(np.asarray(want.force)).max())
    np.testing.assert_allclose(st.force.numpy(), np.asarray(want.force),
                               rtol=1e-10, atol=1e-12 * scale)
    np.testing.assert_allclose(float(st.q), float(want.q), rtol=1e-12)
    assert st.it == 6


def test_cli_records_the_xtiled_leg(tmp_path, monkeypatch):
    # the CLI on a sim whose plan is held to a budget one byte below the
    # whole band's footprint (no device sets one): the run takes B6 and
    # SimLog names the leg
    from cuda_iblb_11_tpu_torch.cli import main
    from cuda_iblb_11_tpu_torch.models import mucociliary

    cfg = SimConfig(**TILED)
    whole = band_super_resident(cfg.xdim, cfg.force_band + 8,
                                cfg.force_band, 2 * 128, torch.float64)
    monkeypatch.setattr(mucociliary, "plan_temporal", functools.partial(
        plan_temporal, budget=whole - 1))
    assert main(["1", "12", "128", "1.0", "1.0", "5", "0.00004", "2", "0",
                 "0", "--quiet", "--device", "cpu", "--dtype", "float64",
                 "--output", str(tmp_path), "--temporal", "2"]) == 0
    log = (tmp_path / "Raw" / "12" / "1" / "SimLog.txt").read_text()
    assert "Iterations: 4" in log and "Temporal K: 2" in log
    assert "Kernel path: band_super_xtiled" in log
