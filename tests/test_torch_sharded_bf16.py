"""bf16 storage on a mesh (the JAX package's --dtype bfloat16 under --mesh)
in the port against the JAX package, on the CPU.  The port's shards run
the kernels' plain versions (every shard on the one CPU device); JAX runs
its Pallas mesh in interpret mode on the virtual CPU devices of
tests/conftest.py, as its own mesh tests do.  f is bf16, everything else
f32.

(a) B0's plain version in bf16 against make_collide_rows_kernel(...,
    jnp.bfloat16) in interpret mode: f1 float32 at rtol 1e-6 with PR 12's
    floor (an absolute 1e-6 of the largest |f1|).
(b) One call of each mesh leg from a common state (JAX jnp bf16 after
    START steps), the port against JAX's ShardedPallasSim /
    ShardedTemporalSim in bf16: the per-step exchange on (2, 2), K = 4 on
    (2, 1) (band_super_whole: B5 + B7), on (2, 2) at 2048 columns
    (band_super_xsharded: B8 + B7) and on (2, 2) at 384 columns
    (per_substep_tiled: B3 per sub-step + B7).  Where f rounds once per
    call (one step, B5, B8: their scratch and resident band are f32) at
    least 99.9% of f is bit-equal and every element within one floored
    ulp (ops/precision.bf16_agreement), and the force and q at rtol 1e-6.
    Measured: 99.9968% (per step), 99.9920% (B5), 99.9896% (B8)
    bit-equal, force within 7.0e-7 of its largest value, Q equal.  The
    per-sub-step leg rounds the band block in each of its K B3 calls, as
    JAX's does, so one ulp of f32 round-off after the first sub-step moves
    the next ones, and the IB force takes it up: there at least 99.9% is
    bit-equal, and the run lies less than a quarter as far from JAX's as
    the port's own f32 from the same state does, in f, force and Q
    (measured: 99.9797% bit-equal, 22 of 995,328 elements beyond one
    floored ulp, at most 21; f rel-L2 6.7e-5 against 2.9e-3, force 5.7e-5
    against 1.2e-3, Q equal against 4.0e-5).
(c) Over 8 steps from the common state, on the per-step and the
    per-sub-step leg, the port's bf16 lies nearer JAX's bf16 than the
    port's f32 does, in f, force and Q (measured: f 1.5e-4 and 2.0e-4
    against 3.6e-3, force 3.1e-6 and 7.2e-5 against 1.6e-3, Q equal
    against 2.1e-4 and 3.7e-5).
(d) The quirk IB (ib_x_edge "reference") with bf16 storage: one step on
    (2, 1), the gates of (b) (measured: 99.9968% bit-equal, force within
    1.6e-7).
(e) A bf16 mesh state through the npz checkpoint: f's 2-byte bits and the
    f32 force round-trip, and the run resumes onto a mesh bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops.pallas_step import make_collide_rows_kernel
from cuda_iblb_11_tpu.parallel.sharded import (
    ShardedPallasSim as JaxPerStep, ShardedTemporalSim as JaxTemporal,
    make_mesh as jax_mesh,
)
from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.core.state import state_from_numpy
from cuda_iblb_11_tpu_torch.io import checkpoint as tckpt
from cuda_iblb_11_tpu_torch.ops.collide_rows import (
    collide_slabs, collide_slabs_reference,
)
from cuda_iblb_11_tpu_torch.ops.precision import bf16_agreement
from cuda_iblb_11_tpu_torch.parallel import (
    ShardedPallasSim, ShardedTemporalSim, make_mesh,
)

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

BF16 = dict(dtype="bfloat16", storage="deviatoric")
STEP = dict(c_num=2, c_space=128, ydim=256)
CFG2 = dict(c_num=3, c_space=128, ydim=288)
WIDE = dict(c_num=16, c_space=128, ydim=256)
LEGS = {   # case: (grid, mesh, K, band leg, ib_x_edge)
    "sharded_per_step": (STEP, (2, 2), 1, "sharded_per_step", "periodic"),
    "band_super_whole": (CFG2, (2, 1), 4, "band_super_whole", "periodic"),
    "band_super_xsharded": (WIDE, (2, 2), 4, "band_super_xsharded",
                            "periodic"),
    "per_substep_tiled": (CFG2, (2, 2), 4, "per_substep_tiled", "periodic"),
    "quirk": (STEP, (2, 1), 1, "sharded_per_step", "reference"),
}
START = 40           # JAX jnp bf16 steps to the common state
SHARE, ULPS, RTOL = 0.999, 1.0, 1e-6


def _bits(a):
    """A JAX bf16 array as a port bf16 tensor of the same bits."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _common(items):
    """The common state: JAX jnp bf16 after START steps, as numpy."""
    sim = JaxSim(JaxConfig(**dict(items), **BF16), backend="jnp")
    st = sim.run_chunk(sim.init_state(), START)
    return tuple(np.asarray(x).copy() for x in st)


def _jax_state(arrays):
    from cuda_iblb_11_tpu.core.state import FlowState

    return FlowState(*(jnp.asarray(a) for a in arrays))


@functools.lru_cache(maxsize=None)
def _jax_run(case, steps):
    """JAX's Pallas mesh in bf16 from the common state: (f as port bf16,
    force, q)."""
    kw, mesh, K, leg, ib_x_edge = LEGS[case]
    cfg = JaxConfig(**kw, **BF16)
    m = jax_mesh(*mesh)
    sim = (JaxPerStep(cfg, m, interpret=True, ib_x_edge=ib_x_edge)
           if K == 1 else JaxTemporal(cfg, m, temporal=K, interpret=True,
                                      ib_x_edge=ib_x_edge))
    assert sim._kernel_path == leg
    st = sim.run_chunk(sim.place_state(_jax_state(_common(
        tuple(sorted(kw.items()))))), steps)
    assert st.f.dtype == jnp.bfloat16 and st.force.dtype == jnp.float32
    return _bits(st.f), np.asarray(st.force, np.float64), float(st.q)


def _port_run(case, steps, dtype="bfloat16"):
    """The port's mesh (torch backend) from the common state, f widened
    for f32: the gathered FlowState."""
    kw, mesh, K, leg, ib_x_edge = LEGS[case]
    cfg = SimConfig(**kw, dtype=dtype, storage="deviatoric")
    m = make_mesh(*mesh, devices=["cpu"])
    sim = (ShardedPallasSim(cfg, m, ib_x_edge=ib_x_edge) if K == 1 else
           ShardedTemporalSim(cfg, m, temporal=K, ib_x_edge=ib_x_edge))
    rc = sim.resolved_config()
    assert rc["band_leg"] == leg and rc["dtype"] == dtype
    assert rc["ib_path"] == ("stencil_quirk" if ib_x_edge == "reference"
                             else "band_matmul")
    st = state_from_numpy(*_common(tuple(sorted(kw.items()))))
    if dtype != "bfloat16":
        st = st._replace(f=st.f.float())
    out = sim.gather_state(sim.run_chunk(sim.place_state(st), steps))
    assert out.force.dtype == out.q.dtype == torch.float32
    assert out.f.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
    return out


def _close32(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _dist(a, b):
    """f rel-L2, force rel-L2 and Q relative of a from b."""
    (af, aforce, aq), (bf, bforce, bq) = a, b
    af, bf = af.double(), bf.double()
    return (float(torch.linalg.norm(af - bf) / torch.linalg.norm(bf)),
            float(np.linalg.norm(aforce - bforce) / np.linalg.norm(bforce)),
            abs(aq - bq) / abs(bq))


def _port(st):
    return st.f, st.force.double().numpy(), float(st.q)


# --- (a) B0 in bf16 -------------------------------------------------------

@pytest.mark.parametrize("forcing", ["trt_split", "reference"])
def test_b0_plain_bf16_matches_jax_bf16(forcing):
    kw = dict(c_num=4, c_space=48, ydim=64)
    rng = np.random.default_rng(7)
    xdim = kw["c_num"] * kw["c_space"]
    w = np.asarray(W)[:, None, None]
    f = (w * 0.05 * rng.standard_normal((9, 8, xdim))).astype(np.float32)
    force = (1e-3 * rng.standard_normal((2, 8, xdim))).astype(np.float32)
    kern = make_collide_rows_kernel(JaxConfig(**kw), 8, jnp.bfloat16,
                                    forcing=forcing, storage="deviatoric",
                                    interpret=True)
    want = kern(jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(force))
    assert want.dtype == jnp.float32
    tf = torch.from_numpy(f).to(torch.bfloat16)
    # an edge row and an edge column read in place, as the mesh reads them
    slabs = [(tf, torch.from_numpy(force)),
             (tf[:, 3:4], torch.from_numpy(force[:, 3:4])),
             (tf[:, :, -1:], torch.from_numpy(force[:, :, -1:]))]
    cfg = SimConfig(**kw)
    got = collide_slabs_reference(slabs, cfg, forcing, "deviatoric")
    want = np.asarray(want, np.float64)
    for g, sl in zip(got, (np.s_[:], np.s_[:, 3:4], np.s_[:, :, -1:])):
        _close32(g, want[sl])
    # the wrapper takes the plain version for CPU tensors: no launch
    before = collide_slabs.launches
    again = collide_slabs(slabs, cfg, forcing, "deviatoric")
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert collide_slabs.launches == before


# --- (b) one call of each leg from a common state ------------------------

def _one_call(case):
    K = LEGS[case][2]
    jf, jforce, jq = _jax_run(case, K)
    st = _port_run(case, K)
    share, _, ulps = bf16_agreement(st.f, jf)
    assert share >= SHARE, (share, ulps)
    if LEGS[case][3] != "per_substep_tiled":
        assert ulps <= ULPS, (share, ulps)
        _close32(st.force, jforce[:, :st.force.shape[1]])
        assert abs(float(st.q) - jq) <= RTOL * abs(jq)
        return
    # f rounds in every sub-step: the port lies far nearer JAX's bf16
    # than its own f32 does, in f, force and Q
    port = _dist(_port(st), (jf, jforce, jq))
    f32 = _dist(_port(_port_run(case, K, "float32")), (jf, jforce, jq))
    assert all(p < 0.25 * g for p, g in zip(port, f32)), (port, f32)


@pytest.mark.parametrize("case", [c for c in LEGS if c != "quirk"])
def test_one_call_matches_jax_bf16_mesh(case):
    _one_call(case)


# --- (c) 8 steps ------------------------------------------------------------

@pytest.mark.parametrize("case", ["sharded_per_step", "per_substep_tiled"])
def test_eight_steps_nearer_jax_bf16_than_f32(case):
    jax16 = _jax_run(case, 8)
    port = _dist(_port(_port_run(case, 8)), jax16)
    f32 = _dist(_port(_port_run(case, 8, "float32")), jax16)
    assert all(p < g for p, g in zip(port, f32)), (port, f32)


# --- (d) the quirk with bf16 storage -------------------------------------

def test_quirk_bf16_one_step_matches_jax():
    _one_call("quirk")


# --- (e) the npz checkpoint -------------------------------------------------

def test_bf16_mesh_npz_round_trips_and_resumes(tmp_path):
    kw, mesh, K, _, _ = LEGS["per_substep_tiled"]
    cfg = SimConfig(**kw, **BF16)
    sim = ShardedTemporalSim(cfg, make_mesh(*mesh, devices=["cpu"]),
                             temporal=K)
    st = sim.run_chunk(sim.init_state(), 2 * K + 1)
    path = str(tmp_path / "mesh.npz")
    tckpt.save(path, sim.gather_state(st), cfg)
    with np.load(path) as z:
        assert z["f"].dtype == np.dtype("V2")
        assert z["force"].dtype == np.float32
    back, saved = tckpt.load(path, cfg)
    assert saved.dtype == "bfloat16" and back.it == st.it
    placed = sim.place_state(back)
    for a, b in zip(placed.f + placed.force, st.f + st.force):
        assert a.dtype == b.dtype and torch.equal(a, b)
    a = sim.gather_state(sim.run_chunk(placed, K + 1))
    b = sim.gather_state(sim.run_chunk(st, K + 1))
    assert torch.equal(a.f.view(torch.int16), b.f.view(torch.int16))
    assert torch.equal(a.force, b.force) and float(a.q) == float(b.q)
