"""The drift of the temporal path from single-step in f32, in both packages
on the CPU, at 384 x 192 with 8 cilia (where K = 16 takes the whole band
super-step, as the accuracy_horizon ``mid`` leg does).

On the card the port's 2048^2 auto run (B5 + B4) stays 1.4-1.5e-7 from
single-step (B2) out to 32,768 steps; the JAX package measured 2.1-3.6e-6
on a TPU between its Pallas paths (scripts/accuracy_horizon.py, leg
``tpu``).  This holds the two packages' CPU drifts to one class after 64
steps (4 super-steps), velocity rel-L2: JAX's band super-step (Pallas in
interpret mode) against JAX's jnp single step, and against its Pallas
single step, as the TPU leg paired them; the port's torch backend at
temporal 16 against temporal 1.  Each below 1e-5, and within a factor of
10 of the port's.

    python tests/test_torch_temporal_drift.py [STEPS ...]

prints every pair, and each run against the f64 jnp run, at each horizon
(default 64 128 256 512).
"""

import sys

import jax
import numpy as np

from cuda_iblb_11_tpu.core.config import SimConfig as JaxConfig
from cuda_iblb_11_tpu.models.mucociliary import MucociliarySim as JaxSim
from cuda_iblb_11_tpu.ops import ib_band as jax_ib_band
from cuda_iblb_11_tpu.ops import reference as jax_ref
from cuda_iblb_11_tpu_torch import MucociliarySim, SimConfig
from cuda_iblb_11_tpu_torch.accuracy_horizon import velocity

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

KW = dict(c_num=8, c_space=48)            # 384 x 192
STEPS = 64
PAIRS = (("jax_pallas16", "jax_jnp1"), ("jax_pallas16", "jax_pallas1"),
         ("jax_pallas1", "jax_jnp1"), ("port16", "port1"),
         ("port1", "jax_jnp1"))


def _sims(f64=False):
    cfg = dict(KW, dtype="float32")
    sims = {"jax_jnp1": JaxSim(JaxConfig(**cfg), backend="jnp"),
            "jax_pallas1": JaxSim(JaxConfig(**cfg), backend="pallas"),
            "jax_pallas16": JaxSim(JaxConfig(**cfg), backend="pallas",
                                   temporal=16),
            "port1": MucociliarySim(SimConfig(**cfg), backend="torch",
                                    device="cpu"),
            "port16": MucociliarySim(SimConfig(**cfg), backend="torch",
                                     device="cpu", temporal=16)}
    if f64:
        sims["f64"] = JaxSim(JaxConfig(**dict(KW, dtype="float64",
                                              storage="raw")), backend="jnp")
    return sims


def _velocity(name, sim, st):
    if name.startswith("port"):
        return velocity(sim, st).numpy()
    force = jax_ib_band.pad_band(st.force, sim.cfg.ydim)
    _, u = jax_ref.corrected_velocity(st.f.astype(np.float64),
                                      force.astype(np.float64), sim.storage)
    return np.asarray(u)


def drifts(horizons=(STEPS,), f64=False):
    """{horizon: {pair: velocity rel-L2}} of PAIRS (and each run against
    the f64 run with ``f64``), the runs in lockstep."""
    sims = _sims(f64)
    assert sims["jax_pallas16"].resolved_config()["band_leg"] \
        == sims["port16"].resolved_config()["band_leg"] == "band_super_whole"
    states = {k: s.init_state() for k, s in sims.items()}
    out, it = {}, 0
    for n in horizons:
        u = {}
        for k, s in sims.items():
            states[k] = s.run_chunk(states[k], n - it)
            u[k] = _velocity(k, s, states[k])
        it = n
        pairs = PAIRS + tuple((k, "f64") for k in sims if f64 and k != "f64")
        out[n] = {f"{a}_vs_{b}": float(np.linalg.norm(u[a] - u[b])
                                       / np.linalg.norm(u[b]))
                  for a, b in pairs}
    return out


def test_temporal_drift_is_of_one_class_in_both_packages():
    d = drifts()[STEPS]
    print(d)
    port = d["port16_vs_port1"]
    for pair in ("jax_pallas16_vs_jax_jnp1", "jax_pallas16_vs_jax_pallas1"):
        assert d[pair] < 1e-5 and port < 1e-5, (pair, d)
        assert max(d[pair], port) < 10 * min(d[pair], port), (pair, d)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    hs = tuple(int(a) for a in sys.argv[1:]) or (64, 128, 256, 512)
    for n, row in drifts(hs, f64=True).items():
        print(n, {k: f"{v:.3e}" for k, v in row.items()}, flush=True)
