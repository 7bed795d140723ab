"""The frozen plain reference against the program's plain versions
(``backend="torch"``) at a tiny grid in float64: the beat, the placement
and overlap mask, and whole steps of the model from rest and from a
developed flow."""

import pytest
import torch

from iblb_benchmark import check, harness
from iblb_benchmark.reference.kinematics import Beat
from iblb_benchmark.reference.lbm import Reference, velocity
from iblb_benchmark.reference.params import Params

TINY = dict(c_fraction=1, c_num=4, c_space=16, re=1.0, t_num=1.0, t_pow=3,
            i_pow=1.0, p_num=25, length=16, ydim=64, flux_column_offset=5)


def _program(dtype="float64", **kw):
    from cuda_iblb_11_tpu_torch.core.config import SimConfig
    from cuda_iblb_11_tpu_torch.models.mucociliary import MucociliarySim

    cfg = SimConfig(**{**TINY, **kw}, dtype=dtype)
    return MucociliarySim(cfg, backend="torch", device="cpu", temporal=1)


@pytest.mark.parametrize("c_fraction,c_space", [(1, 16), (2, 16), (1, 24)])
def test_beat_and_placement(c_fraction, c_space):
    sim = _program(c_fraction=c_fraction, c_space=c_space)
    p = Params(**{**TINY, "c_fraction": c_fraction, "c_space": c_space})
    beat = Beat(p, "cpu")
    its = torch.tensor([0, 1, 37, 999, 1000, 1001, 2500])
    pos, vel = sim.cilia.kinematics(its)
    assert torch.allclose(beat.positions(its), pos, rtol=0, atol=1e-11)
    assert torch.allclose(beat.velocities(its), vel, rtol=0, atol=1e-13)
    s, u_s, eps = sim.cilia.place_and_mask(pos, vel)
    s_r, u_r, eps_r = beat.placed(its, torch.float64)
    assert torch.allclose(s_r, s, rtol=0, atol=1e-11)
    assert torch.allclose(u_r, u_s, rtol=0, atol=1e-13)
    assert torch.equal(eps_r, eps.to(torch.float64))


# the upstream CUDA_IBLB_11 channel (main.cu defaults, CLI 1 6 48 1.0 1.0 5
# 1 100): 288 x 192, 6 cilia of 96 nodes 48 apart, whose tips overlap
CHANNEL = {"c_fraction": 1, "c_num": 6, "c_space": 48, "re": 1.0,
           "t_num": 1.0, "t_pow": 5, "i_pow": 1.0, "p_num": 100,
           "length": 96, "ydim": 192, "flux_column_offset": 5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_overlap_mask_over_the_channel_beat(dtype):
    """The channel's cilia overlap in the recovery stroke; the mask,
    tested in the points' precision, is the program's on every sampled
    step of the beat."""
    from cuda_iblb_11_tpu_torch.core.config import SimConfig
    from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel

    sim = CHANNEL
    p = Params.from_sim(sim)
    its = torch.arange(0, p.T, 97)
    cilia = CiliaModel(SimConfig(**{k: sim[k] for k in harness.SIM_FIELDS}),
                       dtype=dtype)
    _, _, eps = cilia.place_and_mask(*cilia.kinematics(its))
    _, _, eps_r = Beat(p, "cpu").placed(its, dtype)
    assert torch.equal(eps_r, eps.to(torch.float64))
    assert (eps_r == 0).sum() > 1000


@pytest.mark.parametrize("it0", [0, 40, 960])
def test_steps_match_the_program_in_float64(it0):
    sim = _program()
    p = Params(**TINY)
    st = harness.start_state(sim, p, it0)
    ref = Reference(p, "cpu")
    # from rest, then from the flow the first leg left
    for n in (40, 25):
        before = st
        st = sim.run_chunk(st, n)
        f, force, samples = ref.run(check.raw64(before.f, sim.storage),
                                    check.full_force(before.force, p.ydim),
                                    before.it, n)
        u_prog = velocity(check.raw64(st.f, sim.storage),
                          check.full_force(st.force, p.ydim))
        u_ref = velocity(f, force)
        rel = float((u_prog - u_ref).norm() / u_ref.norm())
        assert rel < 1e-12, rel
        dq = float(st.q) - float(before.q)
        assert abs(dq - float(samples.sum())) \
            <= 1e-12 * float(samples.abs().sum())
        assert torch.allclose(check.full_force(st.force, p.ydim), force,
                              rtol=0, atol=1e-14)


def test_interval_numbers_of_a_float32_run():
    """The program in float32 (deviatoric storage) reads about 1e-6 against
    the float64 reference; the same state read as raw reads far more."""
    sim = _program("float32")
    p = Params(**TINY)
    s0 = harness.start_state(sim, p, 80)
    s1 = sim.run_chunk(s0, 40)
    ref = Reference(p, "cpu", mask_dtype=torch.float32)
    good = check.interval_numbers(ref, s0, s1, "deviatoric")
    assert good["u_rel"] < 1e-5 and good["q_rel"] < 1e-5
    bad = check.interval_numbers(ref, s0, s1._replace(it=s1.it + 1),
                                 "deviatoric")
    assert bad["u_rel"] > 10 * good["u_rel"]
