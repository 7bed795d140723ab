"""The validation models of the port (models/channel.py, models/cavity.py)
against the JAX ones on the CPU: 200 steps in f64, f at rtol 1e-12 and the
derived profiles at rtol 1e-12 with an absolute floor of 1e-12 of the
largest |f| (a velocity is a difference of O(0.1) populations, so its
round-off is absolute, not relative to the small velocity); then the
Poiseuille channel against its analytic profile (3e-3, the gate of
tests/test_poiseuille.py).  The cavity's Ghia check runs on the card
(tests/test_torch_cuda.py::test_cavity_on_the_card_against_ghia).
"""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.models.cavity import LidDrivenCavity as JaxCavity
from cuda_iblb_11_tpu.models.channel import PoiseuilleChannel as JaxChannel
from cuda_iblb_11_tpu_torch.models.cavity import LidDrivenCavity
from cuda_iblb_11_tpu_torch.models.channel import PoiseuilleChannel
from cuda_iblb_11_tpu_torch.ops.collide_stream import collide_stream

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

STEPS = 200


def _close(got, want, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = 0.0 if scale is None else 1e-12 * scale
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("xdim,ydim,tau", [(16, 32, 0.8), (8, 24, 1.5)])
def test_channel_matches_jax(xdim, ydim, tau):
    jc = JaxChannel(xdim=xdim, ydim=ydim, tau=tau)
    pc = PoiseuilleChannel(xdim, ydim, tau=tau, device="cpu")
    jf = jc.run(jc.init_f(), STEPS)
    before = collide_stream.launches
    pf = pc.run(pc.init_f(), STEPS)
    assert collide_stream.launches == before    # the plain version here
    _close(pf, jf)
    scale = float(np.abs(np.asarray(jf)).max())
    _close(pc.profile(pf), jc.profile(jf), scale)
    assert pc.forcing_amplification() == jc.forcing_amplification()
    np.testing.assert_array_equal(pc.analytic_profile(),
                                  jc.analytic_profile())


def test_channel_meets_the_analytic_profile():
    ch = PoiseuilleChannel(xdim=16, ydim=32, tau=1.0, body_force=1e-6,
                           device="cpu")
    got = ch.profile(ch.run(ch.init_f(), 8000)).numpy()
    want = ch.analytic_profile()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-3
    np.testing.assert_allclose(got, got[::-1], rtol=1e-8)


def test_channel_deviatoric_storage_is_the_raw_run():
    raw = PoiseuilleChannel(16, 32, tau=0.8, device="cpu")
    dev = PoiseuilleChannel(16, 32, tau=0.8, device="cpu",
                            storage="deviatoric")
    fr = raw.run(raw.init_f(), STEPS)
    fd = dev.run(dev.init_f(), STEPS)
    _close(fd + raw.init_f()[:, :1, :1], fr, 1.0)
    _close(dev.profile(fd), raw.profile(fr), 1.0)


def test_cavity_matches_jax():
    jv = JaxCavity(n=32, re=100.0, u_lid=0.1)
    pv = LidDrivenCavity(n=32, re=100.0, u_lid=0.1, device="cpu")
    assert (pv.tau, pv.tau2) == (jv.tau, jv.tau2)
    jf = jv.run(jv.init_f(), STEPS)
    pf = pv.run(pv.init_f(), STEPS)
    _close(pf, jf)
    scale = float(np.abs(np.asarray(jf)).max()) / pv.u_lid
    for g, w in zip(pv.centreline_profiles(pf), jv.centreline_profiles(jf)):
        _close(g, w, scale)


def test_models_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        PoiseuilleChannel()
    with pytest.raises(RuntimeError, match="cuda"):
        LidDrivenCavity()
