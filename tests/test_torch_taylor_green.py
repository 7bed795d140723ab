"""Taylor-Green vortex decay on the port's plain step — the counterpart of
tests/test_taylor_green.py, on cuda_iblb_11_tpu_torch/ops/reference.py.

The 2-D Taylor-Green vortex on a fully periodic box keeps its shape while
its kinetic energy decays as exp(-4 nu k^2 t), with nu = c_s^2 (tau - 1/2)
for the TRT collide (CS_KERNEL = 0.57735, the kernels' sound speed).  The
port's lb_substep on fully periodic walls, tau 0.8 and 1.2, decays within
2% of that rate and keeps its shape (correlation > 0.9999), as the JAX
test gates; and 50 f64 steps equal the JAX oracle's to 1e-12.  No kernel
takes fully periodic walls, so this runs on the CPU only."""

import numpy as np
import pytest
import torch

from cuda_iblb_11_tpu.ops import reference as jax_ref
from cuda_iblb_11_tpu_torch.core.lattice import CS_KERNEL
from cuda_iblb_11_tpu_torch.ops import reference as ref

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

N = 64
U0 = 0.01    # Ma ~ 0.017: compressibility error ~ Ma^2 ~ 3e-4
K = 2.0 * np.pi / N


def _vortex():
    y, x = np.meshgrid(np.arange(N, dtype=np.float64),
                       np.arange(N, dtype=np.float64), indexing="ij")
    return np.stack([-U0 * np.cos(K * x) * np.sin(K * y),
                     U0 * np.sin(K * x) * np.cos(K * y)])


def _tau2(tau):
    # TRT odd relaxation at the reference's Lambda = 1/12 (main.cu:321)
    return 1.0 / (12.0 * (tau - 0.5)) + 0.5


def _run(f, steps, tau):
    walls = ref.WallSpec(bottom="periodic", top="periodic")
    force = torch.zeros((2, N, N), dtype=f.dtype)
    for _ in range(steps):
        f, _, _ = ref.lb_substep(f, force, tau, _tau2(tau), walls,
                                 forcing="trt_split")
    return f


def _energy(f):
    _, u = ref.moments(f)
    return float((u[0] ** 2 + u[1] ** 2).sum())


@pytest.mark.parametrize("tau", [0.8, 1.2])
def test_taylor_green_decay_rate(tau):
    u = _vortex()
    f = ref.equilibrium(torch.ones((N, N), dtype=torch.float64),
                        torch.from_numpy(u), storage="raw")
    # past the kinetic start-up transient, then a window short of a decade
    f = _run(f, 50, tau)
    e0 = _energy(f)
    steps = 200
    f = _run(f, steps, tau)
    rate = -np.log(_energy(f) / e0) / steps
    rate_exact = 4.0 * CS_KERNEL ** 2 * (tau - 0.5) * K ** 2
    assert abs(rate / rate_exact - 1.0) < 0.02, (rate, rate_exact)
    _, uu = ref.moments(f)
    a, b = uu.numpy().ravel(), u.ravel()
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert corr > 0.9999, corr


@pytest.mark.parametrize("tau", [0.8, 1.2])
def test_taylor_green_matches_jax_50_f64_steps(tau):
    import jax.numpy as jnp

    u = _vortex()
    f = ref.equilibrium(torch.ones((N, N), dtype=torch.float64),
                        torch.from_numpy(u), storage="raw")
    jf = jax_ref.equilibrium(jnp.ones((N, N), jnp.float64), jnp.asarray(u),
                             storage="raw")
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-14)
    walls = jax_ref.WallSpec(bottom="periodic", top="periodic")
    force = jnp.zeros((2, N, N), jnp.float64)
    for _ in range(50):
        jf, _, _ = jax_ref.lb_substep(jf, force, tau, _tau2(tau), walls,
                                      forcing="trt_split")
    got = _run(f, 50, tau).numpy()
    want = np.asarray(jf)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)
