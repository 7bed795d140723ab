"""Body-force-driven channel (Poiseuille) — validation config 1, the port
of cuda_iblb_11_tpu/models/channel.py.

Pure D2Q9 TRT with a constant body force over the whole height and no
immersed boundary: bottom and top no-slip, x periodic, so each step is
collide + stream without emission with the force band the whole grid
(band = ydim): B2h (ops/collide_stream) on a CUDA device, its plain
version on the CPU.  The steady x-velocity profile is parabolic; with
halfway bounce-back the walls sit half a cell outside the first and last
fluid rows.  The JAX module's docstring derives the forcing amplification
g_eff = g (1 + (omega- - omega+)/2) of the reference's uniform Guo
prefactor, which ``forcing_amplification`` returns and the analytic
profile folds in.

As the JAX model: forcing "reference" (its lb_substep default); by default
raw storage and f64.  ``storage="deviatoric"`` keeps f - w instead, which an
f32 run needs: in raw f32 the body-force increment (~3e-7 on f ~ 0.1) is
rounded to about 1% of itself at every step.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.core.lattice import RHO_0, W
from cuda_iblb_11_tpu_torch.models.mucociliary import resolve_device
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.collide_stream import collide_stream

FORCING = "reference"    # the JAX model's lb_substep default


class PoiseuilleChannel:
    def __init__(self, xdim=32, ydim=32, tau=1.0, body_force=1e-6,
                 dtype=torch.float64, device="cuda", storage="raw"):
        self.xdim, self.ydim = xdim, ydim
        self.tau = tau
        self.tau2 = 1.0 / (12.0 * (tau - 0.5)) + 0.5  # TRT magic 1/12
        self.dtype = dtype
        self.device = resolve_device(device)
        self.storage = storage
        self.walls = ref.WallSpec(bottom="noslip", top="noslip")
        self.force = torch.zeros((2, ydim, xdim), dtype=dtype,
                                 device=self.device)
        self.force[0] = body_force
        self.g = body_force

    def init_f(self):
        w = torch.tensor(W, dtype=self.dtype, device=self.device)
        f = RHO_0 * w - (w if self.storage == "deviatoric" else 0.0)
        return f[:, None, None].expand(9, self.ydim, self.xdim).contiguous()

    def run(self, f, n_steps):
        """n_steps steps from f (left unchanged), in two buffers."""
        bufs = [torch.empty_like(f) for _ in range(min(n_steps, 2))]
        for k in range(n_steps):
            f = collide_stream(f, self.force, self.tau, self.tau2,
                               self.walls, FORCING, self.storage,
                               out=bufs[k % 2])
        return f

    def profile(self, f):
        """Mean corrected u_x per row."""
        _, u = ref.corrected_velocity(f, self.force, self.storage)
        return u[0].mean(1)

    def forcing_amplification(self):
        """g_eff/g for the reference's uniform-prefactor Guo-TRT forcing
        (see the module docstring)."""
        omega_p = 1.0 / self.tau
        omega_m = 1.0 / self.tau2
        return 1.0 + (omega_m - omega_p) / 2.0

    def analytic_profile(self):
        y = np.arange(self.ydim, dtype=np.float64)
        nu = (1.0 / 3.0) * (self.tau - 0.5)
        y_c = (self.ydim - 1) / 2.0
        half = self.ydim / 2.0
        g_eff = self.g * self.forcing_amplification()
        return g_eff / (2.0 * nu) * (half**2 - (y - y_c) ** 2)
