"""Lid-driven cavity — validation config 2, the port of
cuda_iblb_11_tpu/models/cavity.py.

All four walls halfway bounce-back; the top lid moves with velocity u_lid
(bounce-back with the wall-momentum term).  Relaxation time from the
Reynolds number: nu = u_lid N / Re, tau = 3 nu + 1/2.  Steady centreline
profiles are held against Ghia, Ghia & Shin (1982).

No kernel of the JAX package takes these walls (a moving lid and walls in
x): it runs the cavity through its jnp oracle, and this port runs the
plain torch step of ops/reference.py on the device it is given, the card
by default.  That is the model's one path, not a fallback from a kernel.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.lattice import RHO_0, W
from cuda_iblb_11_tpu_torch.models.mucociliary import resolve_device
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.precision import full_f32


class LidDrivenCavity:
    def __init__(self, n=64, re=100.0, u_lid=0.1, dtype=torch.float64,
                 device="cuda"):
        self.n = n
        self.re = re
        self.u_lid = u_lid
        nu = u_lid * n / re
        self.tau = 3.0 * nu + 0.5
        self.tau2 = 1.0 / (12.0 * (self.tau - 0.5)) + 0.5
        self.dtype = dtype
        self.device = resolve_device(device)
        self.walls = ref.WallSpec(
            bottom="noslip", top="moving", left="noslip", right="noslip",
            u_wall=(u_lid, 0.0),
        )
        self.force = torch.zeros((2, n, n), dtype=dtype, device=self.device)

    def init_f(self):
        w = torch.tensor(W, dtype=self.dtype, device=self.device)
        return (RHO_0 * w)[:, None, None].expand(9, self.n, self.n).clone()

    @full_f32()   # one pin for the run, not one per step
    def run(self, f, n_steps):
        for _ in range(n_steps):
            f, _, _ = ref.lb_substep(f, self.force, self.tau, self.tau2,
                                     self.walls)
        return f

    def centreline_profiles(self, f):
        """(u_x along the vertical centreline / u_lid,
            u_y along the horizontal centreline / u_lid)."""
        _, u = ref.moments(f)
        ux = u[0, :, self.n // 2] / self.u_lid
        uy = u[1, self.n // 2, :] / self.u_lid
        return ux, uy
