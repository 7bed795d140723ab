"""The cilia's beat, placement and overlap mask (upstream main.cu:77-252:
define_filament and boundary_check), in float64 for a batch of steps.

A cilium's nodes sit at arc lengths round(j 9600 / 111) / 9600; node j at
phase theta lies at 111 sum_n (a_n(s) cos(n theta) + b_n(s) sin(n theta))
with a_n(s) = sum_p A[p, n] s^(p+1), the n = 0 term halved.  Cilium m runs
m p_step steps ahead; a phase of exactly T stays T (main.cu:102-103).  The
velocity is the backward difference of two steps (zero at step 0).
"""

from __future__ import annotations

import numpy as np
import torch

PI_REF = 3.14159       # the truncated pi of the beat kernel (main.cu:29)
BEAT_SCALE = 111.0
FINE_SAMPLES = 9600

# "WITHOUT MUCUS" Fourier coefficients (main.cu:56-74), [power, coord, n]
A_MN = np.array([
    -0.654, 0.393, -0.097, 0.079, 0.119, 0.119, 0.009,
    1.895, -0.018, 0.158, 0.010, 0.003, 0.013, 0.040,
    0.787, -1.516, 0.032, -0.302, -0.252, -0.015, 0.035,
    -0.552, -0.126, -0.341, 0.035, 0.006, -0.029, -0.068,
    0.202, 0.716, -0.118, 0.142, 0.110, -0.013, -0.043,
    0.096, 0.263, 0.186, -0.067, -0.032, -0.002, 0.015,
]).reshape(3, 2, 7)
B_MN = np.array([
    0.0, 0.284, 0.006, -0.059, 0.018, 0.053, 0.009,
    0.0, 0.192, -0.050, 0.012, -0.007, -0.014, -0.017,
    0.0, 1.045, 0.317, 0.226, 0.004, -0.082, -0.040,
    0.0, -0.499, 0.423, 0.138, 0.125, 0.075, 0.067,
    0.0, -1.017, -0.276, -0.196, -0.037, 0.025, 0.023,
    0.0, 0.339, -0.327, -0.114, -0.105, -0.057, -0.055,
]).reshape(3, 2, 7)


class Beat:
    """The beat of every cilium of a configuration (reference.params)."""

    def __init__(self, p, device):
        self.p = p
        self.device = torch.device(device)
        arcl = np.rint(np.arange(p.length) * FINE_SAMPLES / BEAT_SCALE) \
            / FINE_SAMPLES
        powers = arcl[:, None] ** np.array([1.0, 2.0, 3.0])[None, :]
        n = np.arange(7)
        half = np.where(n == 0, 0.5, 1.0)
        # [node, n, coord]
        self.a = self._t(np.einsum("jp,pcn->jnc", powers, A_MN)
                         * half[None, :, None])
        self.b = self._t(np.einsum("jp,pcn->jnc", powers, B_MN)
                         * half[None, :, None])
        self.n = self._t(n)
        m = np.arange(p.c_num)
        self.base_x = self._t((m - (p.c_num - 1) / 2.0) * p.c_space)

    def _t(self, a):
        return torch.tensor(a, dtype=torch.float64, device=self.device)

    def _phases(self, its):
        its = torch.as_tensor(its, dtype=torch.int64, device=self.device)
        m = torch.arange(self.p.c_num, dtype=torch.int64, device=self.device)
        total = its[:, None] + m[None, :] * self.p.p_step        # [n, c]
        T = self.p.T
        return torch.where(total == T, total, total % T)

    def _series(self, cos_n, sin_n):
        # cos_n, sin_n [n, c, 7] -> [n, c, node, 2]
        return BEAT_SCALE * (torch.einsum("jnk,tcn->tcjk", self.a, cos_n)
                             + torch.einsum("jnk,tcn->tcjk", self.b, sin_n))

    def positions(self, its):
        """Beat-frame node positions [n, c, node, 2] (x with the base
        offset of each cilium)."""
        k = 2.0 * PI_REF / self.p.T
        ang = self.n * (k * self._phases(its).to(torch.float64))[..., None]
        pos = self._series(torch.cos(ang), torch.sin(ang))
        pos[..., 0] += self.base_x[None, :, None]
        return pos

    def velocities(self, its):
        """pos(it) - pos(it - 1) [n, c, node, 2], zero at it = 0; the
        differences of cos and sin in product form, so a velocity of 1e-3
        is not the difference of two positions of 100."""
        its = torch.as_tensor(its, dtype=torch.int64, device=self.device)
        k = 2.0 * PI_REF / self.p.T
        ph_t = self._phases(its).to(torch.float64)
        ph_p = self._phases(its - 1).to(torch.float64)
        hs = (0.5 * k * (ph_t + ph_p))[..., None] * self.n
        hd = (0.5 * k * (ph_t - ph_p))[..., None] * self.n
        vel = self._series(-2.0 * torch.sin(hs) * torch.sin(hd),
                           2.0 * torch.cos(hs) * torch.sin(hd))
        return torch.where((its > 0)[:, None, None, None], vel,
                           torch.zeros_like(vel))

    def placed(self, its, mask_dtype):
        """(s [n, Ns, 2], u_s [n, Ns, 2], eps [n, Ns]) of boundary_check:
        x shifted by half the domain and wrapped once into [0, X], y
        raised by one; eps 0 for a node closer than one lattice unit on
        both axes to a node of any of the r_max - 1 cilia before it.  s
        and u_s are float64; the overlap test compares positions rounded
        to ``mask_dtype``, the precision the configuration places its
        points in."""
        p = self.p
        pos = self.positions(its)
        vel = self.velocities(its)
        n = pos.shape[0]
        xdim = float(p.xdim)

        def place(d):
            x = p.xdim / 2.0 + pos[..., 0].to(d)
            x = torch.where(x < 0, x + xdim, torch.where(x > xdim,
                                                         x - xdim, x))
            return x, pos[..., 1].to(d) + 1.0

        x, y = place(torch.float64)
        xm, ym = place(mask_dtype)
        eps = torch.ones(xm.shape, dtype=torch.float64, device=self.device)
        for r in range(1, 2 * p.length // p.c_space):
            xo = torch.roll(xm, r, dims=1)
            yo = torch.roll(ym, r, dims=1)
            close = (((xo[:, :, None, :] - xm[:, :, :, None]).abs() < 1.0)
                     & ((yo[:, :, None, :] - ym[:, :, :, None]).abs() < 1.0))
            eps = torch.where(close.any(-1), torch.zeros_like(eps), eps)
        s = torch.stack([x, y], dim=-1).reshape(n, p.points, 2)
        return s, vel.reshape(n, p.points, 2), eps.reshape(n, p.points)
