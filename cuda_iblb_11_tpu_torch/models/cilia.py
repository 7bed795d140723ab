"""Cilium beat kinematics, placement and overlap masking — the port of
cuda_iblb_11_tpu/models/cilia.py (reference define_filament and
boundary_check, main.cu:77-252).

Every function takes a batch of steps: ``it`` is an int or an integer
tensor of any shape [...], and results carry [..., c_num, nodes, ...].
The kinematics run in torch.float64: the Fourier sums are scaled by 111, so
f32 summation noise alone is ~1e-4 lattice units on the node positions
(cilia.py:117-124); the f32 fluid receives them as (integer anchor,
sub-cell fraction) pairs that lose nothing in the cast.

The beat tables are copied from the JAX module, which imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import PI_REF

BEAT_SCALE = 111.0
FINE_SAMPLES = 9600
N_HARMONICS = 7

# Fourier coefficients, flat index n + 14*p + 7*coord -> [power, coord, n].
# "WITHOUT MUCUS" set (main.cu:56-74).
A_MN_NO_MUCUS = np.array([
    -0.654,  0.393, -0.097,  0.079,  0.119,  0.119,  0.009,
     1.895, -0.018,  0.158,  0.010,  0.003,  0.013,  0.040,
     0.787, -1.516,  0.032, -0.302, -0.252, -0.015,  0.035,
    -0.552, -0.126, -0.341,  0.035,  0.006, -0.029, -0.068,
     0.202,  0.716, -0.118,  0.142,  0.110, -0.013, -0.043,
     0.096,  0.263,  0.186, -0.067, -0.032, -0.002,  0.015,
]).reshape(3, 2, 7)

B_MN_NO_MUCUS = np.array([
    0.0,  0.284,  0.006, -0.059,  0.018,  0.053,  0.009,
    0.0,  0.192, -0.050,  0.012, -0.007, -0.014, -0.017,
    0.0,  1.045,  0.317,  0.226,  0.004, -0.082, -0.040,
    0.0, -0.499,  0.423,  0.138,  0.125,  0.075,  0.067,
    0.0, -1.017, -0.276, -0.196, -0.037,  0.025,  0.023,
    0.0,  0.339, -0.327, -0.114, -0.105, -0.057, -0.055,
]).reshape(3, 2, 7)

# "WITH MUCUS PRESENT" set (commented out in the reference, main.cu:36-54).
A_MN_MUCUS = np.array([
    -0.449,  0.130, -0.169,  0.063, -0.050, -0.040, -0.068,
     2.076, -0.003,  0.054,  0.007,  0.026,  0.022,  0.010,
    -0.072, -1.502,  0.260, -0.123,  0.011, -0.009,  0.196,
    -1.074, -0.230, -0.305, -0.180, -0.069,  0.001, -0.080,
     0.658,  0.793, -0.251,  0.049,  0.009,  0.023, -0.111,
     0.381,  0.331,  0.193,  0.082,  0.029,  0.002,  0.048,
]).reshape(3, 2, 7)

B_MN_MUCUS = np.array([
    0.0, -0.030, -0.093,  0.037,  0.062,  0.016, -0.065,
    0.0,  0.080, -0.044, -0.017,  0.052,  0.007,  0.051,
    0.0,  1.285, -0.036, -0.244, -0.093, -0.137,  0.095,
    0.0, -0.298,  0.513,  0.004, -0.222,  0.035, -0.128,
    0.0, -1.034,  0.050,  0.143,  0.043,  0.098, -0.054,
    0.0,  0.210, -0.367,  0.009,  0.120, -0.024,  0.102,
]).reshape(3, 2, 7)

PATTERNS = {
    "no_mucus": (A_MN_NO_MUCUS, B_MN_NO_MUCUS),
    "mucus": (A_MN_MUCUS, B_MN_MUCUS),
}


def node_arclengths(length: int) -> np.ndarray:
    """arcl_j = round(j * 9600 / 111) / 9600: the fine sample the
    reference's selection loop keeps for node j (main.cu:158-172)."""
    k = np.rint(np.arange(length) * FINE_SAMPLES / BEAT_SCALE)
    return k / FINE_SAMPLES


def _beat_tables(length: int, pattern: str):
    """(a_pre, b_pre) [nodes, 7, 2] in f64: a_pre[j, n, coord] =
    sum_p A[p, coord, n] * arcl_j^(p+1)."""
    a_mn, b_mn = PATTERNS[pattern]
    arcl = node_arclengths(length)
    powers = arcl[:, None] ** np.array([1.0, 2.0, 3.0])[None, :]
    return (np.einsum("jp,pcn->jnc", powers, a_mn),
            np.einsum("jp,pcn->jnc", powers, b_mn))


def beat_x_bound(length: int, pattern: str = "no_mucus") -> float:
    """Rigorous upper bound on |beat-frame x| over all phases, maximized
    over nodes: |x(arcl, phi)| = 111 |a0/2 + sum a_n cos + b_n sin| <=
    111 (|a0|/2 + sum_n sqrt(a_n^2 + b_n^2)), by Cauchy-Schwarz on each
    harmonic (cuda_iblb_11_tpu/models/cilia.py:271-282).  It proves each
    cilium's delta support inside its window of the band super-step
    (ops/temporal.band_super_geometry)."""
    a_pre, b_pre = _beat_tables(length, pattern)
    a, b = a_pre[:, :, 0], b_pre[:, :, 0]
    per_node = np.abs(a[:, 0]) / 2.0 + np.sqrt(
        a[:, 1:] ** 2 + b[:, 1:] ** 2).sum(axis=1)
    return float(BEAT_SCALE * per_node.max())


class CiliaModel:
    """Batched beat kinematics for all cilia on one device."""

    def __init__(self, cfg: SimConfig, dtype=torch.float32,
                 pattern: str = "no_mucus", device="cpu"):
        self.cfg = cfg
        self.dtype = dtype          # placement / IB dtype (>= f32)
        self.hp = torch.float64     # kinematics dtype
        self.device = torch.device(device)

        def t(a):
            return torch.tensor(a, dtype=self.hp, device=self.device)

        a_pre, b_pre = _beat_tables(cfg.length, pattern)
        self.a_pre = t(a_pre)
        self.b_pre = t(b_pre)
        m = np.arange(cfg.c_num)
        self.offsets = t((m - (cfg.c_num - 1) / 2.0) * cfg.c_space)
        self.shift_x = (cfg.c_space * cfg.c_num) / 2.0
        self.harmonics = t(np.arange(N_HARMONICS))
        # n=0 term is a_0/2: halve the n=0 column (b_0 = 0 in all patterns)
        self.scale = t([0.5] + [1.0] * (N_HARMONICS - 1))
        self.r_max = 2 * cfg.length // cfg.c_space

    def _phase(self, total):
        # reference quirk (main.cu:102-103): phase stays T (not 0) when the
        # total equals T exactly
        T = self.cfg.T
        return torch.where(total == T, torch.full_like(total, T), total % T)

    def _totals(self, it):
        it = torch.as_tensor(it, dtype=torch.int64, device=self.device)
        m = torch.arange(self.cfg.c_num, dtype=torch.int64, device=self.device)
        return it[..., None] + m * self.cfg.p_step           # [..., c_num]

    def _series(self, cos_coef, sin_coef):
        """111 * sum_n (a_n cos_coef_n + b_n sin_coef_n) per node and coord."""
        return BEAT_SCALE * (
            torch.einsum("jnc,...mn->...mjc", self.a_pre, cos_coef)
            + torch.einsum("jnc,...mn->...mjc", self.b_pre, sin_coef))

    def positions(self, it):
        """Node positions in the beat frame (x includes the base offset),
        [..., c_num, nodes, 2] in float64."""
        phase = self._phase(self._totals(it))
        theta = (2.0 * PI_REF / self.cfg.T) * phase.to(self.hp)
        ang = self.harmonics * theta[..., None]               # [..., c, 7]
        pos = self._series(torch.cos(ang) * self.scale,
                           torch.sin(ang) * self.scale)
        pos[..., 0] += self.offsets[:, None]
        return pos

    def velocities(self, it):
        """Backward difference pos(it) - pos(it-1) in trig-identity form
            cos(n th_t) - cos(n th_p) = -2 sin(n (th_t+th_p)/2) sin(n dth/2)
        so the ~1e-3 velocity is not the difference of two O(100) positions."""
        tot_t = self._totals(it)
        phase_t = self._phase(tot_t)
        phase_p = self._phase(tot_t - 1)
        k = 2.0 * PI_REF / self.cfg.T
        half_sum = 0.5 * k * (phase_t + phase_p).to(self.hp)
        half_dif = 0.5 * k * (phase_t - phase_p).to(self.hp)
        n = self.harmonics
        s_dif = torch.sin(n * half_dif[..., None])
        dcos = -2.0 * torch.sin(n * half_sum[..., None]) * s_dif
        dsin = 2.0 * torch.cos(n * half_sum[..., None]) * s_dif
        return self._series(dcos, dsin)

    def kinematics(self, it):
        """(pos, vel) with vel zero at it == 0 (main.cu:147-151)."""
        pos = self.positions(it)
        it = torch.as_tensor(it, device=self.device)
        vel = torch.where((it > 0)[..., None, None, None],
                          self.velocities(it), torch.zeros_like(pos))
        return pos, vel

    def place_and_mask(self, pos, vel):
        """boundary_check (main.cu:176-252): placement in the domain, the
        velocity, and the overlap mask.  Returns (s [..., Ns, 2],
        u_s [..., Ns, 2], eps [..., Ns] int32), s and u_s in self.dtype."""
        cfg = self.cfg
        pos = pos.to(self.dtype)
        vel = vel.to(self.dtype)
        xdim = float(cfg.xdim)
        x = torch.tensor(self.shift_x, dtype=self.dtype,
                         device=pos.device) + pos[..., 0]
        # single wrap, thresholds as the reference (< 0, > XDIM)
        x = torch.where(x < 0, x + xdim, torch.where(x > xdim, x - xdim, x))
        y = pos[..., 1] + 1.0
        s = torch.stack([x, y], dim=-1)                       # [..., c, n, 2]
        # node j of cilium m is off if within < 1 lattice unit (both axes)
        # of any node of cilia m-1 .. m-(r_max-1), cyclically
        eps = torch.ones(x.shape, dtype=torch.int32, device=x.device)
        for r in range(1, self.r_max):
            xo = torch.roll(x, r, dims=-2)   # cilium (m - r) mod c_num
            yo = torch.roll(y, r, dims=-2)
            close = ((xo[..., None, :] - x[..., :, None]).abs() < 1.0) & \
                    ((yo[..., None, :] - y[..., :, None]).abs() < 1.0)
            eps = torch.where(close.any(-1), torch.zeros_like(eps), eps)
        lead = pos.shape[:-3]
        ns = cfg.c_num * cfg.length
        return (s.reshape(lead + (ns, 2)), vel.reshape(lead + (ns, 2)),
                eps.reshape(lead + (ns,)))

    def anchored_nodes(self, pos):
        """(anchor [..., Ns, 2] int32, frac [..., Ns, 2] self.dtype) with the
        absolute pre-wrap position = anchor + frac, |frac| <= 0.5; from the
        f64 positions, so the cast of frac loses ~3e-8 lattice units."""
        ns = self.cfg.c_num * self.cfg.length
        ab = torch.stack([self.shift_x + pos[..., 0], pos[..., 1] + 1.0],
                         dim=-1)
        ab = ab.reshape(pos.shape[:-3] + (ns, 2))
        anchor = torch.round(ab)   # half to even, like jnp.rint
        return anchor.to(torch.int32), (ab - anchor).to(self.dtype)
