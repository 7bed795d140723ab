"""Plain-torch D2Q9 TRT oracle — the port of cuda_iblb_11_tpu/ops/reference.py.

The same four LB kernels of the reference (CUDA_IBLB_11/LatticeBoltzmann.cu):
equilibrium (+ Guo forcing), two-relaxation-time collision, pull-form
streaming with wall fix-ups, and the macroscopic moments — with the same
semantics: TRT pairs (1,3),(2,4),(5,7),(6,8); the rest population relaxes
with omega+ only and gets no forcing (:86); c_s = 0.57735 inside the
kernels (:11); bottom halfway bounce-back, top specular slip, periodic x,
wall rows overwritten after the roll (corner precedence, :199-365).

Raw storage holds f_i; deviatoric storage holds f_i - w_i (rho = 1 + sum f).
Any float dtype; the tests hold it to the JAX oracle at f64 round-off.
The functions that contract (einsum) run under ops/precision.full_f32, so
a caller's TF32 setting does not reach the plain step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cuda_iblb_11_tpu_torch.core import lattice
from cuda_iblb_11_tpu_torch.core.lattice import (
    C, CS_KERNEL, MIRROR_X, MIRROR_Y, OPPOSITE, RHO_0, W,
)
from cuda_iblb_11_tpu_torch.ops.precision import full_f32

CS2 = CS_KERNEL * CS_KERNEL
CS4 = CS2 * CS2

_OPP = [int(i) for i in OPPOSITE]


@dataclass(frozen=True)
class WallSpec:
    """Boundary condition per edge: 'periodic' | 'noslip' (halfway
    bounce-back) | 'slip' (specular) | 'moving' (bounce-back with wall
    velocity ``u_wall``).  The default is the reference channel."""

    bottom: str = "noslip"
    top: str = "slip"
    left: str = "periodic"
    right: str = "periodic"
    u_wall: tuple[float, float] = (0.0, 0.0)

    def __post_init__(self):
        for e in (self.bottom, self.top, self.left, self.right):
            if e not in ("periodic", "noslip", "slip", "moving"):
                raise ValueError(f"unknown wall type {e!r}")
        if (self.left == "periodic") != (self.right == "periodic"):
            raise ValueError("x-periodicity must match on both edges")
        if (self.bottom == "periodic") != (self.top == "periodic"):
            raise ValueError("y-periodicity must match on both edges")


REFERENCE_WALLS = WallSpec()


# built once per dtype and device: a tensor built from host values on every
# call is a copy that waits for the device's queued work; no caller writes
# into them
@functools.cache
def _c(dtype, device):
    return torch.tensor(C, dtype=dtype, device=device)   # [9, 2]


@functools.cache
def _w(dtype, device):
    return torch.tensor(W, dtype=dtype, device=device)   # [9]


def _density(f, storage):
    rho = f.sum(0)
    return 1.0 + rho if storage == "deviatoric" else rho


@full_f32()
def moments(f, storage="raw"):
    """rho = sum_i f_i ; u = sum_i c_i f_i / rho (LatticeBoltzmann.cu:396-405)."""
    rho = _density(f, storage)
    mom = torch.einsum("iyx,ic->cyx", f, _c(f.dtype, f.device))
    return rho, mom / rho


@full_f32()
def corrected_velocity(f, force, storage="raw"):
    """u = (sum_i c_i f_i + force/2) / rho (ImmersedBoundary.cu:249-255)."""
    rho = _density(f, storage)
    mom = torch.einsum("iyx,ic->cyx", f, _c(f.dtype, f.device))
    return rho, (mom + 0.5 * force) / rho


@full_f32()
def equilibrium(rho, u, storage="raw", drho=None):
    """Second-order D2Q9 equilibrium (LatticeBoltzmann.cu:47-50); in
    deviatoric storage f0_i - w_i = w_i [drho + rho poly], formed without
    the constant part.  drho = sum_i (f_i - w_i) may be passed in: formed
    as rho - 1 in f32 it would keep only the bits of rho ~ 1, a ~1e-6
    relative error on the deviation that the fused kernel (which never
    forms rho - 1) does not make."""
    c = _c(u.dtype, u.device)
    w = _w(u.dtype, u.device)[:, None, None]
    cu = torch.einsum("ic,cyx->iyx", c, u)
    u2 = (u * u).sum(0)
    poly = cu / CS2 + cu * cu / (2.0 * CS4) - u2[None] / (2.0 * CS2)
    if storage == "deviatoric":
        if drho is None:
            drho = rho - 1.0
        return w * (drho[None] + rho[None] * poly)
    return rho[None] * w * (1.0 + poly)


@full_f32()
def guo_forcing(u, force, tau, tau2=None, scheme="reference"):
    """Guo force term for all 9 populations (the collision ignores F[0]).

    "reference": (1 - 1/(2 tau)) on every population (LatticeBoltzmann.cu:
    53-56).  "trt_split": even part (1 - 1/(2 tau)), odd part
    (1 - 1/(2 tau2)) — the TRT-consistent split (see the JAX oracle)."""
    c = _c(u.dtype, u.device)
    w = _w(u.dtype, u.device)[:, None, None]
    cu = torch.einsum("ic,cyx->iyx", c, u)                       # [9, Y, X]
    cc = c[:, :, None, None]                                     # [9, 2, 1, 1]
    vec = (cc - u[None]) / CS2 + cu[:, None] * cc / CS4          # [9, 2, Y, X]
    proj = (vec * force[None]).sum(1)                            # [9, Y, X]
    if scheme == "reference":
        return (1.0 - 1.0 / (2.0 * tau)) * w * proj
    if scheme == "trt_split":
        if tau2 is None:
            raise ValueError("trt_split forcing needs tau2")
        s = w * proj
        s_opp = s[_OPP]
        s_even = 0.5 * (s + s_opp)
        s_odd = 0.5 * (s - s_opp)
        return ((1.0 - 1.0 / (2.0 * tau)) * s_even
                + (1.0 - 1.0 / (2.0 * tau2)) * s_odd)
    raise ValueError(f"unknown forcing scheme {scheme!r}")


def trt_collide(f, f0, F, tau, tau2):
    """TRT collision (LatticeBoltzmann.cu:86-134); i=0 relaxes with omega+
    only and gets no forcing."""
    omega_p = 1.0 / tau
    omega_m = 1.0 / tau2
    f_opp = f[_OPP]
    f0_opp = f0[_OPP]
    f_plus = 0.5 * (f + f_opp)
    f_minus = 0.5 * (f - f_opp)
    f0_plus = 0.5 * (f0 + f0_opp)
    f0_minus = 0.5 * (f0 - f0_opp)
    f1 = f - omega_p * (f_plus - f0_plus) - omega_m * (f_minus - f0_minus) + F
    f1[0] = f[0] - omega_p * (f[0] - f0[0])
    return f1


def stream(f1, walls: WallSpec = REFERENCE_WALLS, rho_wall: float = RHO_0):
    """Pull-form streaming with in-array wall fix-ups: interior + periodic
    gather f[d, i] = f1[d - c_i, i], then the wall rows/columns overwritten
    with the same cell's permuted populations (LatticeBoltzmann.cu:173-373)."""
    out = torch.stack([
        torch.roll(f1[i], (int(C[i, 1]), int(C[i, 0])), dims=(0, 1))
        for i in range(9)
    ])

    def edge_fixup(edge, row_idx, incoming, axis):
        if edge == "periodic":
            return
        if edge == "slip":
            perm = MIRROR_Y if axis == 0 else MIRROR_X
        else:  # noslip, moving
            perm = OPPOSITE
        for i in incoming:
            src = int(perm[i])
            val = f1[src, row_idx, :] if axis == 0 else f1[src, :, row_idx]
            if edge == "moving":
                # Ladd momentum term 2 w_i rho_w (c_i . u_w) / cs^2, cs^2=1/3
                cu_w = (float(C[i, 0]) * walls.u_wall[0]
                        + float(C[i, 1]) * walls.u_wall[1])
                val = val + 2.0 * float(W[i]) * rho_wall * cu_w * 3.0
            if axis == 0:
                out[int(i), row_idx, :] = val
            else:
                out[int(i), :, row_idx] = val

    ydim, xdim = f1.shape[1], f1.shape[2]
    if walls.bottom != "periodic":
        edge_fixup(walls.bottom, 0, lattice.UP_GOING, axis=0)
        edge_fixup(walls.top, ydim - 1, lattice.DOWN_GOING, axis=0)
    if walls.left != "periodic":
        edge_fixup(walls.left, 0, (1, 5, 8), axis=1)
        edge_fixup(walls.right, xdim - 1, (3, 6, 7), axis=1)
    return out


def collide_rows(f, force, tau, tau2, forcing="reference", storage="raw"):
    """Equilibrium + Guo + TRT collide of (f, force) -> f1, no streaming
    (collision is cell-local, so any row slab works)."""
    rho, u = corrected_velocity(f, force, storage)
    drho = f.sum(0) if storage == "deviatoric" else None
    f0 = equilibrium(rho, u, storage, drho)
    F = guo_forcing(u, force, tau, tau2, scheme=forcing)
    return trt_collide(f, f0, F, tau, tau2)


def lb_substep(f, force, tau, tau2, walls: WallSpec = REFERENCE_WALLS,
               forcing: str = "reference", storage: str = "raw"):
    """One fluid update: equilibrium -> TRT collide -> stream, with this
    step's f and the previous step's IB force (main.cu:852).  Returns
    (f_new, rho_new, u_new), the uncorrected macro moments."""
    f_new = stream(collide_rows(f, force, tau, tau2, forcing, storage), walls)
    rho_new, u_new = moments(f_new, storage)
    return f_new, rho_new, u_new
