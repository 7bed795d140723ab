"""Immersed-boundary coupling — the port of cuda_iblb_11_tpu/ops/ib.py:
the reference's 3-point regularized delta, the stencil forms of
interpolation and spreading, and the cumulative flux sample.

The stencil forms serve the strict-parity quirk mode (``--ib-x-edge
reference``, ImmersedBoundary.cu:117-124 and :178-231): interpolation
row-aliases the unwrapped flat index ``y*XDIM + x`` (reads outside the
buffer masked), spreading drops the cells outside the grid; "periodic"
wraps x.  The gather of interpolation is order-free.  The spread is not a
scatter-add: ``index_add_`` on CUDA sums in a run-dependent order (atomics),
which would break the bit-identical resume and the temporal-vs-single
identity.  It is the band-matmul form of ops/ib_band.py on dense per-axis
delta factors of the raw positions, unwrapped for "reference_drop" (so the
cells outside [0, X) get zero weight, exactly the dropped ones) and folded
periodically for "periodic": one fixed-order contraction on every device.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.lattice import C
from cuda_iblb_11_tpu_torch.ops.precision import full_f32

# Reference coefficient literals (ImmersedBoundary.cu:36,43).
_A_INNER = 0.33333
_A_OUTER = 0.16667


def delta_1d(r):
    """1-D 3-point regularized delta, reference form (ImmersedBoundary.cu:31-78).

    r <= 0.5:        0.33333 * (1 + sqrt(1 - 3 r^2))
    0.5 < r <= 1.5:  0.16667 * (5 - 3 r - sqrt(-3 (1-r)^2 + 1))
    r > 1.5:         0
    """
    r = r.abs()
    inner = _A_INNER * (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * r * r, min=0.0)))
    d = 1.0 - r
    outer = _A_OUTER * (
        5.0 - 3.0 * r - torch.sqrt(torch.clamp(-3.0 * d * d + 1.0, min=0.0)))
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(r <= 0.5, inner, torch.where(r <= 1.5, outer, zero))


def _stencil(s, xdim, ydim, x_edge="periodic"):
    """3 x 3 stencil around nearbyint of each point: (xw, yc, weight,
    valid), each [Ns, 9]: the cell's x and y index, the 2-D delta weight at
    the unwrapped cell coordinate, and a mask of the valid cells.  The
    offsets are the 9 lattice vectors (ImmersedBoundary.cu:117-124);
    torch.round rounds half to even, as C's nearbyint and jnp.rint do.
    x_edge: "periodic" wraps x; "reference_alias" reproduces the flat
    ``j = y*XDIM + x`` row-aliasing of interpolate (reads outside the
    buffer masked); "reference_drop" the raw-coordinate test of spread that
    never sees the periodic images."""
    xs = s[:, 0][:, None]
    ys = s[:, 1][:, None]
    cx = torch.tensor(C[:, 0], dtype=s.dtype, device=s.device)[None, :]
    cy = torch.tensor(C[:, 1], dtype=s.dtype, device=s.device)[None, :]
    xi = torch.round(xs) + cx    # unwrapped cell coordinates [Ns, 9]
    yi = torch.round(ys) + cy
    w = delta_1d(xi - xs) * delta_1d(yi - ys)
    xii, yii = xi.to(torch.int64), yi.to(torch.int64)
    if x_edge == "periodic":
        valid = (yi >= 0) & (yi <= ydim - 1)
        xw = torch.remainder(xii, xdim)
        yc = yii.clamp(0, ydim - 1)
    elif x_edge == "reference_alias":
        j = yii * xdim + xii
        valid = (j >= 0) & (j < xdim * ydim)
        j = j.clamp(0, xdim * ydim - 1)
        yc = torch.div(j, xdim, rounding_mode="floor")
        xw = j - yc * xdim
    elif x_edge == "reference_drop":
        valid = ((xi >= 0) & (xi <= xdim - 1)
                 & (yi >= 0) & (yi <= ydim - 1))
        xw = xii.clamp(0, xdim - 1)
        yc = yii.clamp(0, ydim - 1)
    else:
        raise ValueError(f"unknown x_edge mode {x_edge!r}")
    return xw, yc, w, valid


def _alias_mode(x_edge, kind):
    if x_edge == "periodic":
        return "periodic"
    if x_edge == "reference":
        return "reference_alias" if kind == "interp" else "reference_drop"
    raise ValueError(f"unknown x_edge mode {x_edge!r}")


def _finish(w, rho_n, u_n, u_s):
    """F_s [Ns, 2] = sum over the stencil of 2 w rho (u_s - u)."""
    diff = u_s.T[:, :, None] - u_n                        # [2, Ns, 9]
    return (2.0 * w[None] * rho_n[None] * diff).sum(-1).T


def interpolate(rho, u, s, u_s, x_edge="periodic"):
    """Direct-forcing IB force at each Lagrangian point from rho [Y, X] and
    the uncorrected velocity u [2, Y, X]: F_s [Ns, 2]
    (ImmersedBoundary.cu:94-133)."""
    ydim, xdim = rho.shape
    xw, yc, w, valid = _stencil(s, xdim, ydim, _alias_mode(x_edge, "interp"))
    w = torch.where(valid, w, torch.zeros_like(w))
    return _finish(w, rho[yc, xw], u[:, yc, xw], u_s)


@full_f32()
def interpolate_from_f(f, s, u_s, storage="raw", x_edge="periodic"):
    """:func:`interpolate` with the moments taken from the distributions at
    the Ns x 9 stencil cells only (the reference's separate macro pass,
    LatticeBoltzmann.cu:375-411, fused away)."""
    _, ydim, xdim = f.shape
    xw, yc, w, valid = _stencil(s, xdim, ydim, _alias_mode(x_edge, "interp"))
    w = torch.where(valid, w, torch.zeros_like(w))
    f_n = f[:, yc, xw]                                    # [9, Ns, 9]
    rho_n = f_n.sum(0)
    if storage == "deviatoric":
        rho_n = 1.0 + rho_n
    c = torch.tensor(C, dtype=f.dtype, device=f.device)
    u_n = torch.einsum("inm,ic->cnm", f_n, c) / rho_n[None]
    return _finish(w, rho_n, u_n, u_s)


def stencil_factors(s, xdim, ydim, x_edge="periodic"):
    """Dense per-axis delta factors (DY [Ns, ydim], DX [Ns, xdim]) of the
    raw positions s [Ns, 2] whose products are the stencil weights of the
    spread modes: x distances folded to [-X/2, X/2) for "periodic",
    unwrapped for "reference_drop" (|distance| >= 1.5 outside the grid, so
    zero weight); y never wraps.  A cell outside a point's 3 x 3 stencil is
    at least 1.5 from it, where the delta is exactly zero.  Each distance
    is the exact integer offset from the point's nearest cell less its
    exact sub-cell fraction, so it rounds once, as the stencil's
    (nearbyint + c) - s does, and the weights equal the stencil's bit for
    bit."""
    if x_edge not in ("periodic", "reference_drop"):
        raise ValueError(f"no spread in x_edge mode {x_edge!r}")

    def axis(p, n, fold):
        p0 = torch.round(p)[:, None]
        d = (torch.arange(n, dtype=torch.int64, device=s.device)[None, :]
             - p0.to(torch.int64))
        if fold:   # |d| < 2n: two conditional shifts fold it exactly
            for _ in range(2):
                d = torch.where(d >= n // 2, d - n, d)
                d = torch.where(d < -(n // 2), d + n, d)
        return delta_1d(d.to(s.dtype) - (p[:, None] - p0))

    return (axis(s[:, 1], ydim, False),
            axis(s[:, 0], xdim, x_edge == "periodic"))


@full_f32()
def spread(F_s, s, eps, xdim, ydim, x_edge="periodic"):
    """Eulerian IB force field [2, ydim, X] from the points' forces F_s
    [Ns, 2], positions s and overlap mask eps [Ns]
    (ImmersedBoundary.cu:178-231): sum_k F_s_k eps_k DY[k, y] DX[k, x], the
    band-matmul spread of ops/ib_band.py on the stencil factors (a fixed
    order, no atomics)."""
    from cuda_iblb_11_tpu_torch.ops import ib_band   # it imports delta_1d

    return ib_band.spread(F_s, eps, stencil_factors(
        s, xdim, ydim, _alias_mode(x_edge, "spread")))


def _pad_rows(col, ydim):
    """A band-sized force column padded with zeros to ydim rows."""
    if col.shape[0] < ydim:
        col = torch.cat([col, col.new_zeros(ydim - col.shape[0])])
    return col


@full_f32()
def flux_increment(f_new, force_new, flux_x, ydim_divisor=192.0,
                   storage="raw"):
    """Per-step flux sample sum_y u_x(x=flux_x, y) / 192 with the
    half-force-corrected velocity (ImmersedBoundary.cu:249-264); the
    reference hardcodes the 192 divisor (:261)."""
    cdt = torch.promote_types(f_new.dtype, torch.float32)
    cx = torch.tensor(C[:, 0], dtype=cdt, device=f_new.device)
    col_f = f_new[:, :, flux_x].to(cdt)                     # [9, Y]
    rho = col_f.sum(0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    mom_x = torch.einsum("iy,i->y", col_f, cx)
    fcol = _pad_rows(force_new[0, :, flux_x].to(cdt), f_new.shape[1])
    ux = (mom_x + 0.5 * fcol) / rho
    return ux.sum() / ydim_divisor


def flux_from_cols(fluxcol, force_new, flux_x, ydim_divisor=192.0):
    """Flux sample from the fused step's emitted column: fluxcol [2, Y]
    holds per-row (rho, mom_x) at x = flux_x (storage adjustment applied);
    combined with the NEW force's half-force correction exactly like
    flux_increment.  (The JAX kernel pads the column to 128 lanes,
    [2, Y, 128] with lane 0 used; the port keeps [2, Y].)"""
    rho, mom_x = fluxcol[0], fluxcol[1]
    fcol = _pad_rows(force_new[0, :, flux_x].to(fluxcol.dtype), rho.shape[0])
    return ((mom_x + 0.5 * fcol) / rho).sum() / ydim_divisor
