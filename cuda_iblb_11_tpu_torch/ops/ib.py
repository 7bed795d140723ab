"""Immersed-boundary pieces of cuda_iblb_11_tpu/ops/ib.py used by the
single-step path: the reference's 3-point regularized delta and the
cumulative flux sample.

The stencil interpolate/spread forms that ``--ib-x-edge reference`` runs
wait for a later slice (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.lattice import C

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


def _pad_rows(col, ydim):
    """A band-sized force column padded with zeros to ydim rows."""
    if col.shape[0] < ydim:
        col = torch.cat([col, col.new_zeros(ydim - col.shape[0])])
    return col


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
