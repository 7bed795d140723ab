"""IB coupling as band matmuls — the port of cuda_iblb_11_tpu/ops/ib_band.py.

The 2-D delta is separable and every Lagrangian point lies in the force
band, so with dense per-axis factors DY [Ns, BAND], DX [Ns, X]

  interpolate:  I_q[k] = sum_x DX[k, x] sum_y DY[k, y] q[y, x]
                F_s[k] = 2 (u_s_k I_rho - I_mom)
  spread:       force[c, y, x] = sum_k (F_s[k, c] eps_k DY[k, y]) DX[k, x]

The contractions are torch matmuls, as the JAX package left them to XLA.
They must run in full f32: TF32 keeps ~3 decimal digits, and a reduced-
precision pass of exactly these contractions put 1e-3 relative noise into
the IB force on the TPU (docs/DESIGN.md:259-295).  Each function that
contracts runs under ops/precision.full_f32, which pins full f32 and restores the
caller's settings on exit; importing this module changes no setting.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.lattice import C
from cuda_iblb_11_tpu_torch.ops.ib import delta_1d
from cuda_iblb_11_tpu_torch.ops.precision import full_f32

DEFAULT_BAND = 128


def _delta_factors_anchored(anchor, frac, xdim, band, dtype, x_offset=0,
                            x_count=None, y_offset=0, y_count=None):
    """(DY [Ns, y_count], DX [Ns, x_count]) from the (int32 anchor, sub-cell
    frac) split of models/cilia.anchored_nodes, over grid rows [y_offset,
    y_offset + y_count) (default the band) and columns [x_offset, x_offset
    + x_count) (default the domain): the sharded path evaluates only a
    shard's own block.  Grid-to-anchor distances are exact int32
    arithmetic with an integer periodic fold to [-X/2, X/2) over the global
    xdim; only |frac| <= 0.5 touches the float dtype."""
    device = anchor.device
    half = xdim // 2
    x_count = xdim if x_count is None else x_count
    y_count = band if y_count is None else y_count
    xg = x_offset + torch.arange(x_count, dtype=torch.int32,
                                 device=device)[None, :]
    v = xg - anchor[:, 0][:, None].to(torch.int32)
    # |v| < 2X (the anchor is within one wrap of the domain): two
    # conditional adjustments fold it exactly
    for _ in range(2):
        v = torch.where(v >= half, v - xdim, v)
        v = torch.where(v < -half, v + xdim, v)
    dx = v.to(dtype) - frac[:, 0][:, None].to(dtype)
    yg = y_offset + torch.arange(y_count, dtype=torch.int32,
                                 device=device)[None, :]
    dy = ((yg - anchor[:, 1][:, None].to(torch.int32)).to(dtype)
          - frac[:, 1][:, None].to(dtype))
    return delta_1d(dy.abs()), delta_1d(dx.abs())


def delta_factors(anchored, xdim, band, dtype):
    """The anchored (DY, DX), evaluated once per step and shared by
    interpolate and spread."""
    return _delta_factors_anchored(anchored[0], anchored[1], xdim, band,
                                   dtype)


@full_f32()
def band_moments(f, band, storage="raw"):
    """(rho, mom [2, band, X]) of the first `band` rows, in >= f32."""
    fb = f[:, :band, :].to(torch.promote_types(f.dtype, torch.float32))
    rho = fb.sum(0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    c = torch.tensor(C, dtype=fb.dtype, device=f.device)
    mom = torch.einsum("iyx,ic->cyx", fb, c)
    return rho, mom


def finish_interpolate(i_q, u_s):
    """F_s [Ns, 2] from the delta integrals i_q [3, Ns] of (rho, mom)."""
    return (2.0 * (u_s.to(i_q.dtype).T * i_q[0][None] - i_q[1:])).T


@full_f32()
def interpolate_from_moments(q, u_s, factors):
    """Direct-forcing IB force F_s [Ns, 2] (ImmersedBoundary.cu:94-133) from
    band moments q [3, band, X] = (rho, mom_x, mom_y).  The long x axis is
    contracted first, so the intermediate is [3, band, Ns]."""
    dy, dx = factors
    t = torch.matmul(q, dx.to(q.dtype).T)                    # [3, band, Ns]
    i_q = torch.einsum("qyk,ky->qk", t, dy.to(q.dtype))      # [3, Ns]
    return finish_interpolate(i_q, u_s)


def interpolate(f, u_s, factors, band=DEFAULT_BAND, storage="raw"):
    """interpolate_from_moments on the band moments of f."""
    rho, mom = band_moments(f, band, storage)
    return interpolate_from_moments(torch.cat([rho[None], mom]), u_s, factors)


@full_f32()
def spread(f_s, eps, factors):
    """Eulerian band force field [2, band, X] (ImmersedBoundary.cu:178-231
    recast as one [2, band, Ns] @ [Ns, X] matmul; rows above the band are
    identically zero)."""
    dy, dx = factors
    lhs = f_s * eps[:, None].to(f_s.dtype)                   # [Ns, 2]
    a = lhs.T[:, None, :] * dy.to(f_s.dtype).T[None]         # [2, band, Ns]
    return torch.matmul(a, dx.to(f_s.dtype))                 # [2, band, X]


@full_f32()
def interpolate_partial(f_loc, xdim, band, y0, x0, n_rows, storage="raw",
                        anchored=None):
    """A shard's share [3, Ns] of the (rho, mom_x, mom_y) delta integrals:
    f_loc [9, yl, xl] is its block at global offset (y0, x0), summed over
    its first n_rows rows (min(yl, band) suffices: the y-factors vanish
    above the band).  The caller sums the shares of every shard and
    finishes with finish_interpolate (cuda_iblb_11_tpu/ops/ib_band.py:
    182-206)."""
    if anchored is None:
        raise ValueError("sharded interpolation requires anchored positions")
    rho, mom = band_moments(f_loc, n_rows, storage)
    dy, dx = _delta_factors_anchored(
        anchored[0], anchored[1], xdim, band, rho.dtype, x_offset=x0,
        x_count=f_loc.shape[2], y_offset=y0, y_count=n_rows)
    q = torch.cat([rho[None], mom])                          # [3, n, xl]
    t = torch.matmul(q, dx.T)                                # [3, n, Ns]
    return torch.einsum("qyk,ky->qk", t, dy)                 # [3, Ns]


def spread_local(f_s, eps, xdim, band, x0, xl, anchored=None):
    """A shard's columns [2, band, xl] of the band force, at global column
    offset x0: every point against the shard's own x-factors, so no sum
    across shards (cuda_iblb_11_tpu/ops/ib_band.py:215-225)."""
    if anchored is None:
        raise ValueError("sharded spreading requires anchored positions")
    factors = _delta_factors_anchored(anchored[0], anchored[1], xdim, band,
                                      f_s.dtype, x_offset=x0, x_count=xl)
    return spread(f_s, eps, factors)


def pad_band(force_band, ydim):
    """Embed a band force field into the full [2, Y, X] grid."""
    band = force_band.shape[1]
    if band >= ydim:
        return force_band[:, :ydim, :]
    pad = force_band.new_zeros((2, ydim - band, force_band.shape[2]))
    return torch.cat([force_band, pad], dim=1)
