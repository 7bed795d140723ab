"""B8: the band super-step of one x-shard — the port of
make_band_super_substep_xsharded (cuda_iblb_11_tpu/ops/pallas_step.py:1727,
built by _build_band_super_call :1411 with runtime_flux, call :1482,
kernel _band_super_kernel :1085).

    band_super_xsharded(flags, f_ext, force, us, eps, axl, fx, ay, fy, cfg,
                        lay, ...) -> (f_band, bhalos, force_new, flux)

The B6 kernel (csrc/band_super.cu, tile layout) on one shard's block: its
xl columns and gx ghost columns a side from its x-neighbours, so f_ext
[9, band + pad, xl + 2 gx] and force [2, band, xl + 2 gx]; the outputs
are in the same block columns (the caller keeps the interior).  `lay` is
ops/temporal.xshard_layout's: the window layout, uniform where xl is a
c_space multiple, else phase-general (windows c_space wider, from block
column 0).  The points are the shard's c_sub point blocks
(``shard_points``).  flags = (lane, owned): the flux column's lane in the
block and whether this shard owns it; flux [K] holds zeros where it does
not (the JAX kernel takes both at run time, as every shard runs one
program there).

``band_super_xsharded`` launches the kernel for CUDA tensors (or raises)
and calls ``band_super_xsharded_reference`` for CPU tensors.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super_block, launch_band_super,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import _into


def shard_points(lay, xs, cfg, ix: int, xl: int):
    """Shard ix's point blocks from the whole domain's (the layout of
    models/mucociliary.prep_band_super_points, one super-step: us
    [K, 2, c, 128], the rest [K, c, 128]), as sharded.py:1132-1164 takes
    them.  Window-local coordinates do not depend on the lift, so a roll
    of the per-cilium blocks gives the subset.  Phase-general: all of the
    shard's cilia share one phase r in [0, c_space) against the block's
    window grid, added to the x anchors; a block whose natural window
    overruns the block is made inert (eps 0: its neighbour computes
    it)."""
    us, ep, axl, fx, ay, fy = xs
    c_num, cw, c_sub = cfg.c_num, cfg.c_space, lay.c_sub
    if lay.phase_general:
        x0e = ix * xl - lay.gx
        mstart = -((-(x0e + lay.halo)) // cw)
        r = mstart * cw - lay.halo - x0e
        shift = mstart % c_num
    else:
        shift = (lay.m0 + ix * lay.c_step) % c_num

    def sub(a, dim):
        return torch.roll(a, -shift, dims=dim).narrow(dim, 0, c_sub)

    us_s, ep_s, axl_s = sub(us, 2), sub(ep, 1), sub(axl, 1)
    fx_s, ay_s, fy_s = sub(fx, 1), sub(ay, 1), sub(fy, 1)
    if lay.phase_general:
        valid = torch.tensor([r + j * cw + lay.wcov <= lay.width
                              for j in range(c_sub)], dtype=ep_s.dtype,
                             device=ep_s.device)
        ep_s = ep_s * valid[None, :, None]
        axl_s = axl_s + r
    return tuple(x.contiguous() for x in (us_s, ep_s, axl_s, fx_s, ay_s,
                                          fy_s))


def band_super_xsharded_reference(flags, f_ext, force, us, eps, axl, fx, ay,
                                  fy, cfg, lay, walls=ref.REFERENCE_WALLS,
                                  forcing="trt_split", storage="raw",
                                  out=None):
    """Plain torch version: ops/band_super.band_super_block on the shard's
    block in the layout's windows; f_band goes into ``out`` when given."""
    lane, owned = (int(v) for v in flags)
    f_band, bhalos, force_new, flux = band_super_block(
        f_ext, force, us, eps, axl, fx, ay, fy, cfg, lay.halo, walls,
        forcing, storage, lay.win_lo0, lane if owned else None, lay.wwin)
    if flux is None:
        flux = force_new.new_zeros((us.shape[0],))
    return _into(out, f_band.to(f_ext.dtype)), bhalos, force_new, flux


def band_super_xsharded(flags, f_ext, force, us, eps, axl, fx, ay, fy, cfg,
                        lay, walls=ref.REFERENCE_WALLS, forcing="trt_split",
                        storage="raw", out=None):
    """(f_band, bhalos, force_new, flux) in block columns.  CUDA tensors
    launch the hand kernel once: f_ext and ``out`` ([9, band, width]) may
    be row ranges of larger tensors and must not overlap.  CPU tensors take
    the plain version."""
    if f_ext.device.type == "cpu":
        return band_super_xsharded_reference(
            flags, f_ext, force, us, eps, axl, fx, ay, fy, cfg, lay, walls,
            forcing, storage, out)
    if f_ext.device.type != "cuda":
        raise ValueError(f"band_super_xsharded: unsupported device "
                         f"{f_ext.device}")
    lane, owned = (int(v) for v in flags)
    if f_ext.shape[-1] != lay.width or us.dim() != 4 \
            or us.shape[2] != lay.c_sub:
        raise ValueError(f"band_super_xsharded takes the layout's "
                         f"{lay.width} columns and {lay.c_sub} point "
                         f"blocks: f_ext {tuple(f_ext.shape)}, us "
                         f"{tuple(us.shape)}")
    out, bhalos, force_new, flux = launch_band_super(
        f_ext, force, (us, eps, axl, fx, ay, fy), cfg, lay.wwin,
        lay.win_lo0, lane if owned else None, walls, forcing, storage,
        "band_super_xsharded", out)
    if flux is None:     # a shard without the flux column
        flux = torch.zeros((us.shape[0],), dtype=force_new.dtype,
                           device=f_ext.device)
    band_super_xsharded.launches += 1
    return out, bhalos, force_new, flux


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
band_super_xsharded.launches = 0
