"""B6: the x-tiled band super-step — the port of
make_band_super_substep_tiled (cuda_iblb_11_tpu/ops/pallas_step.py:1582,
each tile built by _build_band_super_call :1411, kernel _band_super_kernel
:1085 in its fold=False layout).

    band_super_tiled(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
                     tile_x, gx, ...) -> (f_band, bhalos, force_new, flux)

The same function as B5 (ops/band_super.py: the same arguments, the points
in the same layout, the same outputs), in tiles small enough to stay in
the card's L2 during the 2K + 2 launches of one call; a plan takes it only
under a footprint budget (ops/temporal.py).  The domain splits into
xdim / tile_x tiles; tile t runs the B5 kernel (csrc/band_super.cu, tile
layout) on the extended block of columns [t tile_x - gx, (t+1) tile_x + gx)
(periodic), gathered from f_ext and the force, with every periodic lift of
a cilium whose window lies fully inside the block (ops/temporal.
band_super_block_windows), and keeps the block's interior columns
[gx, gx + tile_x).  The ghost columns gx >= W + 8K (W = c_space + 2 halo)
hold every error that enters at the block's edges (the x-roll wraps at the
block's width, and the cilia left out stop at most one window short of
the edge) out of the interior for K sub-steps (pallas_step.py:1603-1619).
Only the tile holding cfg.flux_x takes the flux column.

The tiles run in sequence on the caller's stream, so each tile's working
set stays in L2 across its launches.  Each tile's input is gathered into
a scratch block and its interior copied out of one (per tile: the f and
force gathers, and the f_band, bhalos and force copies); chip_smoke.py
counts those bytes beside the call's time.

``band_super_tiled`` launches the kernel once per tile for CUDA tensors
(or raises) and calls ``band_super_tiled_reference`` for CPU tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super_block, check_points, launch_band_super,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import _into
from cuda_iblb_11_tpu_torch.ops.temporal import band_super_block_windows


@dataclass(frozen=True)
class TileLayout:
    tile_x: int          # interior columns of a tile
    gx: int              # ghost columns on each side
    n_tiles: int
    txe: int             # tile_x + 2 gx, the block's width
    win_lo0: int         # block column of the first point block's window
    cilia: tuple         # per tile, the cilium of each point block
    t_flux: int          # the tile holding the flux column
    flux_local: int      # its block column there


@functools.lru_cache(maxsize=None)
def _tile_index(lay: TileLayout, device: torch.device):
    """(cilia [n_tiles, c_sub], columns [n_tiles, txe]) as int64 tensors
    on `device`: each tile's point blocks and the domain column of each
    block column.  Made once per layout and device."""
    xdim = lay.n_tiles * lay.tile_x
    cols = [[(t * lay.tile_x - lay.gx + j) % xdim for j in range(lay.txe)]
            for t in range(lay.n_tiles)]
    return (torch.tensor(lay.cilia, dtype=torch.int64, device=device),
            torch.tensor(cols, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=None)
def _layout(c_num, cw, xdim, flux_x, halo, tile_x, gx, K) -> TileLayout:
    if tile_x <= 0 or tile_x % cw or xdim % tile_x or xdim // tile_x < 2:
        raise ValueError(
            f"tile_x={tile_x} must be a multiple of c_space={cw} dividing "
            f"xdim={xdim} into >= 2 tiles")
    if tile_x + 2 * gx > xdim:
        # a cilium's two periodic images would both fall inside one block
        raise ValueError(f"tile_x + 2 gx = {tile_x + 2 * gx} exceeds "
                         f"xdim={xdim}")
    if gx < cw + 2 * halo + 8 * K:
        raise ValueError(f"gx={gx} is below the ghost margin W + 8K = "
                         f"{cw + 2 * halo + 8 * K}")
    n = xdim // tile_x
    lifts, win_lo = band_super_block_windows(c_num, cw, halo, tile_x, gx, n)
    # tiles that are whole multiples of c_space share one window layout,
    # window j at win_lo0 + j c_space (pallas_step.py:1673)
    if any(w != win_lo[0] for w in win_lo):
        raise ValueError("the tiles' window layout is not uniform")
    t_flux = flux_x // tile_x
    return TileLayout(tile_x=tile_x, gx=gx, n_tiles=n, txe=tile_x + 2 * gx,
                      win_lo0=win_lo[0][0],
                      cilia=tuple(tuple(m % c_num for m in t)
                                  for t in lifts),
                      t_flux=t_flux, flux_local=flux_x - t_flux * tile_x + gx)


def tile_layout(cfg, halo: int, tile_x: int, gx: int, K: int) -> TileLayout:
    """The tiling of cfg's band by tile_x interior and gx ghost columns for
    K sub-steps; raises ValueError for a tile the design does not take
    (pallas_step.py:1643-1675)."""
    return _layout(cfg.c_num, cfg.c_space, cfg.xdim, cfg.flux_x, halo,
                   tile_x, gx, K)


def _tile_points(lay, xs, device):
    """Each tile's point blocks, tile-major: us [n_tiles, K, 2, c_sub,
    128], the others [n_tiles, K, c_sub, 128], each tile contiguous."""
    idx, _ = _tile_index(lay, device)
    us, *rest = xs
    return (us[:, :, idx].movedim(2, 0).contiguous(),
            *(x[:, idx].movedim(1, 0).contiguous() for x in rest))


def band_super_tiled_reference(f_ext, force, us, eps, axl, fx, ay, fy, cfg,
                               halo, tile_x, gx, walls=ref.REFERENCE_WALLS,
                               forcing="trt_split", storage="raw", out=None):
    """Plain torch version: ops/band_super.band_super_block in its tile
    layout on each tile in turn, the interiors joined; f_band goes into
    ``out`` when given."""
    lay = tile_layout(cfg, halo, tile_x, gx, us.shape[0])
    _, cols = _tile_index(lay, f_ext.device)
    pts = _tile_points(lay, (us, eps, axl, fx, ay, fy), f_ext.device)
    inner = slice(gx, gx + tile_x)
    fb, bh, fo, flux = [], [], [], None
    for t in range(lay.n_tiles):
        own = t == lay.t_flux
        f_t, bh_t, fo_t, flux_t = band_super_block(
            f_ext[:, :, cols[t]], force[:, :, cols[t]], *(p[t] for p in pts),
            cfg, halo, walls, forcing, storage, lay.win_lo0,
            lay.flux_local if own else None)
        fb.append(f_t[..., inner])
        bh.append(bh_t[..., inner])
        fo.append(fo_t[..., inner])
        if own:
            flux = flux_t
    return (_into(out, torch.cat(fb, -1).to(f_ext.dtype)), torch.cat(bh, -1),
            torch.cat(fo, -1), flux)


def band_super_tiled(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
                     tile_x, gx, walls=ref.REFERENCE_WALLS,
                     forcing="trt_split", storage="raw", out=None):
    """(f_band, bhalos, force_new, flux), as ops/band_super.band_super.
    CUDA tensors launch the hand kernel once per tile: f_ext and ``out``
    ([9, band, X]) may be row ranges of larger states and must not
    overlap.  CPU tensors take the plain version."""
    if f_ext.device.type == "cpu":
        return band_super_tiled_reference(f_ext, force, us, eps, axl, fx, ay,
                                          fy, cfg, halo, tile_x, gx, walls,
                                          forcing, storage, out)
    if f_ext.device.type != "cuda":
        raise ValueError(f"band_super_tiled: unsupported device "
                         f"{f_ext.device}")
    dt, dev = f_ext.dtype, f_ext.device
    _kernels.check_scheme(dt, walls, forcing, storage, "band_super_tiled")
    cdt = aux_dtype(dt)
    band, xdim = cfg.force_band, cfg.xdim
    if us.dim() != 4 or us.shape[0] < 1:
        raise ValueError(f"us must be [K, 2, c, 128], got {tuple(us.shape)}")
    K = us.shape[0]
    if halo < 0 or not 0 <= cfg.flux_x < xdim:
        raise ValueError(f"halo {halo} or flux_x {cfg.flux_x} out of range")
    lay = tile_layout(cfg, halo, tile_x, gx, K)
    rows = f_ext.shape[1]
    _kernels.check_planes("f_ext", f_ext, (9, rows, xdim), dt, dev)
    _kernels.check_tensor("force", force, (2, band, xdim), cdt, dev)
    # the whole domain's points: each tile takes its subset itself
    check_points((us, eps, axl, fx, ay, fy), K, cfg.c_num, cdt, dev)
    if out is None:
        out = torch.empty((9, band, xdim), dtype=dt, device=dev)
    _kernels.check_planes("out", out, (9, band, xdim), dt, dev)
    _kernels.check_disjoint("out", out, "f_ext", f_ext)
    _, cols = _tile_index(lay, dev)
    pts = _tile_points(lay, (us, eps, axl, fx, ay, fy), dev)
    bhalos = torch.empty((K, 9, xdim), dtype=cdt, device=dev)
    force_new = torch.empty((2, band, xdim), dtype=cdt, device=dev)
    flux = None
    # one tile's gathered inputs and its f_band, reused by every tile in
    # stream order
    f_t = torch.empty((9, rows, lay.txe), dtype=dt, device=dev)
    force_t = torch.empty((2, band, lay.txe), dtype=cdt, device=dev)
    fb_t = torch.empty((9, band, lay.txe), dtype=dt, device=dev)
    inner = slice(gx, gx + tile_x)
    for t in range(lay.n_tiles):
        own = t == lay.t_flux
        torch.index_select(f_ext, 2, cols[t], out=f_t)
        torch.index_select(force, 2, cols[t], out=force_t)
        _, bh_t, fo_t, flux_t = launch_band_super(
            f_t, force_t, [p[t] for p in pts], cfg, cfg.c_space + 2 * halo,
            lay.win_lo0, lay.flux_local if own else None, walls, forcing,
            storage, "band_super_tiled", fb_t)
        band_super_tiled.launches += 1
        if own:
            flux = flux_t
        lo = t * tile_x
        out[:, :, lo:lo + tile_x].copy_(fb_t[:, :, inner])
        bhalos[:, :, lo:lo + tile_x].copy_(bh_t[:, :, inner])
        force_new[:, :, lo:lo + tile_x].copy_(fo_t[:, :, inner])
    return out, bhalos, force_new, flux


# Tile launches of the kernel since the last reset (the CPU path does not
# count).
band_super_tiled.launches = 0
