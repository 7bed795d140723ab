"""One fused collide + pull-stream step with band-moment and flux-column
emission: B2, the port of make_fused_substep(pipeline=True,
emit_moments=True) (cuda_iblb_11_tpu/ops/pallas_step.py:444, kernel
_pipelined_kernel :181, collide _collide_tile :642), and B3, the port of
make_sharded_fused_substep (:2217), the same kernel on a row block with
flags, neighbour halo rows and an exposed f1 row (the temporal band leg
and the sharded path, on a shard's own columns).

``fused_substep`` and ``sharded_fused_substep`` are the wrappers: for CUDA
tensors they launch the hand kernel csrc/fused_step.cu (or raise); for CPU
tensors they call ``fused_substep_reference`` and
``sharded_fused_substep_reference``, the plain torch versions built from
ops/reference.py.  B2 returns

    f_new    [9, Y, X]     the streamed state (storage dtype)
    q        [3, band, X]  post-stream (rho, mom_x, mom_y) over the force band
    fluxcol  [2, Y]        post-stream (rho, mom_x) at x = cfg.flux_x

with the storage adjustment (rho = 1 + sum f in deviatoric storage) applied.
The JAX kernel pads fluxcol to 128 lanes; the port keeps the column only.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.lattice import CX, CY
from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.ib_band import pad_band

# wall fix-ups (LatticeBoltzmann.cu:328-353): (destination, source) of the
# same cell's f1
BOTTOM_PAIRS = ((2, 4), (5, 7), (6, 8))            # halfway bounce-back
TOP_PAIRS = {"slip": ((4, 2), (8, 5), (7, 6)),     # specular
             "noslip": ((4, 2), (7, 5), (8, 6))}   # bounce-back


def _emit(planes, band, flux_x, storage):
    """(q, fluxcol) from post-stream planes, in the kernel's summation
    order."""
    fsum = planes[0]
    for d in range(1, 9):
        fsum = fsum + planes[d]
    rho = 1.0 + fsum if storage == "deviatoric" else fsum
    p = planes
    mom_x = p[1] - p[3] + p[5] - p[6] - p[7] + p[8]
    mom_y = p[2] - p[4] + p[5] + p[6] - p[7] - p[8]
    q = torch.stack([rho[:band], mom_x[:band], mom_y[:band]])
    fluxcol = torch.stack([rho[:, flux_x], mom_x[:, flux_x]])
    return q, fluxcol


def _into(out, t):
    """t, copied into ``out`` when one is given (the buffer the caller
    preallocated, as for the kernel)."""
    return t if out is None else out.copy_(t)


def fused_substep_reference(f, force_band, cfg, walls=ref.REFERENCE_WALLS,
                            forcing="trt_split", storage="raw", out=None):
    """Plain torch version: collide (ops/reference.py) in >= f32, stream
    with walls, then the band moments and the flux column; f_new goes into
    ``out`` when given."""
    cdt = torch.promote_types(f.dtype, torch.float32)
    force = pad_band(force_band.to(cdt), f.shape[1])
    f1 = ref.collide_rows(f.to(cdt), force, cfg.tau, cfg.tau2, forcing,
                          storage)
    planes = ref.stream(f1, walls)
    q, fluxcol = _emit(planes, force_band.shape[1], cfg.flux_x, storage)
    return _into(out, planes.to(f.dtype)), q, fluxcol


def _check(f, force_band, cfg, walls, forcing, storage, out):
    _kernels.check_scheme(f.dtype, walls, forcing, storage, "fused_step")
    ydim, xdim = cfg.ydim, cfg.xdim
    if ydim < 3:
        raise ValueError(f"fused_step kernel needs ydim >= 3, got {ydim}")
    if not 0 <= cfg.flux_x < xdim:
        raise ValueError(f"flux_x {cfg.flux_x} outside [0, {xdim})")
    _kernels.check_tensor("f", f, (9, ydim, xdim), f.dtype, f.device)
    _kernels.check_tensor("force", force_band, (2, cfg.force_band, xdim),
                          aux_dtype(f.dtype), f.device)
    if out is not None:
        _kernels.check_tensor("out", out, f.shape, f.dtype, f.device)
        _kernels.check_disjoint("out", out, "f", f)


def fused_substep(f, force_band, cfg, walls=ref.REFERENCE_WALLS,
                  forcing="trt_split", storage="raw", out=None):
    """(f_new, q, fluxcol) for one step.  CUDA tensors launch the hand
    kernel, writing f_new into ``out`` when given (a buffer distinct from
    f: the caller swaps the two); CPU tensors take the plain version.
    Under bf16 storage f and f_new are bf16 and the force, q and fluxcol
    float32."""
    if f.device.type == "cpu":
        return fused_substep_reference(f, force_band, cfg, walls, forcing,
                                       storage, out)
    if f.device.type != "cuda":
        raise ValueError(f"fused_substep: unsupported device {f.device}")
    _check(f, force_band, cfg, walls, forcing, storage, out)
    ydim, xdim, band = cfg.ydim, cfg.xdim, cfg.force_band
    if out is None:
        out = torch.empty_like(f)
    cdt = aux_dtype(f.dtype)
    q = torch.empty((3, band, xdim), dtype=cdt, device=f.device)
    fluxcol = torch.empty((2, ydim), dtype=cdt, device=f.device)
    _kernels.launch(
        "iblb_fused_step", f.dtype, f.device, f.data_ptr(),
        force_band.data_ptr(), out.data_ptr(), q.data_ptr(),
        fluxcol.data_ptr(), ydim, xdim, band, cfg.flux_x, float(cfg.tau),
        float(cfg.tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"), int(walls.top == "noslip"))
    fused_substep.launches += 1
    return out, q, fluxcol


# Kernel launches since the last reset (the CPU path does not count).
fused_substep.launches = 0


# --- B3: the step on a row block ----------------------------------------

def stream_block(f1, bhalo, thalo):
    """Pull-stream of a row block: row r takes f1[d](r - cy, x - cx), x
    periodic; the rows below and above the block are bhalo and thalo
    ([9, X] each, post-collision).  No wall fix-ups."""
    rows = f1.shape[1]
    ext = torch.cat([bhalo[:, None], f1, thalo[:, None]], dim=1)
    return torch.stack([
        torch.roll(ext[d, 1 - int(CY[d]):1 - int(CY[d]) + rows],
                   int(CX[d]), dims=1)
        for d in range(9)])


def sharded_fused_substep_reference(flags, f_loc, force_band, bhalo, thalo,
                                    cfg, walls=ref.REFERENCE_WALLS,
                                    forcing="trt_split", storage="raw",
                                    expose_row=None, emit_moments=False,
                                    out=None, f1out=None):
    """Plain torch version of B3, in >= f32.  flags = (y0, is_bottom,
    is_top): local row r is global row y0 + r, forced iff y0 + r < band
    (force_band holds the global band rows; None for a force-free block);
    bhalo / thalo ([9, X], None for zeros) are pulled across the block's
    bottom / top edge where no wall is flagged.  Returns (f_new, f1row, q,
    fluxcol): f1row the post-collision f1 of local row expose_row ([9, X],
    None unless asked), and with emit_moments q [3, band, X] over local
    rows < band and fluxcol [2, rows] (else None).  f_new and f1row go
    into ``out`` and ``f1out`` when given."""
    y0, is_bottom, is_top = (int(v) for v in flags)
    cdt = torch.promote_types(f_loc.dtype, torch.float32)
    _, rows, xdim = f_loc.shape
    force = torch.zeros((2, rows, xdim), dtype=cdt, device=f_loc.device)
    if force_band is not None:
        n = min(max(force_band.shape[1] - y0, 0), rows)
        force[:, :n] = force_band[:, y0:y0 + n].to(cdt)
    f1 = ref.collide_rows(f_loc.to(cdt), force, cfg.tau, cfg.tau2, forcing,
                          storage)
    zero = f1.new_zeros((9, xdim))
    planes = stream_block(f1, zero if bhalo is None else bhalo.to(cdt),
                          zero if thalo is None else thalo.to(cdt))
    if is_bottom:
        for dst, src in BOTTOM_PAIRS:
            planes[dst, 0] = f1[src, 0]
    if is_top:
        for dst, src in TOP_PAIRS[walls.top]:
            planes[dst, rows - 1] = f1[src, rows - 1]
    f1row = None
    if expose_row is not None:
        f1row = _into(f1out, f1[:, expose_row].clone())
    q = fluxcol = None
    if emit_moments:
        q, fluxcol = _emit(planes, cfg.force_band, cfg.flux_x, storage)
    return _into(out, planes.to(f_loc.dtype)), f1row, q, fluxcol


def sharded_fused_substep(flags, f_loc, force_band, bhalo, thalo, cfg,
                          walls=ref.REFERENCE_WALLS, forcing="trt_split",
                          storage="raw", expose_row=None,
                          emit_moments=False, out=None, f1out=None):
    """B3: (f_new, f1row, q, fluxcol) as sharded_fused_substep_reference
    returns them.  CUDA tensors launch the hand kernel: f_loc and ``out``
    may be row ranges of larger states (contiguous rows), and must not
    overlap; the exposed row goes into ``f1out`` ([9, X]) when given.  The
    block's width X may be an x-shard's xl < XDIM (the force then holds the
    shard's columns): the x-roll wraps the block, and the caller repairs
    its two edge columns (parallel/sharded.py, _patch_x_seams).  Under
    bf16 storage f_loc and ``out`` are bf16 and the force, the halos, the
    exposed row, q and fluxcol float32.  CPU tensors take the plain
    version."""
    if f_loc.device.type == "cpu":
        return sharded_fused_substep_reference(
            flags, f_loc, force_band, bhalo, thalo, cfg, walls, forcing,
            storage, expose_row, emit_moments, out, f1out)
    if f_loc.device.type != "cuda":
        raise ValueError(f"sharded_fused_substep: unsupported device "
                         f"{f_loc.device}")
    dt, dev = f_loc.dtype, f_loc.device
    _kernels.check_scheme(dt, walls, forcing, storage, "sharded_fused_step")
    cdt = aux_dtype(dt)
    y0, is_bottom, is_top = (int(v) for v in flags)
    _, rows, xdim = f_loc.shape
    band = cfg.force_band
    _kernels.check_planes("f_loc", f_loc, (9, rows, xdim), dt, dev)
    if force_band is not None:
        _kernels.check_tensor("force", force_band, (2, band, xdim), cdt, dev)
    for name, h in (("bhalo", bhalo), ("thalo", thalo), ("f1out", f1out)):
        if h is not None:
            _kernels.check_tensor(name, h, (9, xdim), cdt, dev)
    if expose_row is not None and not 0 <= expose_row < rows:
        raise ValueError("expose_f1_row outside the local block")
    if emit_moments and (y0 != 0 or rows < band or xdim != cfg.xdim):
        raise ValueError("emit_moments needs a y0 = 0 block holding the "
                         "whole band at the domain's width")
    if out is None:
        out = torch.empty((9, rows, xdim), dtype=dt, device=dev)
    _kernels.check_planes("out", out, (9, rows, xdim), dt, dev)
    _kernels.check_disjoint("out", out, "f_loc", f_loc)
    if expose_row is not None and f1out is None:
        f1out = torch.empty((9, xdim), dtype=cdt, device=dev)
    q = fluxcol = None
    if emit_moments:
        q = torch.empty((3, band, xdim), dtype=cdt, device=dev)
        fluxcol = torch.empty((2, rows), dtype=cdt, device=dev)
    _kernels.launch(
        "iblb_sharded_step", dt, dev, f_loc.data_ptr(), f_loc.stride(0),
        out.data_ptr(), out.stride(0), _kernels.ptr(force_band),
        _kernels.ptr(bhalo), _kernels.ptr(thalo),
        _kernels.ptr(f1out if expose_row is not None else None),
        _kernels.ptr(q), _kernels.ptr(fluxcol), rows, xdim, band, y0,
        is_bottom, is_top, -1 if expose_row is None else expose_row,
        band if emit_moments else 0, cfg.flux_x, float(cfg.tau),
        float(cfg.tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"), int(walls.top == "noslip"))
    sharded_fused_substep.launches += 1
    return out, (f1out if expose_row is not None else None), q, fluxcol


sharded_fused_substep.launches = 0
