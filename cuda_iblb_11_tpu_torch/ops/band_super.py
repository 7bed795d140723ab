"""B5: the resident-band super-step — the port of make_band_super_substep
(cuda_iblb_11_tpu/ops/pallas_step.py:1509, built by _build_band_super_call
:1411, kernel _band_super_kernel :1085, the whole-domain fold=True layout;
ops/band_super_tiled.py runs the same kernel on x-tiles, B6).

    band_super(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo, ...)
        -> (f_band, bhalos, force_new, flux)

f_ext [9, band + pad_s, X] is the band plus a ghost pad (pad_s >= K rows
copied from the bulk bottom); force [2, band, X] the IB force of the step
before.  The points come in the layout of
models/mucociliary.prep_band_super_points, one 128-point block per cilium
(nodes padded with inert points): us [K, 2, c, 128], eps, fx, fy
[K, c, 128], and int32 axl (the window-local anchor x: anchor_x -
(m c_space - halo)) and ay [K, c, 128].  Each of the K sub-steps collides
(force below the band only), exposes the f1 of row band-1 (bhalos [K, 9,
X], the bulk's seam halo), streams with bottom bounce-back, takes the band
moments, runs the IB coupling over each cilium's window of W = c_space +
2 halo columns (periodic), and takes the half-force corrected flux column
(flux [K], raw sums over the band rows; the caller divides by 192).

``band_super`` launches csrc/band_super.cu for CUDA tensors (or raises)
and calls ``band_super_reference`` for CPU tensors.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    BOTTOM_PAIRS, _emit, _into, stream_block,
)
from cuda_iblb_11_tpu_torch.ops.ib import delta_1d
from cuda_iblb_11_tpu_torch.ops.precision import full_f32

NPT = 128   # points per cilium block


@full_f32()
def band_super_block(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
                     walls=ref.REFERENCE_WALLS, forcing="trt_split",
                     storage="raw", win_lo0=None, flux_x=None, wwin=None):
    """Plain torch version of _band_super_kernel on one block of
    f_ext.shape[-1] columns, transcribed from it: the IB coupling as dense
    per-window contractions (a [3 band, W] x [W, 128] interpolation and a
    [2 band, 128] x [128, W] spread per point block), everything in >= f32.

    win_lo0 None is the whole-domain (fold=True) layout: block m's window
    starts at m c_space - halo, the windows are overlap-added on a strip
    padded by `halo` columns each side and folded periodically.  An int is
    the tile (fold=False) layout: block j's window starts at win_lo0 +
    j c_space inside the block, and the strip is the block.  flux_x is the
    flux column in block coordinates, or None (no flux: a tile that does
    not own it).  wwin is the window width, c_space + 2 halo unless given
    (B8's phase-general layout widens it by c_space).  Returns (f_band,
    bhalos, force, flux or None), f_band in the compute dtype."""
    K = us.shape[0]
    band, cw = cfg.force_band, cfg.c_space
    rows, xdim = f_ext.shape[1], f_ext.shape[2]
    fold = win_lo0 is None
    if wwin is None:
        wwin = cw + 2 * halo
    cdt = torch.promote_types(f_ext.dtype, torch.float32)
    dev = f_ext.device
    f = f_ext.to(cdt)
    fo = force.to(cdt)
    yy = torch.arange(band, dtype=torch.int32, device=dev)[:, None]
    ww = torch.arange(wwin, dtype=torch.int32, device=dev)[None, :]
    bhalos, flux = [], []
    for s in range(K):
        frc = torch.zeros((2, rows, xdim), dtype=cdt, device=dev)
        frc[:, :band] = fo
        f1 = ref.collide_rows(f, frc, cfg.tau, cfg.tau2, forcing, storage)
        bhalos.append(f1[:, band - 1])
        # the edge rows pull themselves: row 0's up-going values are
        # overwritten by the wall, the top ghost row is garbage; x rolls
        # within the block (on a tile, garbage the ghost columns absorb)
        f = stream_block(f1, f1[:, 0], f1[:, rows - 1])
        for dst, src in BOTTOM_PAIRS:
            f[dst, 0] = f1[src, 0]
        q, _ = _emit(f, band, 0, storage)                    # [3, band, X]
        if fold:
            q = torch.cat([q[..., xdim - halo:], q, q[..., :halo]], dim=-1)
            fpad = torch.zeros((2, band, xdim + 2 * halo), dtype=cdt,
                               device=dev)
        else:
            fpad = torch.zeros((2, band, xdim), dtype=cdt, device=dev)
        for m in range(us.shape[2]):
            dy = delta_1d((yy - ay[s, m][None]).to(cdt)
                          - fy[s, m][None].to(cdt))           # [band, 128]
            dxw = delta_1d((ww - axl[s, m][:, None]).to(cdt)
                           - fx[s, m][:, None].to(cdt))       # [128, W]
            lo = m * cw + (0 if fold else win_lo0)
            # [3, band, 128]
            t2 = torch.matmul(q[:, :, lo:lo + wwin], dxw.T)
            iq = (dy[None] * t2).sum(1)                          # [3, 128]
            em = eps[s, m].to(cdt)
            a_x = (2.0 * (us[s, 0, m].to(cdt) * iq[0] - iq[1])) * em
            a_y = (2.0 * (us[s, 1, m].to(cdt) * iq[0] - iq[2])) * em
            sxy = torch.matmul(torch.stack([dy * a_x, dy * a_y]), dxw)
            fpad[:, :, lo:lo + wwin] += sxy                     # [2, band, W]
        if fold:
            fo = fpad[:, :, halo:halo + xdim].clone()
            fo[..., :halo] += fpad[..., halo + xdim:]   # right end wraps left
            fo[..., xdim - halo:] += fpad[..., :halo]   # left end wraps right
        else:
            fo = fpad
        if flux_x is not None:
            qc = q[:, :, flux_x + (halo if fold else 0)]
            flux.append(((qc[1] + 0.5 * fo[0, :, flux_x]) / qc[0]).sum())
    return (f[:, :band], torch.stack(bhalos), fo,
            torch.stack(flux) if flux_x is not None else None)


def band_super_reference(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
                         walls=ref.REFERENCE_WALLS, forcing="trt_split",
                         storage="raw", out=None):
    """Plain torch version of B5: band_super_block on the whole domain
    (fold=True, the flux at cfg.flux_x); f_band goes into ``out`` when
    given."""
    f_band, bhalos, fo, flux = band_super_block(
        f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo, walls, forcing,
        storage, None, cfg.flux_x)
    return _into(out, f_band.to(f_ext.dtype)), bhalos, fo, flux


def check_points(pts, K, c, dtype, device):
    """pts = (us, eps, axl, fx, ay, fy) are c point blocks of K sub-steps:
    us [K, 2, c, 128], the others [K, c, 128], the anchors int32 and the
    rest ``dtype`` (the compute type: float32 under bf16 storage)."""
    _kernels.check_tensor("us", pts[0], (K, 2, c, NPT), dtype, device)
    for name, t, tdt in zip(("eps", "axl", "fx", "ay", "fy"), pts[1:],
                            (dtype, torch.int32, dtype, torch.int32, dtype)):
        _kernels.check_tensor(name, t, (K, c, NPT), tdt, device)


def launch_band_super(f_ext, force, pts, cfg, wwin, win_lo0, flux_x, walls,
                      forcing, storage, what, out=None):
    """Check the inputs and launch csrc/band_super.cu once on CUDA tensors,
    on a block of W = f_ext.shape[-1] columns: f_ext [9, band + pad, W],
    force [2, band, W], pts = (us, eps, axl, fx, ay, fy) the block's c
    point blocks; window j starts at block column win_lo0 + j c_space and
    is wwin wide; flux_x is the flux column in block columns, or None (no
    flux).  f_ext and ``out`` ([9, band, W]) may be row ranges of larger
    states and must not overlap.  Returns (f_band, bhalos, force_new, flux
    or None).  B5, B6 and B8 call it with their layouts.  Under bf16
    storage f_ext and ``out`` are bf16 and everything else float32: the
    force, the points, the outputs and the two resident buffers, so the
    band rounds once per call, not once per sub-step."""
    dt, dev = f_ext.dtype, f_ext.device
    _kernels.check_scheme(dt, walls, forcing, storage, what)
    cdt = aux_dtype(dt)
    us = pts[0]
    if us.dim() != 4 or us.shape[0] < 1:
        raise ValueError(f"us must be [K, 2, c, 128], got {tuple(us.shape)}")
    K, c = us.shape[0], us.shape[2]
    band = cfg.force_band
    _, rows, width = f_ext.shape
    if rows - band < K:
        raise ValueError(f"ghost pad {rows - band} must cover K={K} "
                         "sub-steps")
    if flux_x is not None and not 0 <= flux_x < width:
        raise ValueError(f"flux_x {flux_x} outside [0, {width})")
    _kernels.check_planes("f_ext", f_ext, (9, rows, width), dt, dev)
    _kernels.check_tensor("force", force, (2, band, width), cdt, dev)
    check_points(pts, K, c, cdt, dev)
    if out is None:
        out = torch.empty((9, band, width), dtype=dt, device=dev)
    _kernels.check_planes("out", out, (9, band, width), dt, dev)
    _kernels.check_disjoint("out", out, "f_ext", f_ext)
    bufs = [torch.empty((9, rows, width), dtype=cdt, device=dev)
            if K > 1 + i else None for i in range(2)]
    bhalos = torch.empty((K, 9, width), dtype=cdt, device=dev)
    force_new = torch.empty((2, band, width), dtype=cdt, device=dev)
    q = torch.empty((3, band, width), dtype=cdt, device=dev)
    amp = torch.empty((2, c, NPT), dtype=cdt, device=dev)
    colbuf = flux = None
    if flux_x is not None:
        colbuf = torch.empty((K, band), dtype=cdt, device=dev)
        flux = torch.empty((K,), dtype=cdt, device=dev)
    _kernels.launch(
        "iblb_band_super", dt, dev, f_ext.data_ptr(), f_ext.stride(0),
        out.data_ptr(), out.stride(0), force.data_ptr(),
        force_new.data_ptr(), *(t.data_ptr() for t in pts),
        bhalos.data_ptr(), _kernels.ptr(bufs[0]), _kernels.ptr(bufs[1]),
        q.data_ptr(), amp.data_ptr(), _kernels.ptr(colbuf),
        _kernels.ptr(flux), rows, band, width, K, c, cfg.c_space, wwin,
        win_lo0, -1 if flux_x is None else flux_x, float(cfg.tau),
        float(cfg.tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"))
    return out, bhalos, force_new, flux


def band_super(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
               walls=ref.REFERENCE_WALLS, forcing="trt_split", storage="raw",
               out=None):
    """(f_band, bhalos, force_new, flux).  CUDA tensors launch the hand
    kernel (launch_band_super, the whole-domain layout): f_ext and ``out``
    ([9, band, X]) may be row ranges of larger states (contiguous rows)
    and must not overlap.  CPU tensors take the plain version."""
    if f_ext.device.type == "cpu":
        return band_super_reference(f_ext, force, us, eps, axl, fx, ay, fy,
                                    cfg, halo, walls, forcing, storage, out)
    if f_ext.device.type != "cuda":
        raise ValueError(f"band_super: unsupported device {f_ext.device}")
    if cfg.c_space + 2 * halo > cfg.xdim or halo < 0:
        raise ValueError("cilium window exceeds the domain width")
    if f_ext.shape[-1] != cfg.xdim or us.dim() != 4 \
            or us.shape[2] != cfg.c_num:
        raise ValueError(f"band_super takes the whole domain's columns and "
                         f"cilia: f_ext {tuple(f_ext.shape)}, us "
                         f"{tuple(us.shape)}")
    res = launch_band_super(f_ext, force, (us, eps, axl, fx, ay, fy), cfg,
                            cfg.c_space + 2 * halo, -halo, cfg.flux_x, walls,
                            forcing, storage, "band_super", out)
    band_super.launches += 1
    return res


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
band_super.launches = 0
