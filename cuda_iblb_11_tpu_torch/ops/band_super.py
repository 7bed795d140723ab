"""B5: the resident-band super-step — the port of make_band_super_substep
(cuda_iblb_11_tpu/ops/pallas_step.py:1509, built by _build_band_super_call
:1411, kernel _band_super_kernel :1085, the whole-domain fold=True layout).

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

from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    BOTTOM_PAIRS, _emit, _into, stream_block,
)
from cuda_iblb_11_tpu_torch.ops.ib import delta_1d

NPT = 128   # points per cilium block


def band_super_reference(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
                         walls=ref.REFERENCE_WALLS, forcing="trt_split",
                         storage="raw", out=None):
    """Plain torch version, transcribed from _band_super_kernel: the IB
    coupling as dense per-cilium window contractions (a [3 band, W] x
    [W, 128] interpolation and a [2 band, 128] x [128, W] spread), the
    windows overlap-added on a strip padded by `halo` columns each side
    and folded periodically; everything in >= f32.  f_band goes into
    ``out`` when given."""
    K = us.shape[0]
    band, xdim, cw = cfg.force_band, cfg.xdim, cfg.c_space
    rows = f_ext.shape[1]
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
        # overwritten by the wall, the top ghost row is garbage
        f = stream_block(f1, f1[:, 0], f1[:, rows - 1])
        for dst, src in BOTTOM_PAIRS:
            f[dst, 0] = f1[src, 0]
        q, _ = _emit(f, band, cfg.flux_x, storage)           # [3, band, X]
        qpad = torch.cat([q[..., xdim - halo:], q, q[..., :halo]], dim=-1)
        fpad = torch.zeros((2, band, xdim + 2 * halo), dtype=cdt, device=dev)
        for m in range(cfg.c_num):
            dy = delta_1d((yy - ay[s, m][None]).to(cdt)
                          - fy[s, m][None].to(cdt))           # [band, 128]
            dxw = delta_1d((ww - axl[s, m][:, None]).to(cdt)
                           - fx[s, m][:, None].to(cdt))       # [128, W]
            lo = m * cw
            # [3, band, 128]
            t2 = torch.matmul(qpad[:, :, lo:lo + wwin], dxw.T)
            iq = (dy[None] * t2).sum(1)                          # [3, 128]
            em = eps[s, m].to(cdt)
            a_x = (2.0 * (us[s, 0, m].to(cdt) * iq[0] - iq[1])) * em
            a_y = (2.0 * (us[s, 1, m].to(cdt) * iq[0] - iq[2])) * em
            sxy = torch.matmul(torch.stack([dy * a_x, dy * a_y]), dxw)
            fpad[:, :, lo:lo + wwin] += sxy                     # [2, band, W]
        fo = fpad[:, :, halo:halo + xdim].clone()
        fo[..., :halo] += fpad[..., halo + xdim:]   # right end wraps left
        fo[..., xdim - halo:] += fpad[..., :halo]   # left end wraps right
        c = cfg.flux_x
        flux.append(((q[1, :, c] + 0.5 * fo[0, :, c]) / q[0, :, c]).sum())
    return (_into(out, f[:, :band].to(f_ext.dtype)), torch.stack(bhalos), fo,
            torch.stack(flux))


def band_super(f_ext, force, us, eps, axl, fx, ay, fy, cfg, halo,
               walls=ref.REFERENCE_WALLS, forcing="trt_split", storage="raw",
               out=None):
    """(f_band, bhalos, force_new, flux).  CUDA tensors launch the hand
    kernel: f_ext and ``out`` ([9, band, X]) may be row ranges of larger
    states (contiguous rows) and must not overlap.  CPU tensors take the
    plain version."""
    if f_ext.device.type == "cpu":
        return band_super_reference(f_ext, force, us, eps, axl, fx, ay, fy,
                                    cfg, halo, walls, forcing, storage, out)
    if f_ext.device.type != "cuda":
        raise ValueError(f"band_super: unsupported device {f_ext.device}")
    dt, dev = f_ext.dtype, f_ext.device
    _kernels.check_scheme(dt, walls, forcing, storage, "band_super")
    band, xdim, c = cfg.force_band, cfg.xdim, cfg.c_num
    if us.dim() != 4 or us.shape[0] < 1:
        raise ValueError(f"us must be [K, 2, c, 128], got {tuple(us.shape)}")
    K = us.shape[0]
    rows = f_ext.shape[1]
    if rows - band < K:
        raise ValueError(f"ghost pad {rows - band} must cover K={K} "
                         "sub-steps")
    if cfg.c_space + 2 * halo > xdim or halo < 0:
        raise ValueError("cilium window exceeds the domain width")
    if not 0 <= cfg.flux_x < xdim:
        raise ValueError(f"flux_x {cfg.flux_x} outside [0, {xdim})")
    _kernels.check_planes("f_ext", f_ext, (9, rows, xdim), dt, dev)
    _kernels.check_tensor("force", force, (2, band, xdim), dt, dev)
    _kernels.check_tensor("us", us, (K, 2, c, NPT), dt, dev)
    for name, t, tdt in (("eps", eps, dt), ("axl", axl, torch.int32),
                         ("fx", fx, dt), ("ay", ay, torch.int32),
                         ("fy", fy, dt)):
        _kernels.check_tensor(name, t, (K, c, NPT), tdt, dev)
    if out is None:
        out = torch.empty((9, band, xdim), dtype=dt, device=dev)
    _kernels.check_planes("out", out, (9, band, xdim), dt, dev)
    _kernels.check_disjoint("out", out, "f_ext", f_ext)
    bufs = [torch.empty((9, rows, xdim), dtype=dt, device=dev)
            if K > 1 + i else None for i in range(2)]
    bhalos = torch.empty((K, 9, xdim), dtype=dt, device=dev)
    force_new = torch.empty((2, band, xdim), dtype=dt, device=dev)
    q = torch.empty((3, band, xdim), dtype=dt, device=dev)
    amp = torch.empty((2, c, NPT), dtype=dt, device=dev)
    colbuf = torch.empty((K, band), dtype=dt, device=dev)
    flux = torch.empty((K,), dtype=dt, device=dev)
    _kernels.launch(
        "iblb_band_super", dt, dev, f_ext.data_ptr(), f_ext.stride(0),
        out.data_ptr(), out.stride(0), force.data_ptr(),
        force_new.data_ptr(), us.data_ptr(), eps.data_ptr(), axl.data_ptr(),
        fx.data_ptr(), ay.data_ptr(), fy.data_ptr(), bhalos.data_ptr(),
        _kernels.ptr(bufs[0]), _kernels.ptr(bufs[1]), q.data_ptr(),
        amp.data_ptr(), colbuf.data_ptr(), flux.data_ptr(), rows, band,
        xdim, K, c, cfg.c_space, halo, cfg.flux_x, float(cfg.tau),
        float(cfg.tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"))
    band_super.launches += 1
    return out, bhalos, force_new, flux


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
band_super.launches = 0
