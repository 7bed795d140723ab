"""One fused collide + pull-stream step with band-moment and flux-column
emission — the port of make_fused_substep(pipeline=True, emit_moments=True)
(cuda_iblb_11_tpu/ops/pallas_step.py:444, kernel _pipelined_kernel :181,
collide _collide_tile :642).

``fused_substep`` is the wrapper: for CUDA tensors it launches the hand
kernel csrc/fused_step.cu (or raises); for CPU tensors it calls
``fused_substep_reference``, the plain torch version built from
ops/reference.py.  Both return

    f_new    [9, Y, X]     the streamed state (storage dtype)
    q        [3, band, X]  post-stream (rho, mom_x, mom_y) over the force band
    fluxcol  [2, Y]        post-stream (rho, mom_x) at x = cfg.flux_x

with the storage adjustment (rho = 1 + sum f in deviatoric storage) applied.
The JAX kernel pads fluxcol to 128 lanes; the port keeps the column only.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.ib_band import pad_band


def _emit(planes, band, flux_x, storage):
    """(q, fluxcol) from post-stream planes, in the kernel's summation order."""
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


def fused_substep_reference(f, force_band, cfg, walls=ref.REFERENCE_WALLS,
                            forcing="trt_split", storage="raw"):
    """Plain torch version: collide (ops/reference.py) in >= f32, stream
    with walls, then the band moments and the flux column."""
    cdt = torch.promote_types(f.dtype, torch.float32)
    force = pad_band(force_band.to(cdt), f.shape[1])
    f1 = ref.collide_rows(f.to(cdt), force, cfg.tau, cfg.tau2, forcing,
                          storage)
    planes = ref.stream(f1, walls)
    q, fluxcol = _emit(planes, force_band.shape[1], cfg.flux_x, storage)
    return planes.to(f.dtype), q, fluxcol


def _check(f, force_band, cfg, walls, forcing, storage, out):
    if f.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"fused_step kernel takes float32/float64 f, got {f.dtype} "
            "(bf16 storage: ROADMAP Queue 1 item 2)")
    if walls.left != "periodic" or walls.bottom != "noslip" \
            or walls.top not in ("slip", "noslip"):
        raise NotImplementedError(
            "fused_step kernel supports periodic x, bottom noslip, top "
            f"slip|noslip; got {walls}")
    if forcing not in ("trt_split", "reference"):
        raise ValueError(f"unknown forcing scheme {forcing!r}")
    if storage not in ("raw", "deviatoric"):
        raise ValueError(f"unknown storage {storage!r}")
    ydim, xdim = cfg.ydim, cfg.xdim
    band = cfg.force_band
    if ydim < 3:
        raise ValueError(f"fused_step kernel needs ydim >= 3, got {ydim}")
    if tuple(f.shape) != (9, ydim, xdim):
        raise ValueError(f"f shape {tuple(f.shape)} != (9, {ydim}, {xdim})")
    if tuple(force_band.shape) != (2, band, xdim):
        raise ValueError(f"force shape {tuple(force_band.shape)} != "
                         f"(2, {band}, {xdim})")
    if force_band.dtype != f.dtype:
        raise ValueError(f"force dtype {force_band.dtype} != f dtype {f.dtype}")
    if not 0 <= cfg.flux_x < xdim:
        raise ValueError(f"flux_x {cfg.flux_x} outside [0, {xdim})")
    tensors = [("f", f), ("force", force_band)]
    if out is not None:
        tensors.append(("out", out))
        if out.shape != f.shape or out.dtype != f.dtype:
            raise ValueError("out must match f in shape and dtype")
        if out.data_ptr() == f.data_ptr():
            raise ValueError("out must not alias f: the kernel reads f "
                             "while other blocks write out")
    for name, t in tensors:
        if t.device != f.device:
            raise ValueError(f"{name} is on {t.device}, f on {f.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_substep(f, force_band, cfg, walls=ref.REFERENCE_WALLS,
                  forcing="trt_split", storage="raw", out=None):
    """(f_new, q, fluxcol) for one step.  CUDA tensors launch the hand
    kernel, writing f_new into ``out`` when given (a buffer distinct from
    f: the caller swaps the two); CPU tensors take the plain version."""
    if f.device.type == "cpu":
        return fused_substep_reference(f, force_band, cfg, walls, forcing,
                                       storage)
    if f.device.type != "cuda":
        raise ValueError(f"fused_substep: unsupported device {f.device}")
    _check(f, force_band, cfg, walls, forcing, storage, out)
    lib = _kernels.load()
    ydim, xdim, band = cfg.ydim, cfg.xdim, cfg.force_band
    if out is None:
        out = torch.empty_like(f)
    q = torch.empty((3, band, xdim), dtype=f.dtype, device=f.device)
    fluxcol = torch.empty((2, ydim), dtype=f.dtype, device=f.device)
    fn = (lib.lib.iblb_fused_step_f32 if f.dtype == torch.float32
          else lib.lib.iblb_fused_step_f64)
    # the C entry launches on the current device; this sets it to f's and
    # restores the caller's afterwards
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = fn(f.data_ptr(), force_band.data_ptr(), out.data_ptr(),
                 q.data_ptr(), fluxcol.data_ptr(), ydim, xdim, band,
                 cfg.flux_x, float(cfg.tau), float(cfg.tau2),
                 int(forcing == "trt_split"), int(storage == "deviatoric"),
                 int(walls.top == "noslip"), stream)
    lib.check(err, "fused_step launch")
    fused_substep.launches += 1
    return out, q, fluxcol


# Kernel launches since the last reset (the CPU path does not count).
fused_substep.launches = 0
