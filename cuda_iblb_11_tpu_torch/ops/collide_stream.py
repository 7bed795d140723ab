"""Collide + pull-stream without emission: B2h, the port's emission-free
step entry.  It ports make_fused_substep(pipeline=False)
(cuda_iblb_11_tpu/ops/pallas_step.py:444, kernel _collide_stream_kernel
:75, call :583) and, since the two compute the same function,
make_fused_substep(pipeline=True, emit_moments=False), which the JAX
model's strict-parity quirk mode builds (models/mucociliary.py:186-192).

``collide_stream`` is the wrapper: for CUDA tensors it launches the hand
kernel of csrc/fused_step.cu (the step kernel of csrc/step.cuh without its
emission code) or raises; for CPU tensors it calls
``collide_stream_reference``, ``stream(collide_rows(...))`` of
ops/reference.py, the function tests/test_pallas.py:72-83 holds the JAX
kernel against.  The force holds rows [0, band) with band <= Y (band = Y
for the validation channel's body force), zero above; walls: periodic x,
bottom no-slip, top slip or no-slip.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.ib_band import pad_band


def collide_stream_reference(f, force, tau, tau2, walls=ref.REFERENCE_WALLS,
                             forcing="trt_split", storage="raw", out=None):
    """Plain torch version, in >= f32: collide with the band force padded
    with zeros to Y rows, then stream with walls; into ``out`` when
    given."""
    cdt = torch.promote_types(f.dtype, torch.float32)
    f1 = ref.collide_rows(f.to(cdt), pad_band(force.to(cdt), f.shape[1]),
                          tau, tau2, forcing, storage)
    planes = ref.stream(f1, walls).to(f.dtype)
    return planes if out is None else out.copy_(planes)


def collide_stream(f, force, tau, tau2, walls=ref.REFERENCE_WALLS,
                   forcing="trt_split", storage="raw", out=None):
    """f_new for one step.  CUDA tensors launch the hand kernel, writing
    into ``out`` when given (a buffer distinct from f: the caller swaps the
    two); under bf16 storage f and ``out`` are bf16 and the force float32.
    CPU tensors take the plain version."""
    if f.device.type == "cpu":
        return collide_stream_reference(f, force, tau, tau2, walls, forcing,
                                         storage, out)
    if f.device.type != "cuda":
        raise ValueError(f"collide_stream: unsupported device {f.device}")
    _kernels.check_scheme(f.dtype, walls, forcing, storage, "collide_stream")
    _, ydim, xdim = f.shape
    if ydim < 3:
        raise ValueError(f"collide_stream kernel needs ydim >= 3, got {ydim}")
    band = force.shape[1] if force.dim() == 3 else 0
    if not 1 <= band <= ydim:
        raise ValueError(f"force band {band} outside [1, {ydim}]")
    _kernels.check_tensor("f", f, (9, ydim, xdim), f.dtype, f.device)
    _kernels.check_tensor("force", force, (2, band, xdim),
                          aux_dtype(f.dtype), f.device)
    if out is None:
        out = torch.empty_like(f)
    _kernels.check_tensor("out", out, f.shape, f.dtype, f.device)
    _kernels.check_disjoint("out", out, "f", f)
    _kernels.launch(
        "iblb_collide_stream", f.dtype, f.device, f.data_ptr(),
        force.data_ptr(), out.data_ptr(), ydim, xdim, band, float(tau),
        float(tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"), int(walls.top == "noslip"))
    collide_stream.launches += 1
    return out


# Kernel launches since the last reset (the CPU path does not count).
collide_stream.launches = 0
