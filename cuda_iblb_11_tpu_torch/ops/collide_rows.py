"""B0: collide only, on a slab — the port of make_collide_rows_kernel
(cuda_iblb_11_tpu/ops/pallas_step.py:742, call :775).

    collide_rows(f, force, cfg, forcing, storage) -> f1

f [9, n, m] and force [2, n, m] give f1 [9, n, m], the post-collision
values of each cell (no streaming).  The sharded path computes the f1 it
hands its neighbours with it: the edge lines of each shard and the seam
columns of the band block (parallel/sharded.py), where the JAX package
collides in XLA (ops/reference.collide_rows).  On the card those values
must round as the step kernels round (csrc/collide_rows.cu says why), so
they come from the same collide_cell.

``collide_rows`` launches csrc/collide_rows.cu for CUDA tensors (or
raises): f and force may be strided views (an edge row or column of a
shard's state is read in place).  For CPU tensors it calls
``collide_rows_reference``, the plain torch version of ops/reference.py.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref


def collide_rows_reference(f, force, cfg, forcing="trt_split",
                           storage="raw"):
    """Plain torch version: ops/reference.collide_rows in >= f32."""
    cdt = torch.promote_types(f.dtype, torch.float32)
    return ref.collide_rows(f.to(cdt), force.to(cdt), cfg.tau, cfg.tau2,
                            forcing, storage)


def collide_rows(f, force, cfg, forcing="trt_split", storage="raw"):
    """f1 [9, n, m], contiguous.  CUDA tensors launch the hand kernel;
    CPU tensors take the plain version."""
    if f.device.type == "cpu":
        return collide_rows_reference(f, force, cfg, forcing, storage)
    if f.device.type != "cuda":
        raise ValueError(f"collide_rows: unsupported device {f.device}")
    dt, dev = f.dtype, f.device
    _kernels.check_scheme(dt, ref.REFERENCE_WALLS, forcing, storage,
                          "collide_rows")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"f must be [9, n, m], got {tuple(f.shape)}")
    _, n, m = f.shape
    if tuple(force.shape) != (2, n, m):
        raise ValueError(f"force shape {tuple(force.shape)} != (2, {n}, {m})")
    if force.dtype != dt or force.device != dev:
        raise ValueError(f"force must be {dt} on {dev}")
    f1 = torch.empty((9, n, m), dtype=dt, device=dev)
    if n * m:
        _kernels.launch(
            "iblb_collide_rows", dt, dev, f.data_ptr(), *f.stride(),
            force.data_ptr(), *force.stride(), f1.data_ptr(), n, m,
            float(cfg.tau), float(cfg.tau2), int(forcing == "trt_split"),
            int(storage == "deviatoric"))
        collide_rows.launches += 1
    return f1


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
collide_rows.launches = 0
