"""B0: collide only, on slabs — the port of make_collide_rows_kernel
(cuda_iblb_11_tpu/ops/pallas_step.py:742, call :775).

    collide_slabs([(f, force), ...], cfg, forcing, storage) -> [f1, ...]
    collide_rows(f, force, cfg, forcing, storage) -> f1

Each slab's f [9, n, m] and force [2, n, m] give f1 [9, n, m], the
post-collision values of each cell (no streaming).  The sharded path
computes the f1 it hands its neighbours with it: the edge lines of each
shard and the seam columns of the band blocks (parallel/sharded.py), where
the JAX package collides in XLA (ops/reference.collide_rows).  On the card
those values must round as the step kernels round (csrc/collide_rows.cu
says why), so they come from the same collide_cell.

``collide_slabs`` collides a table of slabs of one device and dtype in one
launch of csrc/collide_rows.cu for CUDA tensors (or raises), at most
MAX_SLABS a launch: f and force may be strided views (an edge row or
column of a shard's state is read in place), and the f1 are views of one
output buffer.  ``collide_rows`` is a table of one.  For CPU tensors both
call ``collide_rows_reference``, the plain torch version of
ops/reference.py, slab by slab.

Under bf16 storage f is bf16 and the force and f1 float32: the collide
runs in float32 on f widened, as JAX's B0 in bf16 casts its inputs to the
compute type and writes f1 in it (pallas_step.py:760-783), and as the JAX
mesh collides its seams (sharded.py:578-581).  The f1 a neighbour pulls
rounds to bf16 only where B3 or the x-seam patch stores it.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref

MAX_SLABS = 32   # a launch's table (csrc/collide_rows.cu)


def collide_rows_reference(f, force, cfg, forcing="trt_split",
                           storage="raw"):
    """Plain torch version: ops/reference.collide_rows in >= f32."""
    cdt = torch.promote_types(f.dtype, torch.float32)
    return ref.collide_rows(f.to(cdt), force.to(cdt), cfg.tau, cfg.tau2,
                            forcing, storage)


def collide_slabs_reference(slabs, cfg, forcing="trt_split", storage="raw"):
    """Plain version of collide_slabs: each slab's f1 in turn."""
    return [collide_rows_reference(f, g, cfg, forcing, storage)
            for f, g in slabs]


def _check_slab(i, f, force, dt, cdt, dev):
    if f.device != dev or f.dtype != dt:
        raise ValueError(f"slab {i}: f must be {dt} on {dev}, got "
                         f"{f.dtype} on {f.device}")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"slab {i}: f must be [9, n, m], got "
                         f"{tuple(f.shape)}")
    _, n, m = f.shape
    if tuple(force.shape) != (2, n, m):
        raise ValueError(f"slab {i}: force shape {tuple(force.shape)} != "
                         f"(2, {n}, {m})")
    if force.dtype != cdt or force.device != dev:
        raise ValueError(f"slab {i}: force must be {cdt} on {dev}")


def collide_slabs(slabs, cfg, forcing="trt_split", storage="raw"):
    """Each slab's f1 [9, n, m], contiguous.  CUDA slabs (one device and
    dtype) launch the hand kernel once per MAX_SLABS slabs; CPU slabs take
    the plain version.  The force and f1 are in the compute type
    (float32 for bf16 f)."""
    slabs = list(slabs)
    if not slabs:
        return []
    f0 = slabs[0][0]
    if f0.device.type == "cpu":
        return collide_slabs_reference(slabs, cfg, forcing, storage)
    if f0.device.type != "cuda":
        raise ValueError(f"collide_slabs: unsupported device {f0.device}")
    dt, dev = f0.dtype, f0.device
    _kernels.check_scheme(dt, ref.REFERENCE_WALLS, forcing, storage,
                          "collide_rows")
    cdt = aux_dtype(dt)
    for i, (f, force) in enumerate(slabs):
        _check_slab(i, f, force, dt, cdt, dev)
    sizes = [9 * f.shape[1] * f.shape[2] for f, _ in slabs]
    buf = torch.empty(sum(sizes), dtype=cdt, device=dev)
    out, off = [], 0
    for (f, _), size in zip(slabs, sizes):
        out.append(buf[off:off + size].view(9, f.shape[1], f.shape[2]))
        off += size
    for lo in range(0, len(slabs), MAX_SLABS):
        part = slabs[lo:lo + MAX_SLABS]
        base = sum(sizes[:lo])
        if sum(sizes[lo:lo + MAX_SLABS]) == 0:
            continue
        table = (ctypes.c_longlong * (10 * len(part)))(*[
            v for f, g in part for v in (
                f.data_ptr(), *f.stride(), g.data_ptr(), *g.stride(),
                f.shape[1], f.shape[2])])
        _kernels.launch(
            "iblb_collide_slabs", dt, dev, ctypes.addressof(table), len(part),
            buf.data_ptr() + base * buf.element_size(), float(cfg.tau),
            float(cfg.tau2), int(forcing == "trt_split"),
            int(storage == "deviatoric"))
        collide_slabs.launches += 1
    return out


def collide_rows(f, force, cfg, forcing="trt_split", storage="raw"):
    """f1 [9, n, m], contiguous: collide_slabs on a table of one."""
    return collide_slabs([(f, force)], cfg, forcing, storage)[0]


# Launches of the kernel since the last reset, collide_rows' included (the
# CPU path does not count).
collide_slabs.launches = 0
