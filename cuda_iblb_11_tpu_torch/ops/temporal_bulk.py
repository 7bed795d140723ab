"""B4: K steps of the force-free bulk — the port of
make_temporal_bulk_substep (cuda_iblb_11_tpu/ops/pallas_step.py:966,
kernel _temporal_kernel :790).

    temporal_bulk(f_bulk, bhalos, cfg, ...) -> (f_bulk_new, flux)

f_bulk [9, Y - band, X] holds the rows above the force band; bhalos
[K, 9, X] the post-collision f1 of global row band-1 at each sub-step (the
band leg exposes it; the JAX layout [K, 9, 8, X] pads it to 8 rows, the
port keeps the row).  Sub-step s collides the bulk without force, pulls
row 0's up-going populations from bhalos[s], applies the top wall and
streams.  flux[s] is the sum over the bulk rows of mom_x / rho at x =
cfg.flux_x after sub-step s (no force correction: the force is zero here);
the caller divides by 192.

``temporal_bulk`` launches csrc/ghost_temporal.cu, the K-step driver it
shares with B7, on the bulk as a block with no ghost rows, for CUDA
tensors (or raises), and calls ``temporal_bulk_reference`` for CPU
tensors.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    _into, sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.ghost_temporal import launch_k_steps


def temporal_bulk_reference(f_bulk, bhalos, cfg, walls=ref.REFERENCE_WALLS,
                            forcing="trt_split", storage="raw", out=None):
    """Plain torch version: K force-free steps of the B3 plain version
    (flags [band, 0, 1]: no bottom wall, the seam row below, the top
    wall), each with its flux column; the state stays in >= f32 between
    sub-steps, as the JAX kernel's rings do.  The new f_bulk goes into
    ``out`` when given."""
    flags = (cfg.force_band, 0, 1)
    cdt = torch.promote_types(f_bulk.dtype, torch.float32)
    f = f_bulk.to(cdt)
    flux = []
    for s in range(bhalos.shape[0]):
        f, _, _, fluxcol = sharded_fused_substep_reference(
            flags, f, None, bhalos[s], None, cfg, walls, forcing, storage,
            emit_moments=True)
        flux.append((fluxcol[1] / fluxcol[0]).sum())
    return _into(out, f.to(f_bulk.dtype)), torch.stack(flux)


def temporal_bulk(f_bulk, bhalos, cfg, walls=ref.REFERENCE_WALLS,
                  forcing="trt_split", storage="raw", out=None):
    """(f_bulk_new, flux [K]).  CUDA tensors launch the hand kernel:
    f_bulk and ``out`` may be row ranges of larger states (contiguous rows)
    and must not overlap.  CPU tensors take the plain version."""
    if f_bulk.device.type == "cpu":
        return temporal_bulk_reference(f_bulk, bhalos, cfg, walls, forcing,
                                       storage, out)
    if f_bulk.device.type != "cuda":
        raise ValueError(f"temporal_bulk: unsupported device {f_bulk.device}")
    rows, xdim = cfg.ydim - cfg.force_band, cfg.xdim
    if rows < 1:
        raise ValueError("temporal_bulk needs rows above the force band")
    _kernels.check_planes("f_bulk", f_bulk, (9, rows, xdim), f_bulk.dtype,
                          f_bulk.device)
    if not 0 <= cfg.flux_x < xdim:
        raise ValueError(f"flux_x {cfg.flux_x} outside [0, {xdim})")
    # the seam injected at row 0, the top wall, the flux column owned
    out, flux = launch_k_steps((1, 1, 0, cfg.flux_x, 1), f_bulk, None, None,
                               bhalos, cfg, walls, forcing, storage, out,
                               "temporal_bulk")
    temporal_bulk.launches += 1
    return out, flux


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
temporal_bulk.launches = 0
