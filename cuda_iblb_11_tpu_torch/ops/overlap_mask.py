"""The cilia's overlap mask — boundary_check's neighbour test (upstream
main.cu:176-252) for a batch of steps.  No TPU kernel computes it: the JAX
package masks in jnp (cuda_iblb_11_tpu/models/cilia.py).

    overlap_mask(x, y, r_max) -> eps

x, y [..., c_num, nodes] are the placed node positions of each step
(models/cilia.CiliaModel.place_and_mask), float32 or float64; eps
[..., c_num, nodes] int32 is 0 for a node closer than one lattice unit on
both axes to any node of cilia m - 1 ... m - (r_max - 1), the cilium
index taken cyclically, and 1 elsewhere.  Where r_max <= 1 no cilium has
a neighbour to test: every eps is 1 and nothing is launched.

``overlap_mask`` launches csrc/overlap_mask.cu for CUDA tensors (or
raises), and calls ``overlap_mask_reference`` for CPU tensors.  Both take
the differences neighbour minus own in the points' dtype and compare them
with 1, so their eps agree bit for bit.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.ops import _kernels

# pair tests the plain version holds at once: its steps go in blocks of
# MASK_BLOCK // (c_num nodes^2), so a 512-step chunk of 256 cilia makes
# 64 MB float32 temporaries, not 4.8 GB
MASK_BLOCK = 1 << 24


def overlap_mask_reference(x, y, r_max):
    """Plain torch version: for each neighbour r, the [..., c, nodes,
    nodes] differences to cilium m - r (torch.roll), a block of steps at a
    time."""
    eps = torch.ones(x.shape, dtype=torch.int32, device=x.device)
    if r_max <= 1:
        return eps
    c, ln = x.shape[-2:]
    xs, ys = x.reshape(-1, c, ln), y.reshape(-1, c, ln)
    es = eps.view(-1, c, ln)
    block = max(1, MASK_BLOCK // (c * ln * ln))
    for a in range(0, xs.shape[0], block):
        xb, yb = xs[a:a + block], ys[a:a + block]
        for r in range(1, r_max):
            xo = torch.roll(xb, r, dims=-2)   # cilium (m - r) mod c_num
            yo = torch.roll(yb, r, dims=-2)
            close = ((xo[..., None, :] - xb[..., :, None]).abs() < 1.0) & \
                    ((yo[..., None, :] - yb[..., :, None]).abs() < 1.0)
            es[a:a + block].masked_fill_(close.any(-1), 0)
    return eps


def overlap_mask(x, y, r_max):
    """eps [..., c_num, nodes] int32.  CUDA tensors launch the hand kernel
    once (none where r_max <= 1); CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return overlap_mask_reference(x, y, r_max)
    if x.device.type != "cuda":
        raise ValueError(f"overlap_mask: unsupported device {x.device}")
    if x.dim() < 2:
        raise ValueError(f"x must be [..., c_num, nodes], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"overlap_mask kernel takes float32/float64 points, got "
            f"{x.dtype}")
    _kernels.check_tensor("x", x, x.shape, x.dtype, x.device)
    _kernels.check_tensor("y", y, x.shape, x.dtype, x.device)
    if r_max <= 1:
        return torch.ones(x.shape, dtype=torch.int32, device=x.device)
    c, ln = x.shape[-2:]
    eps = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if eps.numel() == 0:
        return eps
    _kernels.launch("iblb_overlap_mask", x.dtype, x.device, x.data_ptr(),
                    y.data_ptr(), eps.data_ptr(), eps.numel() // (c * ln),
                    c, ln, int(r_max))
    overlap_mask.launches += 1
    return eps


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
overlap_mask.launches = 0
