"""Full-f32 contractions whatever the caller set: ``full_f32``; and how
far two bf16 arrays lie apart: ``bf16_agreement``.

The port's f32 contractions (the IB band matmuls of ops/ib_band.py, the
stencil spread and flux of ops/ib.py, B5's plain version, the sharded flux
column, and the plain collide's einsums in ops/reference.py, which are the
torch backend's step and every kernel's plain version) run under it.  TF32
keeps about three decimal digits, and a reduced-precision pass of the IB
contractions put 1e-3 relative noise into the force on the TPU
(docs/DESIGN.md:259-295); in the plain collide it would loosen the
yardstick the kernels are held to.
"""

from __future__ import annotations

import contextlib

import torch


def _pin():
    """Set full f32 with both of torch's switch kinds; what was set."""
    b = torch.backends
    new = [(m, m.fp32_precision) for m in (b.cuda.matmul, b.cudnn,
                                            b.mkldnn.matmul)]
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        legacy = None
    try:
        cudnn = b.cudnn.allow_tf32
    except RuntimeError:
        cudnn = None
    torch.set_float32_matmul_precision("highest")
    b.cudnn.allow_tf32 = False
    return new, legacy, cudnn


def _restore(saved):
    new, legacy, cudnn = saved
    if legacy is not None:
        torch.set_float32_matmul_precision(legacy)
    if cudnn is not None:
        torch.backends.cudnn.allow_tf32 = cudnn
    for m, value in new:
        m.fp32_precision = value


class full_f32(contextlib.ContextDecorator):
    """Full-f32 matmuls inside (no TF32, no bf16 passes), whatever the
    caller set; the caller's settings come back on exit.  Sets torch's
    legacy switches (float32_matmul_precision, cudnn.allow_tf32) so that
    they and the per-backend fp32_precision agree where torch checks them,
    and restores both kinds; a caller's legacy setting that torch itself
    cannot read (the two kinds mixed) is left "highest".  Nested uses pin
    once: the outermost sets and restores, the inner ones cost a counter
    (the simulations pin once per chunk, around every step's calls).  The
    switches are process-wide, as torch's are."""

    _depth = 0
    _saved = None

    def __enter__(self):
        if full_f32._depth == 0:
            full_f32._saved = _pin()
        full_f32._depth += 1
        return self

    def __exit__(self, *exc):
        full_f32._depth -= 1
        if full_f32._depth == 0:
            saved, full_f32._saved = full_f32._saved, None
            _restore(saved)
        return False


# Below this share of a plane's largest magnitude, a bf16 value is not
# resolved by the f32 arithmetic that made it: the collide's f32 round-off
# is about 2^-23 of the largest terms, which is one bf16 ulp (2^-8 of the
# value, at worst) of a value 2^-15 of them.  bf16_agreement counts ulps
# there at this floor.
BF16_ULP_FLOOR = 2.0 ** -14


def bf16_agreement(got, want):
    """(bit_equal_share, max_ulps, max_ulps_floored) of two bf16 tensors of
    one shape: the share of elements whose bits are equal, the largest
    difference in bf16 ulps at the larger of the two values' magnitudes,
    and the same with each magnitude raised to at least BF16_ULP_FLOOR
    times the largest |want| of its plane (the leading index).  Two bf16 arrays
    rounded from f32 results that differ at f32 round-off agree bit for
    bit almost everywhere and lie at most one floored ulp apart; the
    unfloored count also reports the values near zero, where f32
    cancellation leaves a few ulps of their own size."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16 \
            or got.shape != want.shape:
        raise ValueError(f"bf16_agreement takes two bf16 tensors of one "
                         f"shape, got {got.dtype} {tuple(got.shape)} and "
                         f"{want.dtype} {tuple(want.shape)}")
    same = (got.view(torch.int16) == want.view(torch.int16)).double().mean()
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs())
    diff = (g - w).abs()
    scale = w.abs().flatten(1).amax(1) if w.dim() > 1 else w.abs().max()
    scale = scale.reshape((-1,) + (1,) * (w.dim() - 1))

    def ulps(m):
        # the bf16 ulp at magnitude m: 2^(exponent - 7); tiny for zeros
        ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(1e-38))) - 7)
        return float((diff / ulp).max()) if diff.numel() else 0.0

    return (float(same), ulps(mag),
            ulps(torch.maximum(mag, BF16_ULP_FLOOR * scale)))
