"""B5, the band super-step: K steps of the IB band in one call, each a
forced collide + stream of the band and of the ghost rows that still reach
it, the interpolation at every cilium node and the spreading of its force,
and the flux sum of the K sub-steps."""

from __future__ import annotations

from iblb_benchmark.counts import (
    COLLIDE_FORCED, COLLIDE_FREE, IB_POINT, MOMENTS, POINT_BLOCK, is_named,
    value_bytes,
)

COUNTER = "cuda_iblb_11_tpu_torch.ops.band_super:band_super"


def counts(p, K, dtype):
    """The band and K ghost rows of f read, the band written; the force
    read and written, each sub-step's points (5 values and 2 int32 a
    point, in blocks of POINT_BLOCK a cilium), halo rows and flux written;
    per sub-step the forced collide and moments of the band, the IB of
    every node and the flux column, plus the force-free collide of the
    ghost rows that reach the band by the last sub-step (K - s at s)."""
    es, cs = value_bytes(dtype)
    band, x, c = p.band, p.xdim, p.c_num
    rows = band + K
    pts = K * c * POINT_BLOCK
    return (es * (9 * rows * x + 9 * band * x)
            + cs * (2 * band * x + 5 * pts + 9 * K * x + 2 * band * x + K)
            + 4 * 2 * pts,
            K * ((COLLIDE_FORCED + MOMENTS) * band * x
                 + IB_POINT * p.points + 4 * band)
            + COLLIDE_FREE * x * K * (K + 1) // 2)


def device_seconds(ops):
    """The interpolation and spreading kernels, the step launched right
    before each interpolation (the sub-step's band step) and the flux sum
    launched right after a spreading."""
    total = 0.0
    for i, op in enumerate(ops):
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        prev = ops[i - 1] if i > 0 else None
        if (is_named(op, "interp_kernel") or is_named(op, "spread_kernel")
                or (is_named(op, "step_kernel") and nxt is not None
                    and is_named(nxt, "interp_kernel"))
                or (is_named(op, "column_sum_kernel") and prev is not None
                    and is_named(prev, "spread_kernel"))):
            total += op.seconds
    return total
