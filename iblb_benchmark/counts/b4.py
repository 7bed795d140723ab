"""B4, the K-step bulk: K force-free steps of the rows above the IB band
in one call, fed the band's top row of each sub-step, summing the flux
column of each sub-step."""

from __future__ import annotations

from iblb_benchmark.counts import (
    COLLIDE_FREE, MOMENTS, is_named, value_bytes,
)

COUNTER = "cuda_iblb_11_tpu_torch.ops.temporal_bulk:temporal_bulk"


def counts(p, K, dtype):
    """The bulk rows of f read and written once, K halo rows read, K flux
    sums written; K force-free collides of every bulk cell and the flux
    column's moments."""
    es, cs = value_bytes(dtype)
    rows, x = p.ydim - p.band, p.xdim
    return (es * 18 * rows * x + cs * (9 * K * x + K),
            K * (COLLIDE_FREE * rows * x + MOMENTS * rows))


def device_seconds(ops):
    """The K-step kernel's launches and the flux sum launched right after
    them."""
    total = 0.0
    for i, op in enumerate(ops):
        if is_named(op, "kstep_kernel") or (
                is_named(op, "column_sum_kernel") and i > 0
                and is_named(ops[i - 1], "kstep_kernel")):
            total += op.seconds
    return total
