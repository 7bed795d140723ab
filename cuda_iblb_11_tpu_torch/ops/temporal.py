"""Which K-step temporal leg a configuration can take: the geometry
predicates of cuda_iblb_11_tpu/models/mucociliary.py:_setup_temporal
(:231-297) and of the factories it calls in ops/pallas_step.py
(pick_band_leg_tile :614, make_temporal_bulk_substep :966,
_band_super_geometry :1328).

A K-step super-step splits the state into the force band (rows [0, band),
stepped with the IB coupling) and the force-free bulk (rows [band, Y),
advanced K steps by B4).  The band leg runs on an extended block, the band
plus a ghost pad >= K rows copied from the bulk bottom (the ghost
trapezoid: its top row is garbage that creeps one row down per sub-step),
and is either
    band_super_whole  B5: K sub-steps + windowed IB in one call, when each
                      cilium's window W = c_space + 2 halo fits the domain;
    per_substep       B3 per sub-step + the torch IB (ops/ib_band.py).

Every geometry predicate of the JAX package is kept (periodic x, bottom
no-slip, top slip or no-slip; <= 128 nodes per cilium; pad >= K;
ydim - band >= pad; at least two bulk tiles; c_space + 2 halo <= xdim; the
halo from beat_x_bound() + 3 rounded up to 128), so on the CPU, where JAX
runs Pallas in interpret mode, both packages pick the same K, leg and pad.
The TPU-memory predicates (the VMEM budgets of pallas_step.py:1007-1021 and
:1561-1564, the tile budget of _pick_tile) and the 128-lane alignments
(:1340, :1358) are not kept: the port's kernels take any width and keep
the band in device memory, not in one core's fast memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cuda_iblb_11_tpu_torch.models.cilia import beat_x_bound

AUTO_LADDER = (16, 8, 4, 2)   # largest eligible K wins


@dataclass(frozen=True)
class TemporalPlan:
    K: int
    band_leg: str        # "band_super_whole" | "per_substep"
    pad: int             # ghost rows of the per-sub-step leg
    pad_s: int | None    # ghost rows of the band super-step (B5 leg only)
    halo: int | None     # B5 window halo (B5 leg only)


def _align(dtype) -> int:
    return 16 if torch.tensor([], dtype=dtype).element_size() == 2 else 8


def _pick_tile(ydim: int) -> int:
    """pallas_step._pick_tile without its VMEM budget: the largest of
    (64, 32, 16, 8) dividing ydim, else 8."""
    return next((ty for ty in (64, 32, 16, 8) if ydim % ty == 0), 8)


def pick_band_leg_tile(cfg, K: int, dtype) -> tuple[int, int]:
    """(tile rows, ghost pad rows) of the per-sub-step band leg: the tile
    minimizing the extended block's rows band + pad (pad = K rounded up to
    whole tiles), the largest among equals (pallas_step.py:614-639)."""
    band = cfg.force_band
    ty_max = min(_pick_tile(band), band)
    align = _align(dtype)
    cands = [t for t in (64, 32, 16, 8)
             if t <= ty_max and band % t == 0 and t % align == 0]
    if not cands:
        raise ValueError(
            f"no band-leg tile fits: force band {band} has no {align}-row-"
            f"aligned divisor tile <= {ty_max} (dtype {dtype})")
    ty0 = min(cands, key=lambda t: (band + -(-K // t) * t, -t))
    return ty0, -(-K // ty0) * ty0


def check_bulk(cfg, K: int, walls, dtype) -> None:
    """The temporal bulk's predicates (pallas_step.py:982-1026): top slip
    or no-slip, K >= 1, and the bulk rows split into >= 2 whole tiles of
    (64, 32, 16, 8) rows."""
    if walls.left != "periodic":
        raise NotImplementedError("temporal bulk requires periodic x walls")
    if walls.top not in ("slip", "noslip"):
        raise NotImplementedError("temporal bulk supports top=slip|noslip")
    if K < 1:
        raise ValueError("n_steps must be >= 1")
    n_rows = cfg.ydim - cfg.force_band
    align = _align(dtype)
    if not any(n_rows % t == 0 and n_rows // t >= 2 and t % align == 0
               for t in (64, 32, 16, 8)):
        raise ValueError(
            f"no tile size fits K={K} temporal bulk for rows={n_rows}: "
            "the bulk needs >= 2 row tiles")


def band_super_geometry(cfg, pad: int, K: int, walls,
                        pattern: str = "no_mucus") -> tuple[int, int]:
    """(c_space, halo) of the band super-step, or raise when it does not
    apply (pallas_step.py:1328-1362).  The halo makes every window
    [m c_space - halo, (m+1) c_space + halo) contain its cilium's delta
    support: the beat envelope + |frac| + 1.5, with one cell of slack,
    rounded up to 128 columns."""
    if walls.left != "periodic":
        raise NotImplementedError("band super-kernel requires periodic x")
    if walls.bottom != "noslip":
        raise NotImplementedError(
            "band super-kernel supports bottom=noslip only")
    cw = cfg.c_space
    if cfg.length > 128:
        raise ValueError("band super-kernel requires <= 128 nodes/cilium")
    if pad < K:
        raise ValueError("ghost pad must cover K sub-steps")
    bound = beat_x_bound(cfg.length, pattern) + 3.0
    halo = max(0, -(-int(bound - cw / 2 + 1) // 128) * 128) \
        if bound > cw / 2 else 0
    if cw + 2 * halo > cfg.xdim:
        raise ValueError("cilium window exceeds the domain width")
    return cw, halo


def plan_temporal(cfg, K: int, walls, dtype, pattern: str = "no_mucus",
                  ib_x_edge: str = "periodic") -> TemporalPlan:
    """The K-step leg for cfg, in _setup_temporal's order; raises
    ValueError when no K-step leg fits (the auto ladder walks on these)."""
    band = cfg.force_band
    leg, pad_s, halo = "per_substep", None, None
    if ib_x_edge == "periodic":
        # the resident-band super-step first (the x-tiled B6 that JAX
        # tries next is not ported; on the CPU it fails wherever this does)
        p = -(-K // 8) * 8
        try:
            if cfg.ydim - band < p:
                raise ValueError("ydim too small for ghost pad")
            _, halo = band_super_geometry(cfg, p, K, walls, pattern)
            leg, pad_s = "band_super_whole", p
        except ValueError:
            halo = None
    _, pad = pick_band_leg_tile(cfg, K, dtype)
    if cfg.ydim - band < pad:
        raise ValueError(
            "temporal blocking needs ydim well above the force band "
            f"(ydim={cfg.ydim}, band={band}, pad={pad})")
    check_bulk(cfg, K, walls, dtype)
    return TemporalPlan(K=K, band_leg=leg, pad=pad, pad_s=pad_s, halo=halo)


def plan_auto(cfg, walls, dtype, pattern: str = "no_mucus",
              ib_x_edge: str = "periodic"):
    """(plan or None, reason): the largest K of AUTO_LADDER with a leg,
    else None (the single-step path) with the last rejection."""
    err = None
    for K in AUTO_LADDER:
        try:
            plan = plan_temporal(cfg, K, walls, dtype, pattern, ib_x_edge)
            return plan, f"auto: K={K} (largest eligible)"
        except ValueError as e:
            err = e
    return None, f"auto: no eligible K ({err})"
