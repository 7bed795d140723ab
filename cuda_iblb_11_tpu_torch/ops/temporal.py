"""Which K-step temporal leg a configuration can take: the predicates of
cuda_iblb_11_tpu/models/mucociliary.py:_setup_temporal (:231-297) and of
the factories it calls in ops/pallas_step.py (pick_band_leg_tile :614,
make_temporal_bulk_substep :966, _band_super_geometry :1328,
make_band_super_substep :1509, make_band_super_substep_tiled :1582); and,
for a mesh, of parallel/sharded.py:ShardedTemporalSim.__init__ (:793-910)
with make_ghost_temporal_substep (:2079) and
make_band_super_substep_xsharded (:1727) — plan_sharded below.

A K-step super-step splits the state into the force band (rows [0, band),
stepped with the IB coupling) and the force-free bulk (rows [band, Y),
advanced K steps by B4).  The band leg runs on an extended block, the band
plus a ghost pad >= K rows copied from the bulk bottom (the ghost
trapezoid: its top row is garbage that creeps one row down per sub-step),
and is, in _setup_temporal's order, the first of
    band_super_whole   B5: K sub-steps + windowed IB in one call, when each
                       cilium's window W = c_space + 2 halo fits the domain
                       and the band's footprint fits the budget;
    band_super_xtiled  B6: the same on x-tiles of tile_x + 2 gx columns,
                       the largest tile whose footprint fits the budget;
    per_substep        B3 per sub-step + the torch IB (ops/ib_band.py).

Kept from the JAX package: every geometry predicate (periodic x, bottom
no-slip, top slip or no-slip; <= 128 nodes per cilium; pad >= K;
ydim - band >= pad; at least two bulk tiles; c_space + 2 halo <= xdim; the
halo from beat_x_bound() + 3 rounded up to 128), the ghost-column margin
gx >= W + 8K rounded up to 128 columns, the tile search (a multiple of
c_space dividing xdim into >= 2 tiles, tile + 2 gx <= xdim) and the
footprint of one band super-step instance, _band_super_resident (:1365).
The budget that footprint is held to is the caller's, and the
simulations give none on any device.  The TPU's VMEM is a capacity; the
card's L2 is a cache, and wherever the card's L2 size as a budget split
the band, the whole band super-step measured faster than the x-tiled one
(B5 against B6 at 8192^2 f32 and f64 and 2048^2 f64, B8 on the whole
x-shard block against the per-sub-step leg on 8192^2 (2, 2):
probe_legs.py, PERF.md section 6).  So every device plans as the JAX
package plans in interpret mode, where it skips its VMEM budget, and both
packages pick the same K, leg and pads.  A budget still builds the x-tiled
leg and the mesh's per-sub-step leg where a caller asks for them (the
card tests, chip_smoke.py, probe_legs.py).  Not
kept: the bulk's VMEM ring budget (:1007-1021), _pick_tile's VMEM budget
and the 128-lane alignments of c_space, the halo and the tile (:1340,
:1358, :1647): the port's bulk keeps no rings and its kernels take any
width.  For the same reason pick_band_leg_tile takes no width (the JAX
version's xl sizes only its VMEM budget), and the ghost kernel keeps only
K in [1, 16] and yl >= its 16-row pad, not the TPU's row-tile divisibility.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cuda_iblb_11_tpu_torch.models.cilia import beat_x_bound

AUTO_LADDER = (16, 8, 4, 2)   # largest eligible K wins
GHOST_PAD = 16     # ghost rows a side of the sharded bulk block (B7)
X_GHOST = 128      # ghost columns a side of it on x-sharded meshes


@dataclass(frozen=True)
class TemporalPlan:
    K: int
    band_leg: str        # "band_super_whole" | "band_super_xtiled" |
                         # "per_substep"
    pad: int             # ghost rows of the per-sub-step leg
    pad_s: int | None    # ghost rows of the band super-step (B5/B6 legs)
    halo: int | None     # window halo of the band super-step (B5/B6 legs)
    tile_x: int | None = None   # interior columns of a B6 tile
    gx: int | None = None       # ghost columns each side of a B6 tile


def _align(dtype) -> int:
    return 16 if torch.tensor([], dtype=dtype).element_size() == 2 else 8


def _itemsizes(dtype) -> tuple[int, int]:
    """(storage, compute) bytes per value: compute is >= f32."""
    cdt = torch.promote_types(dtype, torch.float32)
    return (torch.tensor([], dtype=dtype).element_size(),
            torch.tensor([], dtype=cdt).element_size())


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


def band_super_resident(width: int, rows: int, band: int, fpad_extra: int,
                        dtype) -> int:
    """Bytes one band super-step instance of `width` columns keeps
    resident (pallas_step._band_super_resident :1365): the f state and f1
    (rows, compute dtype), f_band (storage dtype), a bhalos row block, the
    force in and out and the overlap-add strip per column, plus the
    strip's 2 halo extra columns in the whole-domain layout (fpad_extra =
    2 halo; 0 on a tile, whose width carries its ghost columns)."""
    it, ic = _itemsizes(dtype)
    return (9 * rows * 2 * ic + 9 * band * it + 9 * 8 * ic
            + 2 * band * 2 * ic + 2 * band * ic) * width \
        + 2 * band * fpad_extra * ic


def band_super_reach(cw: int, halo: int, K: int) -> int:
    """Ghost columns gx of a B6 tile (pallas_step._band_super_reach
    :1378): edge errors move < 8 columns per sub-step through streaming
    and the delta reach of the overlapping-window IB, plus one window W
    of missing force from the cilia left out at each edge; rounded up to
    128 columns, as the JAX package rounds it on the TPU, so that both
    packages pick the same tiles."""
    return -(-(cw + 2 * halo + 8 * K) // 128) * 128


def band_super_block_windows(c_num: int, cw: int, halo: int, block_w: int,
                             gx: int, n_blocks: int):
    """(lifts, win_lo) per block (pallas_step._band_super_block_windows
    :1389): every periodic lift mt of a cilium window [mt cw - halo,
    mt cw - halo + W) lying fully inside the extended block
    [t block_w - gx, (t+1) block_w + gx), as raw lift indices (cilium
    mt % c_num), and each window's start in block coordinates."""
    ww = cw + 2 * halo
    txe = block_w + 2 * gx
    lifts, win_lo = [], []
    for t in range(n_blocks):
        lo_ext = t * block_w - gx
        tid, tlo = [], []
        for mt in range(-c_num, 2 * c_num):
            w0 = mt * cw - halo
            if w0 >= lo_ext and w0 + ww <= lo_ext + txe:
                tid.append(mt)
                tlo.append(w0 - lo_ext)
        lifts.append(tuple(tid))
        win_lo.append(tuple(tlo))
    return lifts, win_lo


def pick_band_tile(cfg, rows: int, K: int, halo: int, dtype,
                   budget: int | None) -> tuple[int, int]:
    """(tile_x, gx) of the x-tiled band super-step: the largest tile, a
    multiple of c_space dividing xdim into >= 2 tiles with tile + 2 gx <=
    xdim, whose footprint fits the budget (make_band_super_substep_tiled's
    search, :1643-1662); raises ValueError when none fits."""
    xdim, cw, band = cfg.xdim, cfg.c_space, cfg.force_band
    gx = band_super_reach(cw, halo, K)

    def ok(tx):
        txe = tx + 2 * gx
        return (xdim % tx == 0 and xdim // tx >= 2 and txe <= xdim
                and (budget is None or band_super_resident(
                    txe, rows, band, 0, dtype) <= budget))

    tx = next((m * cw for m in range(xdim // (2 * cw), 0, -1)
               if ok(m * cw)), None)
    if tx is None:
        raise ValueError(f"no x-tile fits the band super-kernel at "
                         f"XDIM={xdim} (gx={gx}, budget={budget})")
    return tx, gx


def plan_temporal(cfg, K: int, walls, dtype, pattern: str = "no_mucus",
                  ib_x_edge: str = "periodic",
                  budget: int | None = None) -> TemporalPlan:
    """The K-step leg for cfg, in _setup_temporal's order: the whole band
    super-step, the x-tiled one, the per-sub-step leg.  `budget` (bytes,
    or None for no limit) bounds a band super-step instance's footprint.
    Raises ValueError when no K-step leg fits (the auto ladder walks on
    these)."""
    band = cfg.force_band
    leg, pad_s, halo, tile_x, gx = "per_substep", None, None, None, None
    if ib_x_edge == "periodic":
        p = -(-K // 8) * 8
        try:
            if cfg.ydim - band < p:
                raise ValueError("ydim too small for ghost pad")
            _, halo = band_super_geometry(cfg, p, K, walls, pattern)
            pad_s = p
            if budget is None or band_super_resident(
                    cfg.xdim, band + p, band, 2 * halo, dtype) <= budget:
                leg = "band_super_whole"
            else:
                tile_x, gx = pick_band_tile(cfg, band + p, K, halo, dtype,
                                            budget)
                leg = "band_super_xtiled"
        except ValueError:
            pad_s = halo = None
    _, pad = pick_band_leg_tile(cfg, K, dtype)
    if cfg.ydim - band < pad:
        raise ValueError(
            "temporal blocking needs ydim well above the force band "
            f"(ydim={cfg.ydim}, band={band}, pad={pad})")
    check_bulk(cfg, K, walls, dtype)
    return TemporalPlan(K=K, band_leg=leg, pad=pad, pad_s=pad_s, halo=halo,
                        tile_x=tile_x, gx=gx)


def check_ghost(K: int, yl: int, pad: int = GHOST_PAD) -> None:
    """The ghost kernel's predicates (pallas_step.py:2123-2125,
    sharded.py:838-847): K in [1, pad], and a shard at least pad rows high,
    since its neighbours' ghost rows are its own edge rows."""
    if not 1 <= K <= pad:
        raise ValueError(f"K={K} must be in [1, {pad}] (ghost pad budget)")
    if yl < pad:
        raise ValueError(
            f"sharded temporal blocking needs yl >= {pad} rows per y-shard "
            f"(one-hop ghost-row exchange), got yl={yl}; use fewer y-shards "
            "or the per-step sharded path")


@dataclass(frozen=True)
class XShardLayout:
    """The x-sharded band super-step (B8) on xl-column shards: each shard's
    block is xl + 2 gx columns, its point blocks the c_sub cilia whose
    windows lie inside it."""
    gx: int
    halo: int
    width: int               # xl + 2 gx
    c_sub: int
    win_lo0: int             # block column of point block 0's window
    wwin: int                # window width
    phase_general: bool      # xl is not a c_space multiple
    m0: int | None = None    # uniform: shard ix's block j is cilium
    c_step: int | None = None    # (m0 + ix c_step + j) mod c_num
    wcov: int | None = None  # phase-general: the natural window W


def xshard_layout(cfg, pad: int, K: int, walls, dtype, xl: int, n_x: int,
                  pattern: str = "no_mucus", budget: int | None = None,
                  gx: int | None = None) -> XShardLayout:
    """make_band_super_substep_xsharded's geometry (pallas_step.py:
    1786-1828): gx = W + 8K rounded up to 128 columns (and c_space more in
    the phase-general layout, whose windows are c_space wider); gx <= xl,
    xl + 2 gx <= xdim, and the footprint of the xl + 2 gx block held to
    `budget`.  In the uniform layout every shard has the same windows and
    its cilia are a rotation of shard 0's.  Raises ValueError where it does
    not apply.  `gx` overrides the margin (the tests give the JAX
    interpret-mode value)."""
    cw, halo = band_super_geometry(cfg, pad, K, walls, pattern)
    band = cfg.force_band
    uniform = xl % cw == 0
    wcov = cw + 2 * halo
    if gx is None:
        gx = band_super_reach(cw, halo, K) + (0 if uniform else cw)
    wwin = wcov if uniform else wcov + cw
    if gx > xl:
        raise ValueError(f"x-sharded band super needs gx={gx} <= xl={xl} "
                         "(one-hop ghost-column exchange)")
    txe = xl + 2 * gx
    if txe > cfg.xdim:
        raise ValueError(f"extended shard block {txe} > XDIM={cfg.xdim}: a "
                         "cilium's periodic images would both fall inside "
                         "one block")
    if budget is not None and band_super_resident(
            txe, band + pad, band, 0, dtype) > budget:
        raise ValueError(f"x-sharded band super block ({txe} columns) "
                         f"exceeds the budget of {budget} bytes")
    if not uniform:
        c_sub = (txe - wwin) // cw + 1
        if c_sub < 1:
            raise ValueError(f"phase-general band super: no widened window "
                             f"(width {wwin}) fits the {txe}-column block")
        return XShardLayout(gx=gx, halo=halo, width=txe, c_sub=c_sub,
                            win_lo0=0, wwin=wwin, phase_general=True,
                            wcov=wcov)
    lifts, win_lo = band_super_block_windows(cfg.c_num, cw, halo, xl, gx,
                                             n_x)
    step = xl // cw
    if (not lifts[0] or any(w != win_lo[0] for w in win_lo)
            or any(lifts[t] != tuple(m + t * step for m in lifts[0])
                   for t in range(n_x))):
        raise ValueError("x-sharded band super: the shards' window layout "
                         "is not uniform")
    return XShardLayout(gx=gx, halo=halo, width=txe, c_sub=len(lifts[0]),
                        win_lo0=win_lo[0][0], wwin=wwin, phase_general=False,
                        m0=lifts[0][0], c_step=step)


@dataclass(frozen=True)
class ShardedPlan:
    """The K-step legs of a (n_y, n_x) mesh (ShardedTemporalSim)."""
    K: int
    band_leg: str   # band_super_whole | band_super_xtiled |
                    # band_super_xsharded(_phase) | per_substep_tiled
    pad_s: int           # ghost rows of the band super-step
    band_gather: bool    # the extended band spans y-shards
    xpad: int            # ghost columns of the bulk block (0 or 128)
    halo: int | None = None      # band super legs
    tile_x: int | None = None    # band_super_xtiled
    gx: int | None = None        # band_super_xtiled
    xshard: XShardLayout | None = None   # band_super_xsharded(_phase)
    pad_b: int | None = None     # per_substep_tiled: the band block's pad


def plan_sharded(cfg, K: int, n_y: int, n_x: int, walls, dtype,
                 pattern: str = "no_mucus",
                 budget: int | None = None) -> ShardedPlan:
    """ShardedTemporalSim's legs for K on a (n_y, n_x) mesh, in its order
    (sharded.py:805-910): the ghost kernel's and the pads' predicates, then
    the band leg: on n_x = 1 the whole band super-step, else the x-tiled
    one, held to `budget` as plan_temporal holds them; on n_x > 1 the
    x-sharded one (xshard_layout); else the per-sub-step leg on the
    shards' own columns.  Raises ValueError where K does not apply."""
    band = cfg.force_band
    yl, xl = cfg.ydim // n_y, cfg.xdim // n_x
    if n_y * n_x < 2:
        raise ValueError("single-shard meshes: use MucociliarySim(temporal=K)")
    if K < 2:
        raise ValueError("temporal must be >= 2")
    if walls.top not in ("slip", "noslip"):
        raise NotImplementedError("ghost temporal kernel supports "
                                  "top=slip|noslip")
    pad_s = -(-K // 8) * 8
    if cfg.ydim < band + pad_s:
        raise ValueError(f"temporal blocking needs ydim >= force_band + "
                         f"{pad_s} (got ydim={cfg.ydim}, band={band})")
    xpad = X_GHOST if n_x > 1 else 0
    if xl < xpad:
        raise ValueError(f"x-sharded temporal blocking needs xl >= {xpad} "
                         f"(one-hop ghost-column exchange), got xl={xl}")
    check_ghost(K, yl)
    base = dict(K=K, pad_s=pad_s, band_gather=yl < band + pad_s, xpad=xpad)
    try:
        if n_x == 1:
            _, halo = band_super_geometry(cfg, pad_s, K, walls, pattern)
            if budget is None or band_super_resident(
                    cfg.xdim, band + pad_s, band, 2 * halo, dtype) <= budget:
                return ShardedPlan(band_leg="band_super_whole", halo=halo,
                                   **base)
            tile_x, gx = pick_band_tile(cfg, band + pad_s, K, halo, dtype,
                                        budget)
            return ShardedPlan(band_leg="band_super_xtiled", halo=halo,
                               tile_x=tile_x, gx=gx, **base)
        lay = xshard_layout(cfg, pad_s, K, walls, dtype, xl, n_x, pattern,
                            budget)
        return ShardedPlan(
            band_leg=("band_super_xsharded_phase" if lay.phase_general
                      else "band_super_xsharded"),
            halo=lay.halo, xshard=lay, **base)
    except ValueError:
        pass
    _, pad_b = pick_band_leg_tile(cfg, K, dtype)
    if cfg.ydim < band + pad_b:
        raise ValueError(f"temporal blocking needs ydim >= force_band + "
                         f"{pad_b} (got ydim={cfg.ydim}, band={band})")
    return ShardedPlan(band_leg="per_substep_tiled", pad_b=pad_b, **base)


def plan_auto(cfg, walls, dtype, pattern: str = "no_mucus",
              ib_x_edge: str = "periodic", budget: int | None = None):
    """(plan or None, reason): the largest K of AUTO_LADDER with a leg,
    else None (the single-step path) with the last rejection."""
    err = None
    for K in AUTO_LADDER:
        try:
            plan = plan_temporal(cfg, K, walls, dtype, pattern, ib_x_edge,
                                 budget)
        except ValueError as e:
            err = e
            continue
        reason = f"auto: K={K} (largest eligible)"
        if plan.band_leg == "band_super_xtiled":
            reason += (f"; band_super_xtiled, tile {plan.tile_x}, "
                       f"gx {plan.gx}")
        return plan, reason
    return None, f"auto: no eligible K ({err})"

