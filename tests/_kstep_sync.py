"""The K-step kernel's cases for its mbarriers, each run in a worker
process by tests/test_torch_cuda.py under a time limit: a wait that never
ends (a level waiting on a phase its neighbour never completes) hangs the
kernel, and only the worker that launched it can be killed.

``run_case(spec)`` runs one case on the card (where spec["ly"] is set,
with segments of that many output rows instead of the geometry's) and
returns plain values for the test to check.  B4 cases: f against K
launches of B3 bit for bit, the flux against the plain version; bf16
storage also against the f32 entry on the widened values, rounded.  B7
cases: NaN in the ghost rows and in the ghost columns beyond K, the owned
cells bit for bit those of the same call with finite ghosts and segments
of 3 rows, and within the gate of the plain version.
"""

import dataclasses

import numpy as np
import torch

from cuda_iblb_11_tpu_torch import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import W
from cuda_iblb_11_tpu_torch.ops import ghost_temporal as gt
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import sharded_fused_substep
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
    temporal_bulk, temporal_bulk_reference,
)

# widths no strip width divides: at 150 the second strip is ragged
GRIDS = {288: dict(c_num=6, c_space=48), 150: dict(c_num=3, c_space=50)}
GATE = {torch.float32: 1e-6, torch.float64: 1e-12}
_GEOMETRY = gt._geometry   # the driver's own


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _inputs(cfg, storage, dtype, seed):
    rng = np.random.default_rng(seed)
    y, x = cfg.ydim, cfg.xdim
    rho = torch.from_numpy(1.0 + 0.02 * rng.standard_normal((y, x)))
    u = torch.from_numpy(0.01 * rng.standard_normal((2, y, x)))
    f = ref.equilibrium(rho, u, storage)
    w = torch.tensor(W)[:, None, None]
    f = f + 1e-4 * torch.from_numpy(rng.standard_normal(f.shape)) * w
    return f.to("cuda", dtype)


def _use_geometry(ly):
    """The driver's geometry; with ly, segments of ly output rows."""
    _GEOMETRY.cache_clear()

    def geometry(yl, pad, width, K, dtype, n_sm):
        geo = _GEOMETRY(yl, pad, width, K, dtype, n_sm)
        if ly is None:
            return geo
        rows = yl + 2 * pad
        return dataclasses.replace(geo, passes=tuple(
            dataclasses.replace(p, ly=ly, n_seg=-(-rows // ly))
            for p in geo.passes))

    gt._geometry = geometry


def _b4(spec):
    dtype = getattr(torch, spec["dtype"])
    cdt = torch.float32 if dtype == torch.bfloat16 else dtype
    storage, K = spec["storage"], spec["K"]
    cfg = SimConfig(ydim=spec["ydim"], **GRIDS[spec["width"]])
    band = cfg.force_band
    walls = ref.WallSpec(top=spec["top"])
    f = _inputs(cfg, storage, cdt, seed=K + spec["ydim"])
    bh = (f[None, :, band - 1] * (1.0 + 1e-3 * torch.arange(
        K, device=f.device, dtype=cdt)[:, None, None])).contiguous()
    bulk = f[:, band:]
    geo = gt.kstep_geometry(cfg.ydim - band, 0, cfg.xdim, K, dtype)
    out = {"ly": [p.ly for p in geo.passes],
           "segment_rows": sorted({y1 - y0 for p in geo.passes
                                   for y0, y1 in p.segments(geo.rows)}),
           "strip_cols": sorted({x1 - x0 for p in geo.passes
                                 for x0, x1 in p.strips(geo.width)})}
    got, flux = temporal_bulk(bulk, bh, cfg, walls, "trt_split", storage)
    cur = bulk
    for s in range(K):
        cur = sharded_fused_substep((band, 0, 1), cur, None, bh[s], None,
                                    cfg, walls, "trt_split", storage)[0]
    want = temporal_bulk_reference(bulk, bh, cfg, walls, "trt_split",
                                   storage)[1]
    if dtype == torch.bfloat16:
        b16, flux16 = temporal_bulk(bulk.to(dtype), bh, cfg, walls,
                                    "trt_split", storage)
        wide, flux_wide = temporal_bulk(bulk.to(dtype).to(cdt), bh, cfg,
                                        walls, "trt_split", storage)
        out["bf16_is_f32_rounded"] = bool(torch.equal(b16, wide.to(dtype)))
        out["bf16_flux_is_f32"] = bool(torch.equal(flux16, flux_wide))
    torch.cuda.synchronize()
    out.update(f_is_k_launches_of_b3=bool(torch.equal(got, cur)),
               finite=bool(torch.isfinite(got).all()),
               flux_rel=_rel(flux, want), gate=GATE[cdt])
    return out


def _b7(spec):
    # shard (band, 0) of a 256-row grid: 128 owned rows whose bottom one
    # is the seam and whose top one is the top wall (both seal the ghost
    # rows), 96 owned columns with 128 ghost columns a side
    dtype, K = getattr(torch, spec["dtype"]), spec["K"]
    storage = spec["storage"]
    cfg = SimConfig(c_num=4, c_space=48, ydim=256)
    band, yl, pad, xl, xpad = cfg.force_band, 128, 16, 96, 128
    f = _inputs(cfg, storage, dtype, seed=24)
    cols = torch.arange(-xpad, xl + xpad, device=f.device) % cfg.xdim
    rows = torch.arange(band - pad, band + yl + pad,
                        device=f.device) % cfg.ydim
    blk = f[:, rows][:, :, cols]
    bh = f[None, :, band - 1][:, :, cols].repeat(K, 1, 1)
    bh = (bh * (1.0 + 1e-3 * torch.arange(
        K, device=f.device, dtype=dtype)[:, None, None])).contiguous()
    f_loc = blk[:, pad:pad + yl].contiguous()
    bot, top = blk[:, :pad].contiguous(), blk[:, pad + yl:].contiguous()
    flags = (1, 1, pad, xpad + cfg.flux_x % xl, 1)
    rest = (cfg, ref.WallSpec(), "trt_split", storage)
    nan_loc = f_loc.clone()
    nan_loc[:, :, :xpad - K] = float("nan")
    nan_loc[:, :, xpad + xl + K:] = float("nan")
    nan_args = (flags, nan_loc, torch.full_like(bot, float("nan")),
                torch.full_like(top, float("nan")), bh) + rest
    got = gt.ghost_temporal(*nan_args)
    want = gt.ghost_temporal_reference(*nan_args)
    geo = gt.kstep_geometry(yl, pad, xl + 2 * xpad, K, dtype)
    out = {"ly": [p.ly for p in geo.passes]}
    _use_geometry(3)
    finite = gt.ghost_temporal(flags, f_loc, bot, top, bh, *rest)
    torch.cuda.synchronize()
    own = np.s_[:, pad:pad + yl, xpad:xpad + xl]
    out.update(
        owned_is_short_segments_with_finite_ghosts=bool(
            torch.equal(got[0][own], finite[0][own])
            and torch.equal(got[1], finite[1])),
        finite=bool(torch.isfinite(got[0][own]).all()
                    and torch.isfinite(got[1]).all()),
        f_rel=_rel(got[0][own], want[0][own]), flux_rel=_rel(got[1], want[1]),
        gate=GATE[dtype])
    return out


def run_case(spec):
    """One case, in this process: its results as plain values."""
    _use_geometry(spec.get("ly"))
    try:
        return (_b4 if spec["kernel"] == "B4" else _b7)(spec)
    finally:
        gt._geometry = _GEOMETRY
        _GEOMETRY.cache_clear()
