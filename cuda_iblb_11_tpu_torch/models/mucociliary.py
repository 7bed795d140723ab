"""The mucociliary pumping model — the port of
cuda_iblb_11_tpu/models/mucociliary.py, single-step and K-step temporal.

Each step keeps the reference's ordering (main.cu:817-934): cilia
kinematics (batched in f64 once per chunk); collide + stream with the
PREVIOUS step's IB force; interpolation on the post-stream, uncorrected
moments; spreading into the new force band; the cumulative flux sample
with the new force's half-force correction (never reset, main.cu:393).

Backends: "cuda" (the hand kernels of csrc/ through their wrappers in
ops/), "torch" (their plain versions, on any device), "auto" ("cuda" on a
CUDA device, "torch" on the CPU; the reason is kept in backend_reason).

dtype bfloat16 is the JAX package's fast mode: f is stored in bf16
(deviatoric storage only), everything else and all arithmetic in f32; on
the cuda backend the kernels' _bf16 entries run it (on a mesh too:
parallel/sharded.py).

ib_x_edge "reference" is the strict-parity quirk mode (JAX
mucociliary.py:105-111, 337-346): the step is collide + stream without
emission (B2h, ops/collide_stream), then the stencil IB of ops/ib on the
raw positions (interpolation row-aliasing the unwrapped flat index,
spreading dropping the periodic images) and the flux from the new f's
column; its K-step leg is the per-sub-step one, with the stencil IB after
each B3 call.

temporal: K > 1 runs whole multiples of K steps as K-step super-steps
(ops/temporal.py says which configurations can): the force-free bulk rows
above the IB band advance K steps in one call of B4 (ops/temporal_bulk),
while the band leg steps the band with the IB coupling: through B5
(ops/band_super, "band_super_whole": K sub-steps and the windowed IB in
one call), through B6 (ops/band_super_tiled, "band_super_xtiled": the same
on x-tiles, on a plan built with a footprint budget), or through K calls
of B3 (ops/fused_step.sharded_fused_substep) with the torch IB of
ops/ib_band ("per_substep").  The remaining steps of a chunk run
single-step.  "auto" picks the largest eligible K of (16, 8, 4, 2) on the
cuda backend and 1 elsewhere (as JAX resolves it only on pallas), with the
reason kept in temporal_reason.  The plan holds a band super-step to no
footprint budget on any device (ops/temporal.py says why), so a plan is
the same on the card and on the CPU.

Host spans (utils/spans.py, recorded only while it records; n in steps):
iblb.run_chunk, inside it iblb.steps_temporal and iblb.steps_single, each
with its iblb.kinematics (the temporal one also iblb.band_points; inside
the kinematics iblb.overlap_mask where cilia overlap, r_max > 1), and
inside those one span a kernel call (iblb.B2, B2h, B3, B4, B5 or B6; n = K
for B4-B6) and iblb.ib, the torch IB and flux of one step.
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.state import (
    FlowState, aux_dtype, dtype_name, initial_state, torch_dtype,
)
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
from cuda_iblb_11_tpu_torch.ops import ib, ib_band
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super, band_super_reference,
)
from cuda_iblb_11_tpu_torch.ops.band_super_tiled import (
    band_super_tiled, band_super_tiled_reference,
)
from cuda_iblb_11_tpu_torch.ops.collide_stream import (
    collide_stream, collide_stream_reference,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference, sharded_fused_substep,
    sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.precision import full_f32
from cuda_iblb_11_tpu_torch.ops.temporal import plan_auto, plan_temporal
from cuda_iblb_11_tpu_torch.ops.temporal_bulk import (
    temporal_bulk, temporal_bulk_reference,
)
from cuda_iblb_11_tpu_torch.utils.spans import span

# the reference hardcodes the flux divisor (ImmersedBoundary.cu:261)
_FLUX_DIVISOR = 192.0


def resolve_device(device) -> torch.device:
    """torch.device, raising for a CUDA device on a host without one (the
    port never runs on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return device


def prep_band_super_points(cfg, K, halo, aux_dtype, u_s, eps, anchor, frac,
                           n_super):
    """Per-step point data [n, Ns, ...] in the band super-step's layout
    (ops/band_super.py): per-cilium 128-point blocks (nodes padded with
    inert points), x anchors window-local (anchor_x - (m c_space - halo)),
    split [n_super, K, ...].  Returns (us [.., 2, c, 128], eps, axl, fx, ay,
    fy [.., c, 128]) as cuda_iblb_11_tpu/models/mucociliary.py:38-69 does."""
    n = n_super * K
    c, ln = cfg.c_num, cfg.length
    dev = anchor.device

    def blk(x, fill):
        x = x.reshape((n, c, ln) + tuple(x.shape[2:]))
        out = x.new_full((n, c, 128) + tuple(x.shape[3:]), fill)
        out[:, :, :ln] = x
        return out

    wstart = (torch.arange(c, dtype=torch.int32, device=dev) * cfg.c_space
              - halo)[None, :, None]
    node = torch.arange(128, device=dev)[None, None, :]
    # the inert anchor as a Python scalar: the result stays int32, and no
    # copy to the device waits for the work queued there
    axl = torch.where(node < ln, blk(anchor[..., 0], 0) - wstart, -20000)
    ay = blk(anchor[..., 1], -20000)
    fx = blk(frac[..., 0], 0.0)
    fy = blk(frac[..., 1], 0.0)
    us = torch.movedim(blk(u_s, 0.0), -1, 1)          # [n, 2, c, 128]
    ep = blk(eps.to(aux_dtype), 0.0)
    return tuple(x.reshape((n_super, K) + tuple(x.shape[1:])).contiguous()
                 for x in (us, ep, axl, fx, ay, fy))


class MucociliarySim:
    def __init__(
        self,
        cfg: SimConfig,
        walls: ref.WallSpec = ref.REFERENCE_WALLS,
        backend: str = "auto",
        pattern: str = "no_mucus",
        forcing: str = "trt_split",
        dtype=None,
        temporal: int | str = 1,
        ib_x_edge: str = "periodic",
        device="cuda",
    ):
        cfg.validate()
        self.cfg = cfg
        self.walls = walls
        self.forcing = forcing
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype or cfg.dtype)
        self.aux_dtype = aux_dtype(self.dtype)
        self.storage = cfg.storage_resolved
        on_cuda = self.device.type == "cuda"
        self.backend_reason = None
        if backend == "auto":
            backend = "cuda" if on_cuda else "torch"
            self.backend_reason = (
                "auto: device is cuda" if on_cuda else
                "auto: device is cpu (the hand kernel runs on CUDA only)")
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
        if backend == "cuda" and not on_cuda:
            raise ValueError("backend 'cuda' needs a CUDA device")
        if backend == "cuda" and self.dtype == torch.bfloat16 \
                and self.storage != "deviatoric":
            # as the JAX package's pallas backend refuses it on
            # construction (pallas_step.py:487-488)
            raise ValueError("bf16 storage requires deviatoric mode")
        self.backend = backend
        if ib_x_edge not in ("periodic", "reference"):
            raise ValueError(f"unknown ib_x_edge {ib_x_edge!r}")
        self.ib_x_edge = ib_x_edge
        self.temporal_requested = temporal
        self.temporal_reason = None
        self.plan = None    # ops/temporal.TemporalPlan when temporal > 1
        if temporal == "auto":
            if backend == "cuda":
                self.plan, self.temporal_reason = plan_auto(
                    cfg, walls, self.dtype, pattern, ib_x_edge)
            else:
                self.temporal_reason = (
                    f"auto: backend {backend!r} has no temporal path")
        elif int(temporal) > 1:
            self.plan = plan_temporal(cfg, int(temporal), walls, self.dtype,
                                      pattern, ib_x_edge)
        elif int(temporal) < 1:
            raise ValueError(f"temporal K must be >= 1, got {temporal}")
        self.temporal = self.plan.K if self.plan else 1
        self.cilia = CiliaModel(cfg, dtype=self.aux_dtype, pattern=pattern,
                                device=self.device, backend=backend)

    def init_state(self) -> FlowState:
        return initial_state(self.cfg, self.dtype, self.device)

    def resolved_config(self) -> dict:
        """The execution configuration after every auto decision (same keys
        as the JAX model; written into SimLog)."""
        return {
            "backend": self.backend,
            "backend_reason": self.backend_reason,
            "band_leg": self.plan.band_leg if self.plan else "single_step",
            "storage": self.storage,
            "dtype": dtype_name(self.dtype),
            "temporal": self.temporal,
            "temporal_requested": self.temporal_requested,
            "temporal_reason": self.temporal_reason,
            "forcing": self.forcing,
            "ib_path": ("stencil_quirk" if self.ib_x_edge == "reference"
                        else "band_matmul"),
            "mesh": None,
        }

    # --- one kernel call each; backend is the one choice between kernel
    # and plain version (a wrapper never takes the plain version for a
    # CUDA tensor).  Both write the new f into the caller's buffer.  Each
    # call is one span named after its kernel (utils/spans.py), on either
    # backend, so the kernel spans count what the wrappers' .launches do.

    def _pick(self, kernel, plain):
        return plain if self.backend == "torch" else kernel

    def _substep(self, f, force, out):
        with span("iblb.B2", 1):
            return self._pick(fused_substep, fused_substep_reference)(
                f, force, self.cfg, self.walls, self.forcing, self.storage,
                out=out)

    def _collide_stream(self, f, force, out):
        with span("iblb.B2h", 1):
            return self._pick(collide_stream, collide_stream_reference)(
                f, force, self.cfg.tau, self.cfg.tau2, self.walls,
                self.forcing, self.storage, out=out)

    def _band_substep(self, f_ext, force, out, f1out):
        """B3 on the extended band: flags [0, 1, 0] (bottom wall, no top
        wall, zero halo rows), exposing row band-1 into f1out, emitting q
        and the flux column."""
        with span("iblb.B3", 1):
            return self._pick(sharded_fused_substep,
                              sharded_fused_substep_reference)(
                (0, 1, 0), f_ext, force, None, None, self.cfg, self.walls,
                self.forcing, self.storage, self.cfg.force_band - 1, True,
                out=out, f1out=f1out)

    def _bulk(self, f_bulk, bhalos, out):
        with span("iblb.B4", self.temporal):
            return self._pick(temporal_bulk, temporal_bulk_reference)(
                f_bulk, bhalos, self.cfg, self.walls, self.forcing,
                self.storage, out=out)

    def _band_super(self, f_ext, force, xs, out):
        """B5 on the whole band, or B6 on the plan's x-tiles."""
        plan = self.plan
        if plan.band_leg == "band_super_xtiled":
            with span("iblb.B6", plan.K):
                return self._pick(band_super_tiled,
                                  band_super_tiled_reference)(
                    f_ext, force, *xs, self.cfg, plan.halo, plan.tile_x,
                    plan.gx, self.walls, self.forcing, self.storage, out=out)
        with span("iblb.B5", plan.K):
            return self._pick(band_super, band_super_reference)(
                f_ext, force, *xs, self.cfg, plan.halo, self.walls,
                self.forcing, self.storage, out=out)

    # --- single-step path

    def _stencil_ib(self, f_new, s, u_s, eps):
        """The quirk mode's IB force band from the stencil forms (JAX
        mucociliary.py:341-346, 460-468)."""
        f_s = ib.interpolate_from_f(f_new, s, u_s, self.storage, "reference")
        return ib.spread(f_s, s, eps, self.cfg.xdim, self.cfg.force_band,
                         "reference")

    def _fluid_ib_step(self, f, force, q, u_s, eps, anchored, s, out=None):
        """Fluid + IB + flux for one step: kernel, then the delta factors
        shared by interpolate and spread, then the flux from the emitted
        column (JAX mucociliary.py:327-367); in the quirk mode the step
        without emission, the stencil IB and the flux from f_new's
        column."""
        cfg = self.cfg
        if self.ib_x_edge == "reference":
            f_new = self._collide_stream(f, force, out)
            with span("iblb.ib", 1):
                force_new = self._stencil_ib(f_new, s, u_s, eps)
                return f_new, force_new, q + ib.flux_increment(
                    f_new, force_new, cfg.flux_x, _FLUX_DIVISOR,
                    self.storage)
        f_new, q_band, fluxcol = self._substep(f, force, out)
        with span("iblb.ib", 1):
            factors = ib_band.delta_factors(anchored, cfg.xdim,
                                            cfg.force_band, self.aux_dtype)
            f_s = ib_band.interpolate_from_moments(q_band, u_s, factors)
            force_new = ib_band.spread(f_s, eps, factors)
            q_new = q + ib.flux_from_cols(fluxcol, force_new, cfg.flux_x)
        return f_new, force_new, q_new

    # kinematics of at most this many steps are batched at once
    _MAX_CHUNK = 512

    def step_kinematics(self, it0: int, n: int):
        """(pos, u_s, eps, anchor, frac, s) of steps it0 .. it0 + n - 1,
        each with a leading [n] axis: one batched f64 evaluation; s are the
        raw placed positions the quirk mode's stencil IB takes."""
        with span("iblb.kinematics", n):
            its = torch.arange(it0, it0 + n, dtype=torch.int64,
                               device=self.device)
            pos, vel = self.cilia.kinematics(its)          # [n, c, nodes, 2]
            s, u_s, eps = self.cilia.place_and_mask(pos, vel)
            anchor, frac = self.cilia.anchored_nodes(pos)
            return pos, u_s, eps, anchor, frac, s

    def _run_steps(self, state: FlowState, n: int) -> FlowState:
        with span("iblb.steps_single", n):
            pos, u_s, eps, anchor, frac, s = self.step_kinematics(state.it,
                                                                  n)
            f, force, q = state.f, state.force, state.q
            # two f buffers, neither of them state.f (the caller's state
            # stays valid)
            bufs = [torch.empty_like(f) for _ in range(min(n, 2))]
            for k in range(n):
                f, force, q = self._fluid_ib_step(
                    f, force, q, u_s[k], eps[k], (anchor[k], frac[k]), s[k],
                    bufs[k % 2])
            return FlowState(f=f, force=force,
                             lasts=pos[-1].to(self.aux_dtype), q=q,
                             it=state.it + n)

    # --- K-step temporal path

    def _super_step(self, f, force, q, u_s, eps, anchor, frac, s_pts):
        """K steps, per-sub-step band leg (JAX mucociliary.py:433-486): the
        extended band (band + pad ghost rows) runs K B3 calls, each followed
        by the torch IB (the stencil IB on the extended band in the quirk
        mode: every stencil cell lies far below its ghost rows); then the
        bulk advances K steps in one B4 call.  The band rows' flux takes the
        per-sub-step /192 of flux_from_cols; the bulk's raw sum is divided
        once."""
        cfg, K = self.cfg, self.temporal
        band, xdim = cfg.force_band, cfg.xdim
        rows = band + self.plan.pad
        f_new = torch.empty_like(f)
        ebufs = [torch.empty((9, rows, xdim), dtype=f.dtype,
                             device=f.device) for _ in range(2)]
        bhalos = torch.empty((K, 9, xdim), dtype=self.aux_dtype,
                             device=f.device)
        f_ext = f[:, :rows]
        flux_band = torch.zeros((), dtype=self.aux_dtype, device=f.device)
        for s in range(K):
            f_ext, _, q_band, fluxcol = self._band_substep(
                f_ext, force, ebufs[s % 2], bhalos[s])
            with span("iblb.ib", 1):
                if self.ib_x_edge == "reference":
                    force = self._stencil_ib(f_ext, s_pts[s], u_s[s],
                                             eps[s]).to(force.dtype)
                else:
                    factors = ib_band.delta_factors((anchor[s], frac[s]),
                                                    xdim, band,
                                                    self.aux_dtype)
                    f_s = ib_band.interpolate_from_moments(q_band, u_s[s],
                                                           factors)
                    force = ib_band.spread(f_s, eps[s],
                                           factors).to(force.dtype)
                # band rows only: the pad rows' flux comes from the bulk
                flux_band = flux_band + ib.flux_from_cols(
                    fluxcol[:, :band], force, cfg.flux_x, _FLUX_DIVISOR)
        _, flux_bulk = self._bulk(f[:, band:], bhalos, f_new[:, band:])
        f_new[:, :band].copy_(f_ext[:, :band])
        return f_new, force, q + flux_band + flux_bulk.sum() / _FLUX_DIVISOR

    def _super_step_fused(self, f, force, q, xs):
        """K steps, band super-step leg (JAX mucociliary.py:420-431): one
        B5 or B6 call for the band (reading the bulk's bottom pad_s rows as
        its ghost pad), one B4 call for the bulk; both raw flux sums are
        divided once."""
        band = self.cfg.force_band
        f_new = torch.empty_like(f)
        _, bhalos, force, flux_band = self._band_super(
            f[:, :band + self.plan.pad_s], force, xs, f_new[:, :band])
        _, flux_bulk = self._bulk(f[:, band:], bhalos, f_new[:, band:])
        q = q + (flux_band.sum() + flux_bulk.sum()) / _FLUX_DIVISOR
        return f_new, force.to(self.aux_dtype), q

    def _run_steps_temporal(self, state: FlowState, n: int) -> FlowState:
        """n (a multiple of K) steps as n / K super-steps (JAX
        mucociliary.py:488-526)."""
        K = self.temporal
        n_super = n // K
        with span("iblb.steps_temporal", n):
            pos, u_s, eps, anchor, frac, s = self.step_kinematics(state.it,
                                                                  n)
            f, force, q = state.f, state.force, state.q
            if self.plan.band_leg != "per_substep":
                with span("iblb.band_points", n):
                    xs_all = prep_band_super_points(
                        self.cfg, K, self.plan.halo, self.aux_dtype, u_s,
                        eps, anchor, frac, n_super)
                for i in range(n_super):
                    f, force, q = self._super_step_fused(
                        f, force, q, [x[i] for x in xs_all])
            else:
                for i in range(n_super):
                    sl = slice(i * K, (i + 1) * K)
                    f, force, q = self._super_step(f, force, q, u_s[sl],
                                                   eps[sl], anchor[sl],
                                                   frac[sl], s[sl])
            return FlowState(f=f, force=force,
                             lasts=pos[-1].to(self.aux_dtype), q=q,
                             it=state.it + n)

    @full_f32()   # one pin per chunk around every step's contractions
    def run_chunk(self, state: FlowState, n_steps: int) -> FlowState:
        """n_steps iterations; the input state is not modified.  With
        K > 1 each chunk of <= 512 steps runs its largest multiple of K as
        super-steps and the rest single-step, as the JAX model splits it."""
        K = self.temporal
        with span("iblb.run_chunk", n_steps):
            while n_steps > 0:
                k = min(n_steps, self._MAX_CHUNK)
                if K > 1 and k >= K:
                    k -= k % K
                    state = self._run_steps_temporal(state, k)
                else:
                    state = self._run_steps(state, k)
                n_steps -= k
            return state

    def fields(self, state: FlowState):
        """(rho, u_corrected) for output (main.cu:944-971)."""
        force = ib_band.pad_band(state.force, self.cfg.ydim)
        return ref.corrected_velocity(state.f.to(self.aux_dtype), force,
                                      self.storage)

    def boundary_fields(self, state: FlowState):
        """(s, u_s, eps) as of the last completed step, it - 1 (the phase-0
        placement with zero velocity at it = 0)."""
        it_prev = max(state.it - 1, 0)
        pos = self.cilia.positions(it_prev)
        if it_prev > 0:
            vel = pos - self.cilia.positions(it_prev - 1)
        else:
            vel = torch.zeros_like(pos)
        return self.cilia.place_and_mask(pos, vel)
