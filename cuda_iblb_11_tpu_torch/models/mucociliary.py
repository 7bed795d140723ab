"""The mucociliary pumping model, single-step — the port of
cuda_iblb_11_tpu/models/mucociliary.py with temporal=1.

Each step keeps the reference's ordering (main.cu:817-934): cilia
kinematics (batched in f64 once per chunk); collide + stream with the
PREVIOUS step's IB force; interpolation on the post-stream, uncorrected
moments; spreading into the new force band; the cumulative flux sample
with the new force's half-force correction (never reset, main.cu:393).

Backends: "cuda" (the hand kernel csrc/fused_step.cu, through
ops/fused_step.fused_substep), "torch" (its plain version,
fused_substep_reference, on any device), "auto" ("cuda" on a CUDA device,
"torch" on the CPU; the reason is kept in backend_reason).
"""

from __future__ import annotations

import torch

from cuda_iblb_11_tpu.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.state import (
    FlowState, aux_dtype, dtype_name, initial_state, torch_dtype,
)
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
from cuda_iblb_11_tpu_torch.ops import ib, ib_band
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    fused_substep, fused_substep_reference,
)

# Kept in the errors below so a user can find what is still to port.
_TEMPORAL_ITEM = "ROADMAP Queue 1 item 9 (temporal mode; kernels B3-B5)"
_QUIRK_ITEM = "ROADMAP Queue 1 item 2 (stencil/quirk IB)"
_BF16_ITEM = "ROADMAP Queue 1 item 2 (bf16 storage on the card)"


def resolve_device(device) -> torch.device:
    """torch.device, raising for a CUDA device on a host without one (the
    port never runs on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return device


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
        if on_cuda and self.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"bf16 state on a CUDA device: {_BF16_ITEM}")
        self.backend = backend
        if ib_x_edge == "reference":
            raise NotImplementedError(f"ib_x_edge='reference': {_QUIRK_ITEM}")
        if ib_x_edge != "periodic":
            raise ValueError(f"unknown ib_x_edge {ib_x_edge!r}")
        self.ib_x_edge = ib_x_edge
        self.temporal_requested = temporal
        self.temporal_reason = None
        if temporal == "auto":
            self.temporal_reason = "auto: temporal path not yet ported"
        elif int(temporal) != 1:
            raise NotImplementedError(f"temporal K={temporal}: {_TEMPORAL_ITEM}")
        self.temporal = 1
        self.cilia = CiliaModel(cfg, dtype=self.aux_dtype, pattern=pattern,
                                device=self.device)

    def init_state(self) -> FlowState:
        return initial_state(self.cfg, self.dtype, self.device)

    def resolved_config(self) -> dict:
        """The execution configuration after every auto decision (same keys
        as the JAX model; written into SimLog)."""
        return {
            "backend": self.backend,
            "backend_reason": self.backend_reason,
            "band_leg": "single_step",
            "storage": self.storage,
            "dtype": dtype_name(self.dtype),
            "temporal": self.temporal,
            "temporal_requested": self.temporal_requested,
            "temporal_reason": self.temporal_reason,
            "forcing": self.forcing,
            "ib_path": "band_matmul",
            "mesh": None,
        }

    def _substep(self, f, force, out):
        # backend is the one choice between kernel and plain version; the
        # wrapper itself never picks the plain version for a CUDA tensor
        if self.backend == "torch":
            return fused_substep_reference(f, force, self.cfg, self.walls,
                                           self.forcing, self.storage)
        return fused_substep(f, force, self.cfg, self.walls, self.forcing,
                             self.storage, out=out)

    def _fluid_ib_step(self, f, force, q, u_s, eps, anchored, out=None):
        """Fluid + IB + flux for one step: kernel, then the delta factors
        shared by interpolate and spread, then the flux from the emitted
        column (JAX mucociliary.py:327-367)."""
        cfg = self.cfg
        f_new, q_band, fluxcol = self._substep(f, force, out)
        factors = ib_band.delta_factors(anchored, cfg.xdim, cfg.force_band,
                                        self.aux_dtype)
        f_s = ib_band.interpolate_from_moments(q_band, u_s, factors)
        force_new = ib_band.spread(f_s, eps, factors)
        q_new = q + ib.flux_from_cols(fluxcol, force_new, cfg.flux_x)
        return f_new, force_new, q_new

    # kinematics of at most this many steps are batched at once
    _MAX_CHUNK = 512

    def _run_steps(self, state: FlowState, n: int) -> FlowState:
        its = torch.arange(state.it, state.it + n, dtype=torch.int64,
                           device=self.device)
        pos, vel = self.cilia.kinematics(its)              # [n, c, nodes, 2]
        _, u_s, eps = self.cilia.place_and_mask(pos, vel)
        anchor, frac = self.cilia.anchored_nodes(pos)
        f, force, q = state.f, state.force, state.q
        # two f buffers for the kernel, neither of them state.f (the
        # caller's state stays valid); the plain version allocates anew
        bufs = [None, None]
        for k in range(n):
            out = None
            if self.backend != "torch":
                if bufs[k % 2] is None:
                    bufs[k % 2] = torch.empty_like(f)
                out = bufs[k % 2]
            f, force, q = self._fluid_ib_step(
                f, force, q, u_s[k], eps[k], (anchor[k], frac[k]), out)
        return FlowState(f=f, force=force,
                         lasts=pos[-1].to(self.aux_dtype), q=q,
                         it=state.it + n)

    def run_chunk(self, state: FlowState, n_steps: int) -> FlowState:
        """n_steps iterations; the input state is not modified."""
        while n_steps > 0:
            k = min(n_steps, self._MAX_CHUNK)
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
