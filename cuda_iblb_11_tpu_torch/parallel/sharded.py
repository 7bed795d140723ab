"""Spatial domain decomposition on a (Y, X) mesh — the port of
cuda_iblb_11_tpu/parallel/sharded.py: ShardedPallasSim (one step per halo
exchange) and ShardedTemporalSim (K steps per exchange).

The [9, Y, X] state is cut into n_y x n_x shards of [9, yl, xl]; shard
(iy, ix) holds global rows [iy yl, (iy+1) yl) and columns [ix xl,
(ix+1) xl) and lives on ``mesh.devices[iy n_x + ix]``.

In one process (JAX's --mesh without --distributed) every shard is the
process's: with fewer cards than shards, shards share a card and run in
turn (the counterpart of the JAX tests' virtual CPU devices).  Under a
process group of W ranks (--distributed, parallel/dist.py) shard k
belongs to rank k W // (n_y n_x), a contiguous block in shard order, as
JAX's make_mesh over jax.devices() puts process 0's devices first; each
rank's shards live on its own device, and a rank holds None in place of
another rank's shard.  Every rank runs the same steps on its own shards.

The collectives list every shard (or x-column) in one global order, on
every rank: a ring shift along an axis (JAX's ppermute; the y-ring's
wrapped junk reaches only the outer shards' wall rows, which the wall
fix-ups overwrite, sharded.py:12-16), a column's value handed to its
shards, a column's band rows gathered from its shards, and a sum in a
fixed shard order (psum; no atomics, so a run repeats bit for bit).  In
one process each is a device-to-device copy; across ranks a value whose
source and destination ranks differ goes by send/recv, and the sum is
dist.Transport.all_sum_ordered: the same order and dtype, so W ranks give
the one-process mesh's bits.

Where the JAX package runs a computation on every shard with the same
(replicated) input — the IB force, which every y-shard of an x-column
holds, and the band leg of the temporal path — the port runs it once per
x-column of shards, on the rank and device of shard (0, ix), and hands
the result to the other shards of the column.  The launch counts say so:
one band leg call per x-column per super-step, counted by the rank that
runs it.  The cilia kinematics (f64, the same inputs) run on every rank.

Per step (ShardedPallasSim, _fluid_step), every shard:
  1. collides its four edge lines (B0, ops/collide_rows: every shard's
     lines in one launch per device) and hands them to its neighbours,
     the row payloads extended with the x-neighbours' corner cells;
  2. steps its block (B3 at the shard's width, ops/fused_step), pulling the
     neighbours' rows at the y seams; the x-roll wraps the block, so the
     two edge columns are pulled again from the neighbours' f1 columns
     (_patch_x_seams, data movement only);
  3. adds its share of the IB delta integrals (ops/ib_band.
     interpolate_partial); the sum gives the point forces, and each
     x-column spreads them over its own columns (spread_local); in the
     quirk mode (ib_x_edge "reference") the same with the stencil forms
     of ops/ib: _stencil_interp_block and _quirk_spread_block;
  4. adds its share of the flux column.

Per K-step super-step (ShardedTemporalSim), the legs of ops/temporal.
plan_sharded: the band advances K sub-steps through B5/B6 on n_x = 1
meshes, B8 per x-column (ops/band_super_xsharded) on x-sharded ones, or K
B3 calls per x-column with the IB per sub-step (per_substep_tiled, the
quirk mode's leg on every mesh); then
every shard's rows advance K steps in one B7 call (ops/ghost_temporal) on
its block extended by 16 ghost rows a side (and 128 ghost columns on
x-sharded meshes), exchanged once per super-step, with the band leg's seam
rows injected; the band rows are put back from the band leg.

bf16 storage (dtype bfloat16, deviatoric) keeps f in bf16 and everything
else in float32: the force, lasts, q, the f1 halos from B0 and the band
leg's seam halos (JAX sharded.py:150-151, 575, 1000, 1215).  f rounds
where the JAX mesh rounds it: in every B3 call (each step, and each
sub-step of the per-sub-step leg's band block), once per B7 and B8 call,
where _patch_x_seams stores a neighbour's f1, and where _run_bulk puts the
band rows back.

The state on a mesh is a MeshState: f a list of the shards' blocks, force
a list of the x-columns' band forces [2, band, xl]; place_state cuts a
global FlowState into the rank's shards and gather_state joins them on
rank 0 (npz checkpoints, snapshots); io/checkpoint.save_dir writes each
rank's shards where they are.  Not ported: the jnp ShardedMucociliarySim
(the torch backend runs the same sharded arithmetic in plain torch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.core.lattice import C, CY
from cuda_iblb_11_tpu_torch.core.state import (
    FlowState, aux_dtype, dtype_name, initial_state, torch_dtype,
)
from cuda_iblb_11_tpu_torch.models.cilia import CiliaModel
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    _FLUX_DIVISOR, MucociliarySim, prep_band_super_points,
)
from cuda_iblb_11_tpu_torch.ops import ib, ib_band
from cuda_iblb_11_tpu_torch.ops.precision import full_f32
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.band_super import (
    band_super, band_super_reference,
)
from cuda_iblb_11_tpu_torch.ops.band_super_tiled import (
    band_super_tiled, band_super_tiled_reference,
)
from cuda_iblb_11_tpu_torch.ops.band_super_xsharded import (
    band_super_xsharded, band_super_xsharded_reference, shard_points,
)
from cuda_iblb_11_tpu_torch.ops.collide_rows import (
    collide_slabs, collide_slabs_reference,
)
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    sharded_fused_substep, sharded_fused_substep_reference,
)
from cuda_iblb_11_tpu_torch.ops.ghost_temporal import (
    ghost_temporal, ghost_temporal_reference,
)
from cuda_iblb_11_tpu_torch.ops.temporal import GHOST_PAD, plan_sharded


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh of `device_type` spreads over: every visible card
    for 'cuda', the one CPU device otherwise."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


class Mesh:
    """A (n_y, n_x) mesh of shards, shard (iy, ix) at index k = iy n_x +
    ix.  In one process (comm None) every shard is rank 0's and lives on
    devices[k % len(devices)].  Under a process group (comm, a
    dist.Transport) shard k belongs to rank owner[k] = k W // (n_y n_x)
    and lives on that rank's device; devices[k] is None on the other
    ranks.  x-column ix runs on shard (0, ix)'s rank and device, so index
    ix names both."""

    def __init__(self, n_y: int, n_x: int, devices, comm=None):
        if n_y < 1 or n_x < 1:
            raise ValueError(f"mesh dims must be positive, got ({n_y}, "
                             f"{n_x})")
        n = n_y * n_x
        self.n_y, self.n_x, self.comm = n_y, n_x, comm
        if comm is None:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("a mesh needs at least one device")
            self.rank, self.owner = 0, [0] * n
            self.devices = [devices[k % len(devices)] for k in range(n)]
        else:
            if n < comm.world:
                raise ValueError(f"a ({n_y}, {n_x}) mesh has fewer shards "
                                 f"than the {comm.world} ranks")
            self.rank = comm.rank
            self.owner = [k * comm.world // n for k in range(n)]
            self.devices = [comm.device if o == comm.rank else None
                            for o in self.owner]
        self.n_devices = len({d for d in self.devices if d is not None})

    def mine(self, k: int) -> bool:
        """Shard k (or x-column k) is this rank's."""
        return self.owner[k] == self.rank

    def describe(self) -> str:
        if self.comm is None:
            return f"{self.n_y},{self.n_x} over {self.n_devices} device(s)"
        return (f"{self.n_y},{self.n_x} over {self.comm.world} rank(s), "
                f"{self.comm.name}")


def make_mesh(n_y: int, n_x: int, devices=None, comm=None) -> Mesh:
    """A mesh over `devices`, by default every visible card (the CPU where
    there is none); shards share devices when there are fewer.  Under a
    process group (comm) the mesh spans the ranks, each on its device."""
    if comm is not None:
        return Mesh(n_y, n_x, None, comm)
    if devices is None:
        devices = visible_devices(
            "cuda" if torch.cuda.is_available() else "cpu")
    return Mesh(n_y, n_x, devices)


class MeshState(NamedTuple):
    f: list              # the shards' blocks [9, yl, xl], shard order
    force: list          # the x-columns' band forces [2, band, xl]
    lasts: torch.Tensor  # [c_num, nodes, 2]  (every rank's own copy)
    q: torch.Tensor      # [] cumulative flux (every rank's own copy)
    it: int


def _copy_to(t, device, dtype):
    """A fresh contiguous copy of t on device, as dtype."""
    return torch.empty(t.shape, dtype=dtype, device=device).copy_(t)


def _cut(x, fn):
    """fn(x), or None for another rank's shard."""
    return None if x is None else fn(x)


def _sum_in_order(xs, device):
    """xs summed in list order on device (the fixed-order psum)."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


@full_f32()
def _stencil_interp_block(f_block, s, u_s, cfg, y0, rows, x0, xl, storage):
    """A block's share [Ns, 2] of the quirk's stencil-form IB interpolation
    (JAX sharded.py:403-433): f_block [9, rows, xl] holds global rows [y0,
    y0 + rows) and columns [x0, x0 + xl); the stencil (ops/ib._stencil in
    the quirk's "reference_alias" mode) is evaluated globally and the
    cells the block does not own weigh zero.  Each cell is owned by one
    block, so the sum of the shares over the blocks that partition the
    grid (or a row range holding every stencil cell) is ops/ib.
    interpolate_from_f up to the order of the sum.  The gather is promoted
    to >= f32: bf16 storage must not quantise the IB feedback."""
    cdt = torch.promote_types(f_block.dtype, torch.float32)
    xw, yc, w, valid = ib._stencil(s, cfg.xdim, cfg.ydim, "reference_alias")
    own = (valid & (yc >= y0) & (yc < y0 + rows)
           & (xw >= x0) & (xw < x0 + xl))
    wm = torch.where(own, w, torch.zeros_like(w)).to(cdt)
    f_cells = f_block[:, (yc - y0).clamp(0, rows - 1),
                      (xw - x0).clamp(0, xl - 1)].to(cdt)   # [9, Ns, 9]
    rho = f_cells.sum(0)
    if storage == "deviatoric":
        rho = 1.0 + rho
    c = torch.tensor(C, dtype=cdt, device=f_block.device)
    u_c = torch.einsum("inm,ic->cnm", f_cells, c) / rho[None]
    return ib._finish(wm, rho, u_c, u_s.to(cdt))


def _quirk_spread_block(f_s, s, eps, cfg, x0, xl, band):
    """The strict-parity spread ("reference_drop": the periodic images
    dropped, ImmersedBoundary.cu:178-231) into an x-column's own force
    columns [2, band, xl] (JAX sharded.py:436-453).  Not a scatter-add,
    whose order on CUDA changes from run to run: ops/ib.spread's
    fixed-order contraction on the stencil factors, DX cut to the columns
    [x0, x0 + xl), the quirk counterpart of ops/ib_band.spread_local.
    Each cell is one x-column's, so no sum across shards."""
    dy, dx = ib.stencil_factors(s, cfg.xdim, band, "reference_drop")
    return ib_band.spread(f_s, eps, (dy, dx[:, x0:x0 + xl]))


class ShardedPallasSim:
    """The mucociliary model on a mesh, one step per halo exchange: B0 for
    the edge lines, B3 for each shard's block, the sharded IB and flux
    (the module docstring).  backend "cuda" launches the kernels, "torch"
    runs their plain versions, "auto" picks cuda on a mesh of cards."""

    _kernel_path = "sharded_per_step"
    _MAX_CHUNK = 512   # kinematics of at most this many steps at once

    # the kinematics, the boundary snapshot and the fields are the
    # single-device model's (they touch only cfg, cilia, storage, device)
    step_kinematics = MucociliarySim.step_kinematics
    boundary_fields = MucociliarySim.boundary_fields

    def __init__(self, cfg: SimConfig, mesh: Mesh,
                 walls: ref.WallSpec = ref.REFERENCE_WALLS,
                 forcing: str = "trt_split", pattern: str = "no_mucus",
                 dtype=None, backend: str = "auto",
                 ib_x_edge: str = "periodic"):
        cfg.validate()
        if ib_x_edge not in ("periodic", "reference"):
            raise ValueError(f"unknown ib_x_edge {ib_x_edge!r}")
        self.ib_x_edge = ib_x_edge
        if walls.left != "periodic":
            raise NotImplementedError(
                "sharded backend requires periodic x walls")
        if walls.bottom != "noslip" or walls.top not in ("slip", "noslip"):
            raise NotImplementedError(
                "sharded backend supports bottom=noslip, top=slip|noslip "
                f"(got bottom={walls.bottom!r}, top={walls.top!r})")
        self.cfg, self.mesh, self.walls = cfg, mesh, walls
        self.forcing, self.pattern = forcing, pattern
        self.n_y, self.n_x = mesh.n_y, mesh.n_x
        if cfg.ydim % self.n_y or cfg.xdim % self.n_x:
            raise ValueError("grid dims must divide the mesh dims")
        self.yl, self.xl = cfg.ydim // self.n_y, cfg.xdim // self.n_x
        self.storage = cfg.storage_resolved
        self.dtype = torch_dtype(dtype or cfg.dtype)
        self.aux_dtype = aux_dtype(self.dtype)
        # kinematics, q, the gathered state: shard 0's device in one
        # process, the rank's own under a process group
        self.device = (mesh.devices[0] if mesh.comm is None
                       else mesh.comm.device)
        on_cuda = all(d.type == "cuda" for d in mesh.devices
                      if d is not None)
        self.backend_reason = None
        if backend == "auto":
            backend = "cuda" if on_cuda else "torch"
            self.backend_reason = (
                "auto: mesh on cuda" if on_cuda else
                "auto: mesh on cpu (the hand kernels run on CUDA only)")
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
        if backend == "cuda" and not on_cuda:
            raise ValueError("backend 'cuda' needs a mesh of CUDA devices")
        if backend == "cuda" and self.dtype == torch.bfloat16 \
                and self.storage != "deviatoric":
            # as MucociliarySim and the JAX pallas mesh refuse it
            raise ValueError("bf16 storage requires deviatoric mode")
        self.backend = backend
        self.temporal = 1
        self.temporal_requested = 1
        self.temporal_reason = None
        self.cilia = CiliaModel(cfg, dtype=self.aux_dtype, pattern=pattern,
                                device=self.device, backend=backend)
        self.shards = [(iy, ix) for iy in range(self.n_y)
                       for ix in range(self.n_x)]
        self._wire = {}    # the transport's shapes of this sim's moves

    def resolved_config(self) -> dict:
        """The execution configuration after every auto decision (the
        single-device model's keys, with the mesh)."""
        return {
            "backend": self.backend,
            "backend_reason": self.backend_reason,
            "band_leg": self._kernel_path,
            "storage": self.storage,
            "dtype": dtype_name(self.dtype),
            "temporal": self.temporal,
            "temporal_requested": self.temporal_requested,
            "temporal_reason": self.temporal_reason,
            "forcing": self.forcing,
            "ib_path": ("stencil_quirk" if self.ib_x_edge == "reference"
                        else "band_matmul"),
            "mesh": [self.n_y, self.n_x],
            "distributed": (None if self.mesh.comm is None
                            else self.mesh.comm.describe()),
        }

    # --- state on the mesh

    def place_state(self, state: FlowState) -> MeshState:
        """Cut a global FlowState (a fresh start or a checkpoint of either
        package) into this rank's shards; a full-height force (a jnp mesh
        checkpoint) gives its band rows."""
        yl, xl = self.yl, self.xl
        band = self.cfg.force_band
        mine, devs = self.mesh.mine, self.mesh.devices
        f = [_copy_to(state.f[:, iy * yl:(iy + 1) * yl,
                              ix * xl:(ix + 1) * xl], devs[k], self.dtype)
             if mine(k) else None
             for k, (iy, ix) in enumerate(self.shards)]
        force = [_copy_to(state.force[:, :band, ix * xl:(ix + 1) * xl],
                          devs[ix], self.aux_dtype) if mine(ix) else None
                 for ix in range(self.n_x)]
        return MeshState(
            f=f, force=force,
            lasts=_copy_to(state.lasts, self.device, self.aux_dtype),
            q=_copy_to(state.q, self.device, self.aux_dtype),
            it=int(state.it))

    def gather_state(self, state: MeshState) -> FlowState | None:
        """The global FlowState of a mesh state, on the first shard's
        device (checkpoints, fields).  Under a process group every rank
        calls it; rank 0 gets the state, the others None."""
        dev, n_x = self.device, self.n_x
        f, force = state.f, state.force
        if self.mesh.comm is not None:
            own = self.mesh.owner
            got = self.mesh.comm.gather(
                "gather", [(x, own[k]) for k, x in enumerate(f)]
                + [(x, own[ix]) for ix, x in enumerate(force)], dev,
                self._wire)
            if got is None:
                return None
            f, force = got[:len(f)], got[len(f):]
        rows = [torch.cat([f[iy * n_x + ix].to(dev) for ix in range(n_x)],
                          dim=2)
                for iy in range(self.n_y)]
        return FlowState(
            f=torch.cat(rows, dim=1),
            force=torch.cat([x.to(dev) for x in force], dim=2),
            lasts=state.lasts, q=state.q, it=state.it)

    def init_state(self) -> MeshState:
        return self.place_state(initial_state(self.cfg, self.dtype,
                                              self.device))

    def fields(self, state: MeshState):
        """(rho, u_corrected) of the gathered state (main.cu:944-971); a
        collective under a process group, None on ranks other than 0."""
        g = self.gather_state(state)
        return None if g is None else MucociliarySim.fields(self, g)

    # --- collectives over the shards (and the x-columns: column ix on the
    # rank and device of shard (0, ix), so slot ix names both)

    def _move(self, tag, items):
        """Each item (value, src slot, dst slot) as the dst slot's copy of
        the src slot's value on its device: a copy in one process, by the
        transport across ranks (tag: the call site)."""
        own, devs = self.mesh.owner, self.mesh.devices
        if self.mesh.comm is None:
            return [v.to(devs[dst]) for v, _, dst in items]
        return self.mesh.comm.move(
            tag, [(v, own[src], own[dst], devs[dst]) for v, src, dst in
                  items], self._wire)

    def _shift(self, tag, *shifts):
        """Ring shifts (xs, s, axis), all in one exchange: xs the shards'
        values (or the x-columns'); slot (iy, ix) receives the value of
        (iy - s, ix) on axis "y", (iy, ix - s) on "x", periodic."""
        n_y, n_x = self.n_y, self.n_x
        items, ends = [], []
        for xs, s, axis in shifts:
            for k in range(len(xs)):
                iy, ix = divmod(k, n_x)
                src = (((iy - s) % n_y) * n_x + ix if axis == "y"
                       else iy * n_x + (ix - s) % n_x)
                items.append((xs[src], src, k))
            ends.append(len(items))
        got = self._move(tag, items)
        return [got[a:b] for a, b in zip([0] + ends[:-1], ends)]

    def _to_shards(self, tag, cols, ks=None):
        """x-column ix's value on each shard k = (iy, ix) of ks (default
        every shard), in the order of ks."""
        ks = range(len(self.shards)) if ks is None else ks
        return self._move(tag, [(cols[k % self.n_x], k % self.n_x, k)
                                for k in ks])

    def _psum(self, tag, parts):
        """The sum of parts [(value, slot)] in list order, in one process
        on the first shard's device; under a process group on every rank's
        device, with the same order and dtype (the slot's rank holds the
        value, the others None)."""
        if self.mesh.comm is None:
            return _sum_in_order([v for v, _ in parts], self.device)
        own = self.mesh.owner
        return self.mesh.comm.all_sum_ordered(
            tag, [(v, own[k]) for v, k in parts], self._wire)

    def _x_extend(self, tag, g, *lists):
        """Each list's values (the shards' or the x-columns') widened by
        their x-neighbours' g edge columns, in one exchange."""
        edges = []
        for xs in lists:
            edges += [([_cut(a, lambda a: a[..., a.shape[-1] - g:])
                        for a in xs], 1, "x"),
                      ([_cut(a, lambda a: a[..., :g]) for a in xs], -1, "x")]
        got = self._shift(tag, *edges)
        return [[_cut(a, lambda a: torch.cat([lg, a, rg], dim=-1))
                 for lg, a, rg in zip(got[2 * i], xs, got[2 * i + 1])]
                for i, xs in enumerate(lists)]

    # --- the per-shard pieces

    def _pick(self, kernel, plain):
        return plain if self.backend == "torch" else kernel

    def _collide(self, slabs):
        """B0 on the (f, force) slabs of one exchange (this rank's): the
        slabs that live on one device in one call, each f1 in the slabs'
        order."""
        collide = self._pick(collide_slabs, collide_slabs_reference)
        by_dev = {}
        for i, (f_slab, _) in enumerate(slabs):
            by_dev.setdefault(f_slab.device, []).append(i)
        out = [None] * len(slabs)
        for idx in by_dev.values():
            f1 = collide([slabs[i] for i in idx], self.cfg, self.forcing,
                         self.storage)
            for i, f1_slab in zip(idx, f1):
                out[i] = f1_slab
        return out

    def _b3(self, flags, f_loc, force, bhalo, thalo, expose_row=None):
        return self._pick(sharded_fused_substep,
                          sharded_fused_substep_reference)(
            flags, f_loc, force, bhalo, thalo, self.cfg, self.walls,
            self.forcing, self.storage, expose_row)

    def _band_force_rows(self, force, g0, count, lane=None):
        """The force of global rows [g0, g0 + count) (zero above the band)
        at the x-column's columns, or at its column `lane`."""
        band = self.cfg.force_band
        src = force if lane is None else force[:, :, lane:lane + 1]
        out = src.new_zeros((2, count, src.shape[2]))
        hi = min(g0 + count, band)
        if hi > g0:
            out[:, :hi - g0] = src[:, g0:hi]
        return out

    def _patch_x_seams(self, f_new, w_ext, e_ext, is_bottom, is_top, yl):
        """Pull the block's two edge columns again from the x-neighbours'
        f1 columns w_ext / e_ext ([9, yl + 2, 1]: the rows below and above
        the block included), in place; the wall fix-ups' cells keep the
        kernel's values (sharded.py:533-557)."""
        xl = f_new.shape[2]
        for d, ext, lane in ((1, w_ext, 0), (5, w_ext, 0), (8, w_ext, 0),
                             (3, e_ext, xl - 1), (6, e_ext, xl - 1),
                             (7, e_ext, xl - 1)):
            cy = int(CY[d])
            col = ext[d, 1 - cy:1 - cy + yl, 0]
            lo = 1 if d in (5, 6) and is_bottom else 0
            hi = yl - 1 if d in (7, 8) and is_top else yl
            f_new[d, lo:hi, lane] = col[lo:hi].to(f_new.dtype)
        return f_new

    @full_f32()
    def _flux_column(self, f_blk, force, y0, lane, rows):
        """The sum over the block's first `rows` rows of the half-force
        corrected u_x at its column `lane` (ImmersedBoundary.cu:249-264)."""
        cdt = torch.promote_types(f_blk.dtype, torch.float32)
        col_f = f_blk[:, :rows, lane].to(cdt)
        rho = col_f.sum(0)
        if self.storage == "deviatoric":
            rho = 1.0 + rho
        cx = torch.tensor(C[:, 0], dtype=cdt, device=col_f.device)
        mom = torch.einsum("iy,i->y", col_f, cx)
        fcol = self._band_force_rows(force.to(cdt), y0, rows, lane)[0, :, 0]
        return ((mom + 0.5 * fcol) / rho).sum()

    def _on(self, xs, device):
        return [x.to(device) for x in xs]

    # --- one step of every shard

    def _fluid_step(self, f, force, q, u_s, eps, anchored, s_pts):
        """Fluid + IB + flux of one step (sharded.py:561-667); s_pts, the
        raw positions, feed the quirk mode's stencil IB."""
        cfg, yl, xl = self.cfg, self.yl, self.xl
        n_y, n_x, band = self.n_y, self.n_x, cfg.force_band
        devs, mine = self.mesh.devices, self.mesh.mine
        ks = [k for k in range(len(self.shards)) if mine(k)]
        fo = self._to_shards("step/force", force)

        # edge-line f1 (bottom, top, and west, east on x-sharded meshes),
        # every shard's in one B0 call per device, exchanged in two phases
        # (x, then y with corners)
        slabs = []
        for k in ks:
            y0 = self.shards[k][0] * yl
            slabs += [(f[k][:, 0:1], self._band_force_rows(fo[k], y0, 1)),
                      (f[k][:, yl - 1:yl],
                       self._band_force_rows(fo[k], y0 + yl - 1, 1))]
            if n_x > 1:
                slabs += [(f[k][:, :, lane:lane + 1],
                           self._band_force_rows(fo[k], y0, yl, lane=lane))
                          for lane in (0, xl - 1)]
        f1 = self._collide(slabs)
        per = 4 if n_x > 1 else 2
        lines = [[None] * len(self.shards) for _ in range(per)]
        for j, k in enumerate(ks):
            for i in range(per):
                lines[i][k] = f1[j * per + i]
        f1_bot, f1_top = lines[0], lines[1]
        if n_x > 1:
            # from shard ix - 1 its east line, from shard ix + 1 its west
            w_halo, e_halo = self._shift("step/x_halos", (lines[3], 1, "x"),
                                         (lines[2], -1, "x"))
            ext_top, ext_bot = [None] * len(f), [None] * len(f)
            for k in ks:
                w, e = w_halo[k], e_halo[k]
                ext_top[k] = torch.cat([w[:, yl - 1:yl], f1_top[k],
                                        e[:, yl - 1:yl]], 2)
                ext_bot[k] = torch.cat([w[:, 0:1], f1_bot[k], e[:, 0:1]], 2)
        else:
            ext_top, ext_bot = f1_top, f1_bot
        # rows y0 - 1 and y0 + yl
        bhalo_ext, thalo_ext = self._shift("step/y_halos", (ext_top, 1, "y"),
                                           (ext_bot, -1, "y"))
        inner = slice(1, 1 + xl) if n_x > 1 else slice(0, xl)
        f_new = [None] * len(f)
        for k in ks:
            iy = self.shards[k][0]
            flags = (iy * yl, int(iy == 0), int(iy == n_y - 1))
            out = self._b3(flags, f[k], fo[k],
                           bhalo_ext[k][:, 0, inner].contiguous(),
                           thalo_ext[k][:, 0, inner].contiguous())[0]
            if n_x > 1:
                w_ext = torch.cat([bhalo_ext[k][:, :, 0:1], w_halo[k],
                                   thalo_ext[k][:, :, 0:1]], 1)
                e_ext = torch.cat([bhalo_ext[k][:, :, xl + 1:xl + 2],
                                   e_halo[k], thalo_ext[k][:, :, xl + 1:
                                                           xl + 2]], 1)
                self._patch_x_seams(out, w_ext, e_ext, iy == 0,
                                    iy == n_y - 1, yl)
            f_new[k] = out

        # IB: the shards' shares of the delta integrals (exactly zero
        # above the band), summed; each x-column spreads its own columns.
        # The quirk: every shard's share of the stencil interpolation
        # (each stencil cell is one shard's), summed (sharded.py:633-640)
        if self.ib_x_edge == "reference":
            f_s = self._psum("step/ib", [(_stencil_interp_block(
                f_new[k], s_pts.to(devs[k]), u_s.to(devs[k]), cfg, iy * yl,
                yl, ix * xl, xl, self.storage) if mine(k) else None, k)
                for k, (iy, ix) in enumerate(self.shards)])
            force_new = [_quirk_spread_block(
                f_s.to(devs[ix]), s_pts.to(devs[ix]), eps.to(devs[ix]), cfg,
                ix * xl, xl, band).to(self.aux_dtype) if mine(ix) else None
                for ix in range(n_x)]
        else:
            parts = [(ib_band.interpolate_partial(
                          f_new[k], cfg.xdim, band, iy * yl, ix * xl,
                          min(yl, band), self.storage,
                          self._on(anchored, devs[k])) if mine(k) else None,
                      k)
                     for k, (iy, ix) in enumerate(self.shards)
                     if iy * yl < band]
            f_s = ib_band.finish_interpolate(self._psum("step/ib", parts),
                                             u_s)
            force_new = [ib_band.spread_local(
                             f_s.to(devs[ix]), eps.to(devs[ix]), cfg.xdim,
                             band, ix * xl, xl, self._on(anchored, devs[ix])
                         ).to(self.aux_dtype) if mine(ix) else None
                         for ix in range(n_x)]

        # flux: the shards of the x-column that owns the flux column
        ixo, lane = divmod(cfg.flux_x, xl)
        col = [iy * n_x + ixo for iy in range(n_y)]
        fcol = self._to_shards("step/flux_force", force_new, col)
        contrib = [(self._flux_column(f_new[k], fcol[iy], iy * yl, lane, yl)
                    if mine(k) else None, k) for iy, k in enumerate(col)]
        return (f_new, force_new,
                q + self._psum("step/flux", contrib) / _FLUX_DIVISOR)

    def _steps(self, f, force, q, u_s, eps, anchor, frac, s_pts):
        for k in range(u_s.shape[0]):
            f, force, q = self._fluid_step(f, force, q, u_s[k], eps[k],
                                           (anchor[k], frac[k]), s_pts[k])
        return f, force, q

    def _run_steps(self, state: MeshState, n: int) -> MeshState:
        pos, u_s, eps, anchor, frac, s_pts = self.step_kinematics(state.it,
                                                                  n)
        f, force, q = self._steps(list(state.f), list(state.force), state.q,
                                  u_s, eps, anchor, frac, s_pts)
        return MeshState(f=f, force=force,
                         lasts=pos[-1].to(self.aux_dtype), q=q,
                         it=state.it + n)

    @full_f32()   # one pin per chunk around every step's contractions
    def run_chunk(self, state: MeshState, n_steps: int) -> MeshState:
        """n_steps iterations in pieces of <= 512 steps, each a multiple of
        K where it can be (sharded.py:370-381); the input state is not
        modified."""
        K = self.temporal
        while n_steps > 0:
            k = min(n_steps, self._MAX_CHUNK)
            if K > 1 and k >= K:
                k -= k % K
            state = self._run_steps(state, k)
            n_steps -= k
        return state


class ShardedTemporalSim(ShardedPallasSim):
    """K steps per halo exchange on a mesh of >= 2 shards: the band leg of
    ops/temporal.plan_sharded, then one B7 call per shard (the module
    docstring, sharded.py:730-791).  The remaining steps of a chunk
    (n mod K) run one at a time as ShardedPallasSim's."""

    def __init__(self, cfg: SimConfig, mesh: Mesh,
                 walls: ref.WallSpec = ref.REFERENCE_WALLS,
                 forcing: str = "trt_split", pattern: str = "no_mucus",
                 dtype=None, temporal: int = 8, backend: str = "auto",
                 ib_x_edge: str = "periodic"):
        super().__init__(cfg, mesh, walls, forcing, pattern, dtype, backend,
                         ib_x_edge)
        self.plan = plan_sharded(cfg, int(temporal), self.n_y, self.n_x,
                                 walls, self.dtype, pattern, ib_x_edge)
        self.temporal = self.temporal_requested = self.plan.K
        self._kernel_path = self.plan.band_leg

    # --- shared super-step plumbing

    def _bulk_ghosts(self, f):
        """The shards' bulk blocks (x-extended by 128 ghost columns on
        x-sharded meshes) and the ghost row blocks from their
        y-neighbours: the one exchange per K steps."""
        pad, yl = GHOST_PAD, self.yl
        f_x = (self._x_extend("bulk/x_ghosts", self.plan.xpad, f)[0]
               if self.plan.xpad else f)
        bot, top = self._shift(
            "bulk/y_ghosts",
            ([_cut(a, lambda a: a[:, yl - pad:]) for a in f_x], 1, "y"),
            ([_cut(a, lambda a: a[:, :pad]) for a in f_x], -1, "y"))
        return f_x, bot, top

    def _band_rows(self, f, rows):
        """Global rows [0, rows) of each x-column, on its rank and device
        (None for another rank's column): a view of shard (0, ix) where it
        holds them all, else joined from the column's shards (the band
        spans shards)."""
        yl, n_x, mine = self.yl, self.n_x, self.mesh.mine
        if rows <= yl:
            return [f[ix][:, :rows] if mine(ix) else None
                    for ix in range(n_x)]
        n_blk = -(-rows // yl)
        got = self._move("band/rows", [
            (_cut(f[iy * n_x + ix], lambda a: a[:, :min(yl, rows - iy * yl)]),
             iy * n_x + ix, ix)
            for ix in range(n_x) for iy in range(n_blk)])
        return [torch.cat(got[ix * n_blk:(ix + 1) * n_blk], dim=1)
                if mine(ix) else None for ix in range(n_x)]

    def _run_bulk(self, f_x, bot, top, bhalos, band_new):
        """One B7 call per shard, with its flags (sharded.py:1065-1100),
        then the band rows it holds put back from the band leg's output
        band_new[ix].  Returns (the shards' new blocks, their flux sums)."""
        cfg, yl, xl, n_y = self.cfg, self.yl, self.xl, self.n_y
        band, pad, xpad = cfg.force_band, GHOST_PAD, self.plan.xpad
        ghost = self._pick(ghost_temporal, ghost_temporal_reference)
        n, n_x, mine = len(self.shards), self.n_x, self.mesh.mine

        def lb(iy):
            return min(max(band - iy * yl, 0), yl)
        # each shard's seam halos and the band rows it holds, from its
        # x-column, in one exchange
        items = [(bhalos[k % n_x], k % n_x, k) for k in range(n)]
        back = []
        for k, (iy, ix) in enumerate(self.shards):
            if lb(iy):
                back.append(k)
                items.append((_cut(band_new[ix], lambda a: a[
                    :, iy * yl:iy * yl + lb(iy)]), ix, k))
        got = self._move("bulk/band_back", items)
        bh, rows_back = got[:n], dict(zip(back, got[n:]))
        f_new, flux = [None] * n, [None] * n
        for k, (iy, ix) in enumerate(self.shards):
            if not mine(k):
                continue
            y0, x0 = iy * yl, ix * xl
            owned = x0 <= cfg.flux_x < x0 + xl
            flags = (int(y0 <= band < y0 + yl), int(iy == n_y - 1),
                     pad + lb(iy),
                     xpad + min(max(cfg.flux_x - x0, 0), xl - 1), int(owned))
            block, fl = ghost(flags, f_x[k], bot[k], top[k], bh[k], cfg,
                              self.walls, self.forcing, self.storage)
            mid = block[:, pad:pad + yl, xpad:xpad + xl].contiguous()
            if lb(iy):
                mid[:, :lb(iy)] = rows_back[k].to(mid.dtype)
            f_new[k] = mid
            flux[k] = fl.sum()
        return f_new, flux

    def _q_plus(self, tag, q, cols, shards):
        """q plus the sum of the x-columns' flux sums `cols` (ix, value)
        and the shards' `shards`, in that order."""
        parts = cols + list(enumerate(shards))
        return q + self._psum(tag, [(v, k) for k, v in parts]) \
            / _FLUX_DIVISOR

    # --- the band legs

    def _super_band_super(self, f, force, q, xs):
        """n_x = 1: one B5 or B6 call on the extended band (sharded.py:
        913-984), once for the mesh, by the rank of shard 0."""
        p, cfg = self.plan, self.cfg
        f_x, bot, top = self._bulk_ghosts(f)
        f_ext = self._band_rows(f, cfg.force_band + p.pad_s)[0]
        f_band = bhalos = force_new = flux_band = None
        if self.mesh.mine(0):
            args = (f_ext, force[0], *xs, cfg, p.halo)
            tail = (self.walls, self.forcing, self.storage)
            if p.band_leg == "band_super_xtiled":
                f_band, bhalos, force_new, flux_band = self._pick(
                    band_super_tiled, band_super_tiled_reference)(
                    *args, p.tile_x, p.gx, *tail)
            else:
                f_band, bhalos, force_new, flux_band = self._pick(
                    band_super, band_super_reference)(*args, *tail)
            force_new = force_new.to(self.aux_dtype)
            flux_band = flux_band.sum()
        f_new, flux_bulk = self._run_bulk(f_x, bot, top, [bhalos], [f_band])
        q = self._q_plus("band/flux", q, [(0, flux_band)], flux_bulk)
        return f_new, [force_new], q

    def _super_xsharded(self, f, force, q, xs):
        """n_x > 1: one B8 call per x-column on its band block widened by
        gx ghost columns (sharded.py:1102-1190)."""
        p, cfg, xl = self.plan, self.cfg, self.xl
        lay = p.xshard
        devs, n_x = self.mesh.devices, self.n_x
        f_x, bot, top = self._bulk_ghosts(f)
        blk = self._band_rows(f, cfg.force_band + p.pad_s)
        blk_e, force_e = self._x_extend("band/x_ghosts", lay.gx, blk, force)
        inner = slice(lay.gx, lay.gx + xl)
        f_band, bh, force_new, flux_band = ([None] * n_x for _ in range(4))
        for ix in range(n_x):
            if not self.mesh.mine(ix):
                continue
            x0 = ix * xl
            owned = x0 <= cfg.flux_x < x0 + xl
            lane = min(max(cfg.flux_x - x0, 0), xl - 1) + lay.gx
            pts = shard_points(lay, self._on(xs, devs[ix]), cfg, ix, xl)
            fb, bhe, fo, fl = self._pick(
                band_super_xsharded, band_super_xsharded_reference)(
                (lane, int(owned)), blk_e[ix], force_e[ix], *pts, cfg, lay,
                self.walls, self.forcing, self.storage)
            f_band[ix] = fb[..., inner]
            bh[ix] = bhe[..., inner]
            force_new[ix] = fo[..., inner].to(self.aux_dtype).contiguous()
            flux_band[ix] = fl.sum()
        bhalos = self._x_extend("band/x_halos", p.xpad, bh)[0]
        f_new, flux_bulk = self._run_bulk(f_x, bot, top, bhalos, f_band)
        q = self._q_plus("band/flux", q, list(enumerate(flux_band)),
                         flux_bulk)
        return f_new, force_new, q

    def _band_substep_x(self, blk, force):
        """One sub-step of each x-column's band block through B3
        (sharded.py:990-1028): bottom wall, zero rows above (the ghost
        trapezoid), the seam row band-1 exposed; on x-sharded meshes the
        edge columns pulled again from the neighbours' f1 columns (B0)."""
        cfg, xl, n_x = self.cfg, self.xl, self.n_x
        rows = cfg.force_band + self.plan.pad_b
        cols = [ix for ix in range(n_x) if self.mesh.mine(ix)]
        if n_x > 1:
            # both seam columns of this rank's x-columns in one B0 call per
            # device
            f1 = self._collide([
                (blk[ix][:, :, lane:lane + 1],
                 self._band_force_rows(force[ix], 0, rows, lane=lane))
                for ix in cols for lane in (0, xl - 1)])
            f1_w, f1_e = [None] * n_x, [None] * n_x
            for j, ix in enumerate(cols):
                f1_w[ix], f1_e[ix] = f1[2 * j], f1[2 * j + 1]
            w_halo, e_halo = self._shift("sub/x_halos", (f1_e, 1, "x"),
                                         (f1_w, -1, "x"))

            def ext(h):   # end rows repeated: only wall-kept cells read them
                return torch.cat([h[:, 0:1], h, h[:, rows - 1:rows]], dim=1)

        new, bhs = [None] * n_x, [None] * n_x
        for ix in cols:
            out, bh, _, _ = self._b3((0, 1, 0), blk[ix], force[ix], None,
                                     None, cfg.force_band - 1)
            if n_x > 1:
                self._patch_x_seams(out, ext(w_halo[ix]), ext(e_halo[ix]),
                                    True, False, rows)
            new[ix], bhs[ix] = out, bh
        return new, bhs

    def _super_tiled(self, f, force, q, u_s, eps, anchor, frac, s_pts):
        """The per-sub-step leg (sharded.py:1192-1282): K B3 sub-steps of
        each x-column's band block with the sharded IB after each, then
        the bulk.  The quirk's stencil IB (sharded.py:1237-1249) takes each
        x-column's band block, rows [0, band + pad_b) (every stencil cell
        lies below the ghost rows), summed over the x-columns only: the
        band leg runs once per x-column, where JAX's y-shards hold the
        same block and sum over 'x'."""
        cfg, xl, n_x = self.cfg, self.xl, self.n_x
        band, K, devs = cfg.force_band, self.temporal, self.mesh.devices
        mine = self.mesh.mine
        ext = band + self.plan.pad_b
        f_x, bot, top = self._bulk_ghosts(f)
        blk = self._band_rows(f, ext)
        force = [_cut(x, lambda x: x.to(self.aux_dtype)) for x in force]
        ixo, lane = divmod(cfg.flux_x, xl)
        bhs = [[] for _ in range(n_x)]
        flux_band = []
        for s in range(K):
            blk, bh = self._band_substep_x(blk, force)
            if self.ib_x_edge == "reference":
                f_s = self._psum("sub/ib", [(_stencil_interp_block(
                    blk[ix], s_pts[s].to(devs[ix]), u_s[s].to(devs[ix]), cfg,
                    0, ext, ix * xl, xl, self.storage) if mine(ix) else None,
                    ix) for ix in range(n_x)])
                force = [_quirk_spread_block(
                    f_s.to(devs[ix]), s_pts[s].to(devs[ix]),
                    eps[s].to(devs[ix]), cfg, ix * xl, xl, band
                ).to(self.aux_dtype) if mine(ix) else None
                    for ix in range(n_x)]
            else:
                anchored = (anchor[s], frac[s])
                parts = [(ib_band.interpolate_partial(
                              blk[ix], cfg.xdim, band, 0, ix * xl, band,
                              self.storage, self._on(anchored, devs[ix]))
                          if mine(ix) else None, ix) for ix in range(n_x)]
                f_s = ib_band.finish_interpolate(self._psum("sub/ib", parts),
                                                 u_s[s])
                force = [ib_band.spread_local(
                             f_s.to(devs[ix]), eps[s].to(devs[ix]), cfg.xdim,
                             band, ix * xl, xl, self._on(anchored, devs[ix])
                         ).to(self.aux_dtype) if mine(ix) else None
                         for ix in range(n_x)]
            if mine(ixo):
                flux_band.append(self._flux_column(blk[ixo], force[ixo], 0,
                                                   lane, band))
            for ix in range(n_x):
                bhs[ix].append(bh[ix])
        bhalos = [torch.stack(b) if mine(ix) else None
                  for ix, b in enumerate(bhs)]
        if n_x > 1:
            bhalos = self._x_extend("sub/x_halos_k", self.plan.xpad,
                                    bhalos)[0]
        f_new, flux_bulk = self._run_bulk(
            f_x, bot, top, bhalos, [_cut(b, lambda b: b[:, :band])
                                    for b in blk])
        flux = _sum_in_order(flux_band, self.device) if mine(ixo) else None
        q = self._q_plus("sub/flux", q, [(ixo, flux)], flux_bulk)
        return f_new, force, q

    def _steps(self, f, force, q, u_s, eps, anchor, frac, s_pts):
        """Whole super-steps, then the remainder one step at a time
        (sharded.py:1284-1333)."""
        K, p = self.temporal, self.plan
        n_super, rem = divmod(u_s.shape[0], K)
        nk = n_super * K
        if n_super and p.band_leg == "per_substep_tiled":
            for i in range(n_super):
                sl = slice(i * K, (i + 1) * K)
                f, force, q = self._super_tiled(f, force, q, u_s[sl],
                                                eps[sl], anchor[sl],
                                                frac[sl], s_pts[sl])
        elif n_super:
            xs_all = prep_band_super_points(
                self.cfg, K, p.halo, self.aux_dtype, u_s[:nk], eps[:nk],
                anchor[:nk], frac[:nk], n_super)
            body = (self._super_xsharded if p.xshard is not None
                    else self._super_band_super)
            for i in range(n_super):
                f, force, q = body(f, force, q, [x[i] for x in xs_all])
        if rem:
            f, force, q = super()._steps(f, force, q, u_s[nk:], eps[nk:],
                                         anchor[nk:], frac[nk:], s_pts[nk:])
        return f, force, q
