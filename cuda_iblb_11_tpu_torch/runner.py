"""Run loop — the port of cuda_iblb_11_tpu/runner.py: interval-chunked
execution, the flux series, optional field + cilia snapshots (overlapped
with the next chunk), SimLog with the resolved configuration and the
completion estimate, and checkpoint/resume; on one device or, with
``mesh="Y,X"`` (or "auto"), on a mesh of shards (parallel/sharded.py).
Checkpoints are the global state in npz (``checkpoint_format="npz"``) or
the sharded directory (``"orbax"``, JAX's name for its own: io/
checkpoint.save_dir, at raw_dir/checkpoint_orbax); ``resume_from`` takes
either, a directory by its being one.

Under a process group (--distributed: parallel/dist.py) every rank runs
the loop on its own shards, and rank 0 alone writes Flux, SimLog, the
snapshots, npz checkpoints and the profile trace, and prints; snapshots
and npz checkpoints gather the state to it, and the directory checkpoint
is written by every rank.  (JAX's runner has no such guard: every process
writes the same files.)

The output files come from the port's copy of the JAX package's writers
(io/writers.py, io/native.py), so both packages write the same bytes for
the same values.  ``profile_dir`` traces the first interval with
torch.profiler (a Chrome trace, PROFILE_TRACE, in that directory).
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.io.writers import (
    FluxWriter, OutputPaths, SimLog, write_cilia_snapshot,
    write_cilia_snapshot_npz, write_fluid_snapshot,
    write_fluid_snapshot_npz,
)
from cuda_iblb_11_tpu_torch.utils import spans
from cuda_iblb_11_tpu_torch.utils.timing import (
    ThroughputMeter, predict_completion, seconds,
)
from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)
from cuda_iblb_11_tpu_torch.ops.temporal import AUTO_LADDER
from cuda_iblb_11_tpu_torch.parallel import dist
from cuda_iblb_11_tpu_torch.parallel.sharded import (
    MeshState, ShardedPallasSim, ShardedTemporalSim, make_mesh,
    visible_devices,
)


class _Discard:
    """Stands in for the output writers on ranks other than 0: every call
    does nothing (rank 0 writes every output file)."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class _SnapshotPipeline:
    """Interval snapshots written on one worker thread while the next chunk
    runs on the device (the reference's output stream, main.cu:793-809).

    ``stage`` starts the device-to-host copies of fields computed from the
    pre-chunk state and records an event after them; the copies are
    enqueued before the chunk, so they do not wait for it.  ``submit``
    hands the staged arrays to the worker, which waits for the event and
    writes; at most one write is outstanding, and a worker error surfaces
    at the next submit or at close.  With overlap off, ``write_sync``
    writes inline.  The bytes are the same either way."""

    def __init__(self, paths: OutputPaths, cfg: SimConfig,
                 fmt: str = "dat", overlap: bool = True):
        if fmt == "npz":
            self._fluid, self._cilia = (write_fluid_snapshot_npz,
                                        write_cilia_snapshot_npz)
            self._ext = ".npz"
        else:
            from cuda_iblb_11_tpu_torch.io import native

            self._fluid = (native.write_fluid_snapshot if native.available()
                           else write_fluid_snapshot)
            self._cilia = (native.write_cilia_snapshot if native.available()
                           else write_cilia_snapshot)
            self._ext = ".dat"
        self.paths, self.cfg, self.overlap = paths, cfg, overlap
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="iblb-snap")
                      if overlap else None)
        self._pending = None

    @staticmethod
    def stage(rho, u, s, u_s, eps):
        """(host tensors, completion event or None) for one snapshot."""
        arrays = (rho, u, s, u_s, eps)
        if rho.device.type != "cuda":
            return arrays, None
        host = tuple(a.to("cpu", non_blocking=True) for a in arrays)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _write(self, it, staged):
        host, event = staged
        if event is not None:
            event.synchronize()
        rho, u, s, u_s, eps = (a.numpy() for a in host)
        self._fluid(os.path.join(self.paths.raw_dir,
                                 f"{it}-fluid{self._ext}"),
                    self.cfg, rho, u)
        self._cilia(os.path.join(self.paths.cilia_dir,
                                 f"{it}-cilia{self._ext}"),
                    self.cfg, s, u_s, eps)

    def submit(self, it, staged):
        if self._pending is not None:
            self._pending.result()  # re-raises worker errors
        self._pending = self._pool.submit(self._write, it, staged)

    def write_sync(self, it, staged):
        self._write(it, staged)

    def close(self):
        try:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


# ``--overlap auto`` writes text snapshots inline on hosts with at most
# this many usable cores, where formatting competes with the step loop for
# the only core (the JAX package's rule, measured on its 1-core TPU host,
# validation/bigdata_e2e.json), and overlapped everywhere else.  The card
# host's record, cuda_iblb_11_tpu_torch/records/bigdata_e2e.json
# (measure_bigdata.py: 2048^2 f32 at temporal auto, 10,000 steps, 10
# snapshot pairs, each configuration twice in turns, every write timed,
# on an 8-core host with an NVIDIA H100 80GB HBM3 at 700.00 W), holds
# both formats faster overlapped: an overlapped run lasts its writes plus
# 0.1-0.2 s (text) or 0.4-0.5 s (npz), a serial run its writes plus
# 0.9-1.0 s, the compute the overlap hides.  The text writes themselves
# vary by up to 10% in CPU time between runs, in both settings alike, so
# whole text runs fall in either order.
SERIAL_TEXT_MAX_CORES = 2


def _resolve_overlap(overlap, snapshot_format: str):
    """``--overlap auto``: overlapped, except text snapshots on a host with
    at most SERIAL_TEXT_MAX_CORES usable cores.  Returns (bool, reason)."""
    if isinstance(overlap, bool):
        return overlap, "requested"
    if overlap == "on":
        return True, "requested"
    if overlap == "off":
        return False, "requested"
    if overlap != "auto":
        raise ValueError(f"overlap must be a bool or one of "
                         f"auto/on/off, got {overlap!r}")
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    if snapshot_format == "dat" and cores <= SERIAL_TEXT_MAX_CORES:
        return False, (f"auto: serial — text formatting on a {cores}-core "
                       f"host competes with the step loop")
    return True, "auto: overlapped — the snapshot write rides under the " \
                 "next chunk"


def _select_device(cfg: SimConfig, device) -> torch.device:
    """The run's device.  The ShARC flag picks device 3 (main.cu:395-396)
    for a CUDA run on a host with more than 3 cards, else warns."""
    device = resolve_device(device)
    if not cfg.sharc or device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n > 3:
        return torch.device("cuda", 3)
    print(f"warning: ShARC flag requests device 3 but only {n} device(s) "
          f"are visible; using {device}", file=sys.stderr)
    return device


def _last_simlog_temporal_k(simlog_path: str) -> int | None:
    """The most recent 'Temporal K:' value in an existing SimLog."""
    last = None
    try:
        with open(simlog_path) as fh:
            for line in fh:
                if line.startswith("Temporal K:"):
                    tok = line.split(":", 1)[1].strip().split()[0]
                    try:
                        last = int(tok)
                    except ValueError:
                        pass
    except FileNotFoundError:
        pass
    return last


def _resume_flux_rows(flux_path: str, cfg: SimConfig, it0: int,
                      interval: int) -> int:
    """Leading flux rows still valid at a resume from step it0, kept by
    time stamp (the saving run's interval may differ); a row at exactly
    it0 is kept only when it0 is not a boundary of the new interval."""
    t0 = it0 * cfg.t_scale
    stamp_tol = max(0.5 * cfg.t_scale, 2e-6 * t0)
    keep = 0
    prev = None
    try:
        with open(flux_path) as fh:
            for line in fh:
                try:
                    t = float(line.split()[0])
                except (ValueError, IndexError):
                    break
                spacing = t - prev if prev is not None else cfg.t_scale
                tol = min(stamp_tol,
                          max(0.45 * spacing, 0.45 * cfg.t_scale))
                if t < t0 - tol or (abs(t - t0) <= tol and it0 % interval):
                    keep += 1
                    prev = t
                else:
                    break
    except FileNotFoundError:
        pass
    return keep


PROFILE_TRACE = "trace.json"   # the --profile-dir trace's file name


class _FirstIntervalTrace:
    """torch.profiler over the run's first interval, as the JAX runner
    traces it (runner.py:423-426, 598-605): CPU activity, and the card's
    where the run is on one, with the model step's host spans
    (utils/spans.py) recorded, so the trace holds them as ``iblb.`` ranges
    on the profiler's clock; ``stop`` writes a Chrome trace into
    ``profile_dir`` and says so unless quiet."""

    def __init__(self, profile_dir: str, device: torch.device, quiet: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        self.profile_dir, self.quiet = profile_dir, quiet
        self.prof = profile(activities=acts)
        self.prof.start()
        spans.start()

    def stop(self) -> None:
        if self.prof is None:
            return
        spans.stop()
        self.prof.stop()
        self.prof.export_chrome_trace(os.path.join(self.profile_dir,
                                                   PROFILE_TRACE))
        self.prof = None
        if not self.quiet:
            print(f"Profiler trace written to {self.profile_dir}")


def _sync(sim) -> None:
    devices = sim.mesh.devices if hasattr(sim, "mesh") else [sim.device]
    for device in set(devices):
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)


def _resolve_auto_mesh(cfg: SimConfig, device: torch.device, comm=None):
    """``--mesh auto`` (JAX runner.py:142-189) over the visible devices of
    the run's type, or under a process group over the world's cards (one
    a rank): the first factorization (n_y, n_x) of their number, balanced
    shapes first and x-major on ties, that divides the grid.  Returns
    (mesh string or None for unsharded, reason)."""
    n = comm.world if comm is not None else len(
        visible_devices(device.type))
    if n <= 1:
        return None, "auto: single visible device — unsharded"
    cands = [(y, n // y) for y in range(1, n + 1) if n % y == 0]
    cands.sort(key=lambda t: (abs(t[0] - t[1]), -t[1]))
    for ny, nx in cands:
        if cfg.ydim % ny == 0 and cfg.xdim % nx == 0:
            return f"{ny},{nx}", (
                f"auto: ({ny},{nx}) over {n} devices — balanced-first, "
                f"x-major on ties; shard tile {cfg.ydim // ny}x"
                f"{cfg.xdim // nx}")
    return None, (f"auto: no factorization of {n} devices divides the "
                  f"{cfg.ydim}x{cfg.xdim} grid — unsharded")


def _make_mesh_sim(cfg, backend, forcing, temporal, mesh, ib_x_edge,
                   pattern, device, comm=None):
    """The sharded sim for ``mesh`` "Y,X" over the visible devices of the
    run's type (under a process group, comm: over the ranks), as JAX
    runner.py:209-283 resolves it: temporal "auto"
    takes the largest K of (16, 8, 4, 2) whose ShardedTemporalSim applies
    on the cuda backend (none on the torch backend, as on one device), else
    ShardedPallasSim with the reason; K > 1 takes ShardedTemporalSim(K),
    or warns and steps one at a time; 1 takes ShardedPallasSim."""
    parts = [int(v) for v in str(mesh).split(",")]
    if len(parts) != 2 or min(parts) < 1:
        raise ValueError(f"--mesh must be 'Y,X' positive ints, got {mesh!r}")
    m = make_mesh(*parts, devices=visible_devices(device.type), comm=comm)
    kw = dict(forcing=forcing, pattern=pattern, backend=backend,
              ib_x_edge=ib_x_edge)
    per_step = ShardedPallasSim(cfg, m, **kw)
    if temporal == "auto":
        per_step.temporal_requested = "auto"
        if per_step.backend != "cuda":
            per_step.temporal_reason = (
                f"auto: backend {per_step.backend!r} has no temporal path")
            return per_step
        err = None
        for K in AUTO_LADDER:
            try:
                sim = ShardedTemporalSim(cfg, m, temporal=K, **kw)
            except ValueError as e:
                err = e
                continue
            sim.temporal_requested = "auto"
            sim.temporal_reason = f"auto: K={K} (largest eligible sharded)"
            return sim
        per_step.temporal_reason = (f"auto: no eligible K for the sharded "
                                    f"temporal path ({err})")
        return per_step
    if int(temporal) < 1:
        raise ValueError(f"temporal K must be >= 1, got {temporal}")
    if int(temporal) > 1:
        try:
            return ShardedTemporalSim(cfg, m, temporal=int(temporal), **kw)
        except ValueError as e:
            print(f"warning: --temporal {temporal} with --mesh {mesh} is "
                  f"not eligible for the K-step sharded path ({e}); falling "
                  f"back to the per-step sharded kernel", file=sys.stderr)
    return per_step


def run(cfg: SimConfig, output_root: str = "Data/Test", backend: str = "auto",
        forcing: str = "trt_split", resume_from: str | None = None,
        checkpoint_every: int = 0, quiet: bool = False,
        profile_dir: str | None = None, temporal: int | str = 1,
        mesh: str | None = None, ib_x_edge: str = "periodic",
        checkpoint_format: str = "npz", pattern: str = "no_mucus",
        snapshot_format: str = "dat", overlap: bool | str = "auto",
        device="cuda") -> dict:
    """Execute cfg.iterations steps with interval outputs on `device`.
    Returns a summary dict (runtime, MLUPS incl. end-to-end, final Q).
    Under a process group (dist.init_from_env) every rank calls it, with
    the same arguments."""
    if checkpoint_format not in ("npz", "orbax"):
        raise ValueError(f"checkpoint_format must be npz or orbax, got "
                         f"{checkpoint_format!r}")
    cfg.validate()
    comm = dist.current()
    root = comm is None or comm.rank == 0
    quiet = quiet or not root
    mesh_reason = None
    if comm is not None:
        if torch.device(device).type != comm.device.type:
            raise ValueError(f"the process group runs on {comm.device}, "
                             f"the run asks for {device}")
        device = comm.device
    if mesh == "auto":
        mesh, mesh_reason = _resolve_auto_mesh(cfg, resolve_device(device),
                                               comm)
    if comm is not None and comm.world > 1 and not mesh:
        raise ValueError(f"a run of {comm.world} ranks needs a mesh of "
                         f"shards (--mesh Y,X)"
                         + (f"; --mesh auto: {mesh_reason}" if mesh_reason
                            else ""))
    # a mesh spreads over the visible devices; ShARC pins one device
    device = resolve_device(device) if mesh or comm \
        else _select_device(cfg, device)
    overlap, overlap_reason = _resolve_overlap(overlap, snapshot_format)
    if mesh:
        sim = _make_mesh_sim(cfg, backend, forcing, temporal, mesh,
                             ib_x_edge, pattern, device, comm)
    else:
        sim = MucociliarySim(cfg, backend=backend, forcing=forcing,
                             temporal=temporal, ib_x_edge=ib_x_edge,
                             pattern=pattern, device=device)

    paths = OutputPaths(output_root, cfg)
    if root:
        paths.makedirs()
    interval = max(cfg.interval, 1)
    simlog = SimLog(paths.simlog_path, cfg) if root else _Discard()
    resolved = sim.resolved_config()
    extra = {"Backend": backend, "Forcing": forcing,
             "Dtype": resolved["dtype"]}
    if pattern != "no_mucus":
        extra["Pattern"] = pattern
    if mesh_reason is not None:
        extra["Mesh"] = (f"{sim.mesh.describe() if mesh else 'unsharded'} "
                         f"({mesh_reason})")
    elif mesh:
        extra["Mesh"] = sim.mesh.describe()
    extra["Device"] = (f"{device} ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else str(device))
    extra["Resolved backend"] = resolved["backend"] + (
        f" ({resolved['backend_reason']})"
        if resolved["backend_reason"] else "")
    if resolved.get("distributed"):
        d = resolved["distributed"]
        extra["Distributed"] = (f"{d['world']} rank(s), transport "
                                f"{d['transport']}; rank 0 writes")
    extra["Kernel path"] = resolved["band_leg"]
    extra["Storage"] = resolved["storage"]
    extra["IB path"] = resolved["ib_path"]
    if cfg.bigdata:
        extra["Snapshot overlap"] = (
            f"{'on' if overlap else 'off'} ({overlap_reason})")
    extra["Temporal K"] = resolved["temporal"]
    if resolved["temporal_requested"] == "auto":
        extra["Temporal K"] = (
            f"{resolved['temporal']} ({resolved['temporal_reason']})")
    if not quiet:
        print(f"Execution: backend={extra['Resolved backend']} "
              f"kernel={resolved['band_leg']} "
              f"storage={resolved['storage']} "
              f"temporal={resolved['temporal']} "
              f"ib={resolved['ib_path']} device={extra['Device']}")

    if resume_from:
        if os.path.isdir(resume_from):    # the sharded directory format
            state, _ = ckpt.load_dir(resume_from, cfg,
                                     sim=sim if mesh else None,
                                     device=sim.device)
        else:
            state, _ = ckpt.load(resume_from, cfg, device=sim.device)
            if mesh:
                state = sim.place_state(state)    # cut onto the mesh
        if not mesh and state.force.shape[1] == cfg.ydim:
            # jnp-mesh checkpoints keep the force full-size; this layout
            # is band-only (zero above the band by construction)
            state = state._replace(
                force=state.force[:, :cfg.force_band].contiguous())
        it0 = state.it
        if root:
            keep = _resume_flux_rows(paths.flux_path, cfg, it0, interval)
            flux = FluxWriter(paths.flux_path, cfg, keep_rows=keep)
        else:
            flux = _Discard()
        prev_k = _last_simlog_temporal_k(paths.simlog_path)
        simlog.write_resume_note(it0)
        if prev_k is not None and prev_k != int(resolved["temporal"]):
            note = (f"NOTE: resumed with temporal K={resolved['temporal']} "
                    f"(original run: K={prev_k}) — different kernel path, "
                    f"not bit-identical across the switch")
            simlog.write_extra({"Resume": note})
            if not quiet:
                print(f"warning: {note}", file=sys.stderr)
        simlog.write_extra({k: v for k, v in extra.items()
                            if k.startswith(("Resolved", "Kernel", "Device",
                                             "Storage", "IB path",
                                             "Temporal", "Mesh",
                                             "Distributed"))})
        if not quiet:
            print(f"Resumed from {resume_from} at it={it0}")
    else:
        state = sim.init_state()
        flux = FluxWriter(paths.flux_path, cfg) if root else _Discard()
        simlog.write_header(extra=extra)
    meter = ThroughputMeter(cells=cfg.size)
    start_epoch = time.time()
    t_start = seconds()
    if not quiet:
        print("Running Simulation...")

    it_start = state.it
    snap = _SnapshotPipeline(paths, cfg, fmt=snapshot_format,
                             overlap=overlap)
    trace = (_FirstIntervalTrace(profile_dir, device, quiet)
             if profile_dir and root else None)
    try:
        state = _loop(cfg, sim, snap, flux, meter, simlog, interval, quiet,
                      checkpoint_every, paths, start_epoch, t_start, state,
                      trace, checkpoint_format)
    finally:
        snap.close()
        if trace is not None:   # a run shorter than one interval
            trace.stop()
    it = state.it

    # final flux row after the loop (main.cu:1030-1034)
    flux.append(it, float(state.q))
    runtime = seconds() - t_start
    simlog.write_runtime(runtime)
    steps_run = max(it - it_start, 0)
    mlups_e2e = (cfg.size * steps_run / runtime / 1e6) if runtime > 0 else 0.0
    simlog.write_extra({"End-to-end MLUPS (incl. interval I/O)":
                        f"{mlups_e2e:.1f}"})
    summary = {
        "iterations": it,
        "runtime_s": runtime,
        "mlups": meter.mlups,
        "mlups_end_to_end": mlups_e2e,
        "q_final": float(state.q),
        "flux_path": paths.flux_path,
        "resolved": resolved,
        "device": extra["Device"],
        "snapshot_overlap": overlap,
        "snapshot_overlap_reason": overlap_reason,
    }
    if not quiet:
        print(f"Total runtime: {runtime:.2f}s  ({meter.mlups:.1f} MLUPS "
              f"compute, {mlups_e2e:.1f} end-to-end)")
    return summary


def _loop(cfg, sim, snap, flux, meter, simlog, interval, quiet,
          checkpoint_every, paths, start_epoch, t_start, state, trace=None,
          checkpoint_format="npz"):
    """The interval loop (JAX runner.py:569-630); returns the final state.
    ``trace`` (a _FirstIntervalTrace or None) stops after the first
    interval."""
    it = state.it
    first_interval_logged = it > 0
    last_ckpt = it
    while it < cfg.iterations:
        # output at the start of each interval boundary (main.cu:938)
        boundary = it % interval == 0
        staged = None
        if boundary:
            if cfg.bigdata:
                # fields of the pre-chunk state (gathered to rank 0 on a
                # process group); their host copies are enqueued before
                # the chunk
                fields = sim.fields(state)
                if fields is not None:
                    staged = snap.stage(*fields,
                                        *sim.boundary_fields(state))
                    if not snap.overlap:
                        snap.write_sync(it, staged)
            flux.append(it, float(state.q))

        n = min(interval - it % interval, cfg.iterations - it)
        meter.start()
        state = sim.run_chunk(state, n)
        if staged is not None and snap.overlap:
            snap.submit(it, staged)
        _sync(sim)
        meter.stop(n)
        it = state.it

        if trace is not None and it >= interval:
            trace.stop()

        if not first_interval_logged and it >= interval:
            pred = predict_completion(
                start_epoch, seconds() - t_start, cfg.iterations // interval)
            simlog.write_completion_estimate(pred)
            if not quiet:
                print("Completion time:",
                      time.asctime(time.localtime(pred)))
            first_interval_logged = True

        # "every N iterations" tracked against the last save: the loop
        # stops only on interval boundaries
        if checkpoint_every and it - last_ckpt >= checkpoint_every:
            mesh_sim = sim if isinstance(state, MeshState) else None
            if checkpoint_format == "orbax":
                ckpt.save_dir(os.path.join(paths.raw_dir,
                                           "checkpoint_orbax"),
                              state, cfg, mesh_sim)
            else:
                whole = sim.gather_state(state) if mesh_sim else state
                if whole is not None:      # rank 0's (or the only) state
                    ckpt.save(os.path.join(paths.raw_dir,
                                           "checkpoint.npz"), whole, cfg)
            last_ckpt = it
    return state
