"""Run loop — the port of cuda_iblb_11_tpu/runner.py for the single-device
path: interval-chunked execution, the flux series, optional field + cilia
snapshots (overlapped with the next chunk), SimLog with the resolved
configuration and the completion estimate, and npz checkpoint/resume.

The output files come from the port's copy of the JAX package's writers
(io/writers.py, io/native.py), so both packages write the same bytes for
the same values.  --mesh, orbax checkpoints and
--profile-dir are not ported yet and raise.
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
from cuda_iblb_11_tpu_torch.utils.timing import (
    ThroughputMeter, predict_completion, seconds,
)
from cuda_iblb_11_tpu_torch.io import checkpoint as ckpt
from cuda_iblb_11_tpu_torch.models.mucociliary import (
    MucociliarySim, resolve_device,
)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not yet ported to the torch "
                               f"package ({item})")


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


def _resolve_overlap(overlap, snapshot_format: str):
    """``--overlap auto``: overlapped, except text snapshots on a host with
    at most 2 usable cores, where formatting competes with the step loop.
    The policy is the JAX package's (measured there on its TPU host,
    validation/bigdata_e2e.json); it has not been measured on a GPU host.
    Returns (bool, reason)."""
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
    if snapshot_format == "dat" and cores <= 2:
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: SimConfig, output_root: str = "Data/Test", backend: str = "auto",
        forcing: str = "trt_split", resume_from: str | None = None,
        checkpoint_every: int = 0, quiet: bool = False,
        profile_dir: str | None = None, temporal: int | str = 1,
        mesh: str | None = None, ib_x_edge: str = "periodic",
        checkpoint_format: str = "npz", pattern: str = "no_mucus",
        snapshot_format: str = "dat", overlap: bool | str = "auto",
        device="cuda") -> dict:
    """Execute cfg.iterations steps with interval outputs on `device`.
    Returns a summary dict (runtime, MLUPS incl. end-to-end, final Q)."""
    if mesh:
        raise _not_ported("--mesh", "ROADMAP Queue 1 item 12")
    if checkpoint_format != "npz":
        raise _not_ported(f"{checkpoint_format} checkpoints",
                          "ROADMAP Queue 1 item 12")
    if profile_dir:
        raise _not_ported("--profile-dir", "ROADMAP Queue 1 item 2")
    cfg.validate()
    device = _select_device(cfg, device)
    overlap, overlap_reason = _resolve_overlap(overlap, snapshot_format)
    sim = MucociliarySim(cfg, backend=backend, forcing=forcing,
                         temporal=temporal, ib_x_edge=ib_x_edge,
                         pattern=pattern, device=device)

    paths = OutputPaths(output_root, cfg)
    paths.makedirs()
    interval = max(cfg.interval, 1)
    simlog = SimLog(paths.simlog_path, cfg)
    resolved = sim.resolved_config()
    extra = {"Backend": backend, "Forcing": forcing,
             "Dtype": resolved["dtype"]}
    if pattern != "no_mucus":
        extra["Pattern"] = pattern
    extra["Device"] = (f"{device} ({torch.cuda.get_device_name(device)})"
                       if device.type == "cuda" else str(device))
    extra["Resolved backend"] = resolved["backend"] + (
        f" ({resolved['backend_reason']})"
        if resolved["backend_reason"] else "")
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
        if os.path.isdir(resume_from):
            raise _not_ported("orbax resume", "ROADMAP Queue 1 item 12")
        state, _ = ckpt.load(resume_from, cfg, device=device)
        if state.force.shape[1] == cfg.ydim:
            # jnp-mesh checkpoints keep the force full-size; this layout
            # is band-only (zero above the band by construction)
            state = state._replace(
                force=state.force[:, :cfg.force_band].contiguous())
        it0 = state.it
        keep = _resume_flux_rows(paths.flux_path, cfg, it0, interval)
        flux = FluxWriter(paths.flux_path, cfg, keep_rows=keep)
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
                                             "Temporal"))})
        if not quiet:
            print(f"Resumed from {resume_from} at it={it0}")
    else:
        state = sim.init_state()
        flux = FluxWriter(paths.flux_path, cfg)
        simlog.write_header(extra=extra)
    meter = ThroughputMeter(cells=cfg.size)
    start_epoch = time.time()
    t_start = seconds()
    if not quiet:
        print("Running Simulation...")

    it_start = state.it
    snap = _SnapshotPipeline(paths, cfg, fmt=snapshot_format,
                             overlap=overlap)
    try:
        state = _loop(cfg, sim, snap, flux, meter, simlog, interval, quiet,
                      checkpoint_every, paths, start_epoch, t_start, state)
    finally:
        snap.close()
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
          checkpoint_every, paths, start_epoch, t_start, state):
    """The interval loop (JAX runner.py:569-630); returns the final state."""
    it = state.it
    first_interval_logged = it > 0
    last_ckpt = it
    while it < cfg.iterations:
        # output at the start of each interval boundary (main.cu:938)
        boundary = it % interval == 0
        if boundary:
            if cfg.bigdata:
                # fields of the pre-chunk state; their host copies are
                # enqueued before the chunk
                staged = snap.stage(*sim.fields(state),
                                    *sim.boundary_fields(state))
                if not snap.overlap:
                    snap.write_sync(it, staged)
            flux.append(it, float(state.q))

        n = min(interval - it % interval, cfg.iterations - it)
        meter.start()
        state = sim.run_chunk(state, n)
        if boundary and cfg.bigdata and snap.overlap:
            snap.submit(it, staged)
        _sync(sim.device)
        meter.stop(n)
        it = state.it

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
            ckpt.save(os.path.join(paths.raw_dir, "checkpoint.npz"),
                      state, cfg)
            last_ckpt = it
    return state
