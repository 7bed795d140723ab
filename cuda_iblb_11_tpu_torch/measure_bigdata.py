"""End-to-end BigData throughput of the port, with and without the snapshot
overlap — the port of scripts/measure_bigdata.py.

    python -m cuda_iblb_11_tpu_torch.measure_bigdata [--steps-scale S]
        [--p-num N] [--device cuda|cpu] [--work DIR] [--json PATH]

runner.run at 2048^2 (16 cilia, f32, temporal "auto") with BigData = 1,
T = 1e5 steps x --steps-scale and --p-num snapshot pairs (one fluid and
one cilia file each interval), in the four configurations

    snapshot format {dat, npz} x overlap {on, off}

each REPEATS times, in turns (the order reversed on every other round,
so that a drift of the host's clock falls on every configuration alike).
Recorded per run: wall and runtime seconds, compute and end-to-end MLUPS
(end to end = cells x steps / the runtime, which includes the interval
output, as the reference's SimLog runtime does, main.cu:1007-1022), the
bytes written, a digest of the snapshot and flux files, the resolved
configuration, and where the time went: each snapshot write's wall and
CPU seconds on the thread that wrote it, and the process's CPU seconds.
Before the runs, one interval's snapshot is written WRITER_REPS times on
the main thread and as often on a worker thread, in turns, with no
simulation running (``writer_alone``): what the thread alone does to the
writer.  Whether the native text writers were built is recorded too.  Each
run's output is deleted once it is counted; the
overlapped and the serial run of a format must leave the same bytes.
The default run is the JAX script's full beat with 100 snapshot pairs;
--steps-scale and --p-num cut it (listed under ``reduced``), as the card's
record does (0.1 and 10: 10,000 steps at the beat's 1,000-step interval);
measure() takes any configuration (the CPU tests run 192^2 with 4 cilia).
The record goes to build/validation/bigdata_e2e.json by
default; the work directory defaults to build/validation/bigdata_work.
runner._resolve_overlap's choice for ``--overlap auto`` follows the card
host's record of this module (cuda_iblb_11_tpu_torch/records/).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import resource
import shutil
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from cuda_iblb_11_tpu_torch.core.config import SimConfig
from cuda_iblb_11_tpu_torch.io import native
from cuda_iblb_11_tpu_torch.io.writers import OutputPaths
from cuda_iblb_11_tpu_torch.models.mucociliary import resolve_device
from cuda_iblb_11_tpu_torch.ops.probes import (
    VALIDATION_DIR, run_header, write_record,
)
from cuda_iblb_11_tpu_torch.runner import _SnapshotPipeline, run

DEFAULT_JSON = os.path.join(VALIDATION_DIR, "bigdata_e2e.json")
DEFAULT_WORK = os.path.join(VALIDATION_DIR, "bigdata_work")
GRID = dict(c_num=16, c_space=128, ydim=2048)
CONFIGS = (("dat", True), ("dat", False), ("npz", True), ("npz", False))
REPEATS = 2
WARMUP_STEPS = 64
WRITER_REPS = 3


def tree_bytes(root) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(root) for n in names)


def tree_digest(root) -> str:
    """sha256 over the relative paths and bytes of the snapshot and flux
    files (SimLog, which records times and dates, left out)."""
    h = hashlib.sha256()
    for d, dirs, names in sorted(os.walk(root)):
        dirs.sort()
        for n in sorted(names):
            if n == "SimLog.txt":
                continue
            path = os.path.join(d, n)
            h.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    h.update(block)
    return h.hexdigest()


def _cpu_s() -> float:
    """The process's user and system CPU seconds so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


@contextlib.contextmanager
def timed_writes(rows):
    """While the block runs, each _SnapshotPipeline write appends its wall
    and thread CPU seconds, and whether it ran on the main thread, to
    ``rows``."""
    write = _SnapshotPipeline._write

    def timed(self, it, staged):
        t0, c0 = time.perf_counter(), time.thread_time()
        write(self, it, staged)
        rows.append({"it": it, "wall_s": time.perf_counter() - t0,
                     "cpu_s": time.thread_time() - c0,
                     "main_thread": threading.current_thread()
                     is threading.main_thread()})

    _SnapshotPipeline._write = timed
    try:
        yield rows
    finally:
        _SnapshotPipeline._write = write


def config(steps_scale=1.0, p_num=100) -> SimConfig:
    """The BigData run at GRID: T = 1e5 steps x steps_scale, p_num snapshot
    pairs, f32."""
    return SimConfig(t_num=1.0, t_pow=5, i_pow=steps_scale, p_num=p_num,
                     bigdata=True, dtype="float32", **GRID)


def run_one(cfg, fmt, overlap, root, device) -> dict:
    """One configuration's run, counted and deleted."""
    shutil.rmtree(root, ignore_errors=True)
    cpu0, t0 = _cpu_s(), time.perf_counter()
    with timed_writes([]) as writes:
        summary = run(cfg, output_root=root, backend="auto",
                      temporal="auto", quiet=True, snapshot_format=fmt,
                      overlap=overlap, device=device)
    wall, cpu = time.perf_counter() - t0, _cpu_s() - cpu0
    row = {"format": fmt, "overlap": overlap, "wall_s": wall,
           "runtime_s": summary["runtime_s"],
           "mlups_compute": summary["mlups"],
           "mlups_end_to_end": summary["mlups_end_to_end"],
           "process_cpu_s": cpu, "writes": writes,
           "write_wall_s": sum(w["wall_s"] for w in writes),
           "write_cpu_s": sum(w["cpu_s"] for w in writes),
           "bytes_written": tree_bytes(root), "digest": tree_digest(root),
           "resolved": summary["resolved"]}
    shutil.rmtree(root, ignore_errors=True)
    print(f"{fmt} overlap={'on' if overlap else 'off'}: wall {wall:.2f} s, "
          f"runtime {row['runtime_s']:.2f} s, {row['mlups_end_to_end']:.1f} "
          f"MLUPS end to end, {row['bytes_written']} bytes; writes "
          f"{row['write_wall_s']:.2f} s wall, {row['write_cpu_s']:.2f} s "
          f"CPU; process {cpu:.2f} s CPU", flush=True)
    return row


def writer_alone(cfg, fmt, root, reps=WRITER_REPS) -> dict:
    """One interval's snapshot of ``cfg``'s grid, with seeded fields,
    written ``reps`` times on the main thread and as often on a worker
    thread, in turns, with no simulation running: each write's wall and
    thread CPU seconds by thread."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    y, x, ns = cfg.ydim, cfg.xdim, cfg.c_num * cfg.length
    staged = (tuple(torch.from_numpy(a) for a in (
        (1 + 0.01 * rng.standard_normal((y, x))).astype(np.float32),
        (0.01 * rng.standard_normal((2, y, x))).astype(np.float32),
        rng.uniform(0, x, (ns, 2)), 0.01 * rng.standard_normal((ns, 2)),
        rng.integers(0, 2, ns).astype(np.int32))), None)
    shutil.rmtree(root, ignore_errors=True)
    paths = OutputPaths(root, cfg)
    paths.makedirs()
    pipe = _SnapshotPipeline(paths, cfg, fmt, overlap=False)
    out = {"main": [], "worker": []}
    try:
        with ThreadPoolExecutor(max_workers=1) as pool, \
                timed_writes([]) as rows:
            for rep in range(reps):
                pipe.write_sync(rep, staged)
                pool.submit(pipe.write_sync, reps + rep, staged).result()
        for r in rows:
            out["main" if r["main_thread"] else "worker"].append(
                {"wall_s": r["wall_s"], "cpu_s": r["cpu_s"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, rs in out.items():
        print(f"{fmt} writer alone on the {k} thread: wall "
              f"{[round(r['wall_s'], 3) for r in rs]} s, CPU "
              f"{[round(r['cpu_s'], 3) for r in rs]} s", flush=True)
    return out


def summarize(runs) -> dict:
    """Per configuration: the runtimes and end-to-end MLUPS (mean, min,
    max), and, where the runs timed their writes, the mean seconds of the
    snapshot writes (wall and CPU), of the process's CPU, and of the
    runtime beyond the writes (what the writes leave of the run: the
    compute the overlap did not hide).  Per format: which overlap ran
    faster by mean runtime, whether the ranges of the two overlap
    settings' runtimes are apart (the difference beyond the spread of the
    runs; None with fewer than two runs of each), whether both left the
    same bytes, and ``hidden_s``: the serial runs' mean runtime beyond the
    writes less the overlapped runs', the seconds the overlap hides, which
    the writer's own speed does not move."""
    per = {}
    for fmt, overlap in CONFIGS:
        rs = [r for r in runs if (r["format"], r["overlap"]) == (fmt, overlap)]
        if rs:
            t = [r["runtime_s"] for r in rs]
            row = per[f"{fmt}_{'on' if overlap else 'off'}"] = dict(
                runs=len(t), runtime_s_mean=statistics.mean(t),
                runtime_s_min=min(t),
                runtime_s_max=max(t),
                mlups_end_to_end_mean=statistics.mean(
                    r["mlups_end_to_end"] for r in rs),
                digests=sorted({r["digest"] for r in rs}),
                **{f"{k}_mean": statistics.mean(r[k] for r in rs)
                   for k in ("write_wall_s", "write_cpu_s", "process_cpu_s")
                   if all(k in r for r in rs)})
            if all("write_wall_s" in r for r in rs):
                row["runtime_beyond_writes_s_mean"] = statistics.mean(
                    r["runtime_s"] - r["write_wall_s"] for r in rs)
    faster = {}
    for fmt in ("dat", "npz"):
        on, off = per.get(f"{fmt}_on"), per.get(f"{fmt}_off")
        if on and off:
            faster[fmt] = dict(
                overlap=on["runtime_s_mean"] <= off["runtime_s_mean"],
                beyond_spread=None if min(on["runs"], off["runs"]) < 2 else (
                    on["runtime_s_max"] < off["runtime_s_min"]
                    or off["runtime_s_max"] < on["runtime_s_min"]),
                same_bytes=on["digests"] == off["digests"]
                and len(on["digests"]) == 1,
                hidden_s=(off["runtime_beyond_writes_s_mean"]
                          - on["runtime_beyond_writes_s_mean"]
                          if "runtime_beyond_writes_s_mean" in on
                          and "runtime_beyond_writes_s_mean" in off
                          else None))
    return {"configs": per, "faster": faster}


def measure(cfg, repeats=REPEATS, device="cuda", work=DEFAULT_WORK) -> dict:
    """The four configurations of ``cfg``'s run, ``repeats`` rounds."""
    device = resolve_device(device)
    print(f"grid {cfg.xdim}x{cfg.ydim}, {cfg.iterations} steps, interval "
          f"{cfg.interval} ({cfg.p_num} snapshots), {repeats} rounds",
          flush=True)
    # warm-up outside the measured runs: the kernel build, the native
    # writers' build, the first launches
    warm = cfg.replace(i_pow=cfg.i_pow * WARMUP_STEPS / cfg.iterations,
                       p_num=1)
    for fmt in ("dat", "npz"):
        run_one(warm, fmt, True, os.path.join(work, "warmup"), device)
    alone = {fmt: writer_alone(cfg, fmt, os.path.join(work, "writer"))
             for fmt in ("dat", "npz")}
    runs = []
    for rnd in range(repeats):
        order = CONFIGS if rnd % 2 == 0 else CONFIGS[::-1]
        for fmt, overlap in order:
            runs.append(dict(run_one(cfg, fmt, overlap, os.path.join(
                work, f"{fmt}_{overlap}"), device), round=rnd))
    shutil.rmtree(work, ignore_errors=True)
    full = config()
    reduced = []
    if cfg.iterations != full.iterations:
        reduced.append(f"steps {cfg.iterations} instead of "
                       f"{full.iterations} (i_pow {cfg.i_pow})")
    if cfg.p_num != full.p_num:
        reduced.append(f"{cfg.p_num} snapshot pairs instead of "
                       f"{full.p_num}; interval {cfg.interval} steps")
    if (cfg.xdim, cfg.ydim) != (full.xdim, full.ydim):
        reduced.append(f"grid {cfg.xdim}x{cfg.ydim} instead of "
                       f"{full.xdim}x{full.ydim}")
    return dict(run_header(device),
                config={"grid": f"{cfg.xdim}x{cfg.ydim}",
                        "c_num": cfg.c_num, "iterations": cfg.iterations,
                        "p_num": cfg.p_num, "interval": cfg.interval,
                        "dtype": cfg.dtype, "temporal": "auto"},
                host_cores=len(os.sched_getaffinity(0)),
                native_writers=native.available(), repeats=repeats,
                writer_alone=alone, runs=runs, summary=summarize(runs),
                reduced=reduced)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale i_pow (1.0 = the full 100,000-step beat)")
    ap.add_argument("--p-num", type=int, default=100,
                    help="snapshot count (the reference's P_num)")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--work", default=DEFAULT_WORK,
                    help="scratch output root (deleted after each run)")
    ap.add_argument("--json", default=DEFAULT_JSON, help="output record")
    args = ap.parse_args(argv)
    entry = measure(config(args.steps_scale, args.p_num),
                    device=args.device, work=args.work)
    write_record(args.json, "bigdata", entry)
    print(f"summary: {entry['summary']['faster']}")
    print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
