"""Output writers byte-compatible with the reference's artifacts (the
port's own copy of cuda_iblb_11_tpu/io/writers.py: both packages write
the same bytes for the same values).

Three artifact families (main.cu:591-614, 938-1005, 761-790):

  * flux time series  ``<it*t_scale>\\t<Q*x_scale>``        (main.cu:1002)
  * full-field snapshots ``<it>-fluid.dat``: 6 columns
    ``x*x_scale  y*x_scale  ux*s_scale  uy*s_scale  |u|*s_scale  rho``
    with a blank line after each grid row (main.cu:954-971) — the format of
    ``Data/Nominals/*-vector_nom.dat``
  * cilia snapshots ``<it>-cilia.dat``: ``x y us vs eps`` scaled, blank line
    per cilium or domain wrap (main.cu:984-994)
  * SimLog.txt run log (main.cu:761-790, 1007-1022, 1049-1057)

Numbers are formatted like C++ ``operator<<(double)`` (6 significant digits,
%g-style), matching the golden files.  The directory layout mirrors the
reference's ``<out>/Raw/<c_num>/<c_fraction>/`` and
``<out>/Cilia/<c_num>/<c_fraction>/`` tree with a configurable root instead
of the reference's hardcoded local/cluster paths (main.cu:591-594).

A faster C++ writer for the large field snapshots is used when the native
extension is available (io/native.py); these pure-Python writers are the
fallback and the format oracle.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from cuda_iblb_11_tpu_torch.core.config import L_0, T_0, SimConfig


def fmt(x: float) -> str:
    """C++ default-precision double formatting (6 significant digits)."""
    return f"{x:.6g}"


@dataclass
class OutputPaths:
    root: str
    cfg: SimConfig
    raw_dir: str = field(init=False)
    cilia_dir: str = field(init=False)
    flux_path: str = field(init=False)
    simlog_path: str = field(init=False)

    def __post_init__(self):
        c = self.cfg
        self.raw_dir = os.path.join(self.root, "Raw", str(c.c_num),
                                    str(c.c_fraction))
        self.cilia_dir = os.path.join(self.root, "Cilia", str(c.c_num),
                                      str(c.c_fraction))
        flux_name = (
            f"{c.c_fraction}_{c.c_num}_{c.c_space}_{fmt_3(c.re)}_"
            f"{fmt_3(c.t_num)}x{fmt_3(c.t_pow)}-flux.dat"
        )
        self.flux_path = os.path.join(self.root, "Flux", flux_name)
        self.simlog_path = os.path.join(self.raw_dir, "SimLog.txt")

    def makedirs(self):
        for d in (self.raw_dir, self.cilia_dir,
                  os.path.dirname(self.flux_path)):
            os.makedirs(d, exist_ok=True)


def fmt_3(v) -> str:
    """to_string_3: 3-significant-digit truncation used in the flux filename
    (main.cu:255-261)."""
    return f"{v:.3g}"


class FluxWriter:
    """Append-only flux series, one row per output interval (main.cu:998-1004)."""

    def __init__(self, path: str, cfg: SimConfig, keep_rows: int | None = None):
        """keep_rows=None truncates, like ofstream::trunc (main.cu:625).
        On checkpoint resume pass the number of already-valid leading rows:
        they are preserved and later rows (written past the checkpoint by the
        interrupted run) are dropped, so appends continue seamlessly."""
        self.path = path
        self.cfg = cfg
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if keep_rows is None:
            open(path, "w").close()
        else:
            try:
                with open(path) as fh:
                    rows = fh.readlines()[:keep_rows]
            except FileNotFoundError:
                rows = []
            with open(path, "w") as fh:
                fh.writelines(rows)

    def append(self, it: int, q: float):
        with open(self.path, "a") as fh:
            fh.write(
                f"{fmt(it * self.cfg.t_scale)}\t{fmt(q * self.cfg.x_scale)}\n"
            )


def write_fluid_snapshot(path: str, cfg: SimConfig, rho, u):
    """<it>-fluid.dat (main.cu:954-971).  rho [Y,X], u [2,Y,X].

    Inputs are upcast to f64 BEFORE scaling so f32 sim fields format to
    the same bytes as the native writer (iblb_io.cpp) and the reference's
    double ofstream — scaling/sqrt in f32 flips the 6th significant digit
    on ~4% of lines."""
    rho = np.asarray(rho, np.float64)
    u = np.asarray(u, np.float64)
    xs, ss = cfg.x_scale, cfg.s_scale
    ydim, xdim = rho.shape
    ab = np.sqrt(u[0] ** 2 + u[1] ** 2)
    with open(path, "w") as fh:
        for y in range(ydim):
            for x in range(xdim):
                fh.write(
                    f"{fmt(x * xs)}\t{fmt(y * xs)}\t{fmt(u[0, y, x] * ss)}\t"
                    f"{fmt(u[1, y, x] * ss)}\t{fmt(ab[y, x] * ss)}\t"
                    f"{fmt(rho[y, x])}\n"
                )
            fh.write("\n")  # blank line after each grid row (main.cu:968)


def write_fluid_snapshot_npz(path: str, cfg: SimConfig, rho, u):
    """Binary fluid snapshot for scale (an 8192^2 text snapshot is
    multi-GB; the npz is ~0.8 GB).  Stores the RAW lattice-unit fields
    plus the scale factors the text writer would have applied, so the
    text form is exactly recoverable:
    ``x*x_scale, y*x_scale, u*s_scale, |u|*s_scale, rho``
    (main.cu:954-971 column semantics).  Atomic (tmp+rename) like the
    npz checkpoints."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # file handle: numpy won't append .npz
        np.savez(fh, rho=np.asarray(rho), u=np.asarray(u),
                 x_scale=cfg.x_scale, s_scale=cfg.s_scale)
    os.replace(tmp, path)


def write_cilia_snapshot_npz(path: str, cfg: SimConfig, s, u_s, eps):
    """Binary cilia snapshot: raw s [Ns,2], u_s [Ns,2], eps [Ns] plus
    scales (text column semantics at main.cu:984-994)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, s=np.asarray(s), u_s=np.asarray(u_s),
                 eps=np.asarray(eps), x_scale=cfg.x_scale,
                 s_scale=cfg.s_scale, length=cfg.length)
    os.replace(tmp, path)


def write_cilia_snapshot(path: str, cfg: SimConfig, s, u_s, eps):
    """<it>-cilia.dat (main.cu:984-994).  s,u_s [Ns,2], eps [Ns]."""
    s = np.asarray(s, np.float64)    # f64 before scaling (see fluid writer)
    u_s = np.asarray(u_s, np.float64)
    eps = np.asarray(eps)
    xs, ss = cfg.x_scale, cfg.s_scale
    with open(path, "w") as fh:
        for k in range(s.shape[0]):
            fh.write(
                f"{fmt(s[k, 0] * xs)}\t{fmt(s[k, 1] * xs)}\t"
                f"{fmt(u_s[k, 0] * ss)}\t{fmt(u_s[k, 1] * ss)}\t"
                f"{int(eps[k])}\n"
            )
            # blank line per cilium or when the filament wraps (main.cu:991)
            if (k % cfg.length == cfg.length - 1
                    or s[k, 0] > cfg.xdim - 1 or s[k, 0] < 1):
                fh.write("\n")


class SimLog:
    """Run log (main.cu:761-790): parameters at start, predicted completion
    after the first interval, total runtime at the end."""

    def __init__(self, path: str, cfg: SimConfig):
        self.path = path
        self.cfg = cfg
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def write_header(self, extra: dict | None = None):
        c = self.cfg
        with open(self.path, "w") as fh:
            fh.write(time.asctime() + "\n\n")
            fh.write(f"Size: {c.xdim}x{c.ydim}\n")
            fh.write(f"Iterations: {c.iterations}\n")
            fh.write(f"Reynolds Number: {fmt(c.re)}\n")
            fh.write(f"Relaxation times: {fmt(c.tau)}, {fmt(c.tau2)}\n")
            fh.write(f"Spatial step: {fmt(c.dx * L_0)}m\n")
            fh.write(f"Time step: {fmt(c.dt * T_0)}s\n")
            fh.write(f"Mach number: {fmt(c.mach)}\n")
            fh.write(f"Phase Step: {c.c_fraction}/{c.c_num}\n")
            fh.write("\nBig Data is ON\n" if c.bigdata
                     else "\nBig Data is OFF\n")
            fh.write("Running on ShARC\n" if c.sharc
                     else "Running on local GPU\n")
            for k, v in (extra or {}).items():
                fh.write(f"{k}: {v}\n")

    def write_extra(self, extra: dict):
        """Append key/value lines (e.g. the resolved execution config of a
        resumed run, whose header was written by the original run)."""
        with open(self.path, "a") as fh:
            for k, v in extra.items():
                fh.write(f"{k}: {v}\n")

    def write_resume_note(self, it: int):
        """Appended (not truncating) when a run resumes from a checkpoint, so
        the original header and history survive."""
        with open(self.path, "a") as fh:
            fh.write(f"\nResumed from checkpoint at iteration {it}: "
                     + time.asctime() + "\n")

    def write_completion_estimate(self, predicted_end_epoch: float):
        with open(self.path, "a") as fh:
            fh.write("\nCompletion time: "
                     + time.asctime(time.localtime(predicted_end_epoch))
                     + "\n\n")

    def write_runtime(self, runtime_s: float):
        hours = int(runtime_s // 3600)
        mins = int((runtime_s - hours * 3600) // 60)
        secs = runtime_s - hours * 3600 - mins * 60
        with open(self.path, "a") as fh:
            fh.write(
                f"Total runtime: {hours:02d}:{mins:02d}:"
                f"{'0' if secs < 10 else ''}{secs:g}\n"
            )
