"""ctypes bindings for the native C++ snapshot writers (native/iblb_io.cpp).

The port's own copy of the JAX package's io/native.py.  It builds the
shared library with g++ at first use, from the C++ source in the
repository's native/ directory, into build/native/ at the repository root
(listed in .gitignore), keyed by a hash of the source.  It never runs
native/Makefile and writes nothing outside build/.  Callers fall back to
the pure-Python writers (io/writers.py, the format oracle) when the
toolchain is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "iblb_io.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_lib = None
_tried = False


def library_path() -> str | None:
    """Where the library for the current source lives; None without one."""
    if not os.path.exists(_SOURCE):
        return None
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(_SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"_libiblb_io_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SOURCE],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return True


def load():
    """Return the loaded library or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if path is None or (not os.path.exists(path) and not _build(path)):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.iblb_monotonic_seconds.restype = ctypes.c_double
    lib.iblb_write_fluid_snapshot.restype = ctypes.c_int
    lib.iblb_write_fluid_snapshot.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.iblb_write_cilia_snapshot.restype = ctypes.c_int
    lib.iblb_write_cilia_snapshot.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_fluid_snapshot(path: str, cfg, rho, u) -> None:
    lib = load()
    if lib is None:
        raise RuntimeError("native io library unavailable")
    rho = np.ascontiguousarray(np.asarray(rho, np.float64))
    u = np.asarray(u, np.float64)
    ux = np.ascontiguousarray(u[0])
    uy = np.ascontiguousarray(u[1])
    ydim, xdim = rho.shape
    rc = lib.iblb_write_fluid_snapshot(
        path.encode(), xdim, ydim, cfg.x_scale, cfg.s_scale,
        _dptr(rho), _dptr(ux), _dptr(uy))
    if rc:
        raise OSError(f"native fluid snapshot write failed (code {rc})")


def write_cilia_snapshot(path: str, cfg, s, u_s, eps) -> None:
    lib = load()
    if lib is None:
        raise RuntimeError("native io library unavailable")
    s = np.ascontiguousarray(np.asarray(s, np.float64))
    u_s = np.ascontiguousarray(np.asarray(u_s, np.float64))
    eps = np.ascontiguousarray(np.asarray(eps, np.int32))
    rc = lib.iblb_write_cilia_snapshot(
        path.encode(), s.shape[0], cfg.length, cfg.xdim,
        cfg.x_scale, cfg.s_scale,
        _dptr(s), _dptr(u_s), eps.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)))
    if rc:
        raise OSError(f"native cilia snapshot write failed (code {rc})")


def monotonic_seconds() -> float:
    lib = load()
    if lib is None:
        import time

        return time.perf_counter()
    return float(lib.iblb_monotonic_seconds())
