"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by nvcc for sm_90a into one shared
library with a plain C interface and loaded with ctypes.  The build runs at
first use, from the sources in the checkout, into ``build/kernels/`` at the
repository root (listed in .gitignore), keyed by a hash of the sources and
flags, so a fresh checkout builds itself and an unchanged one reuses its
library.  There is no fallback: without nvcc a CUDA tensor cannot be
stepped, and the loader raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
CUDA_ROOT = "/usr/local/cuda"   # the toolkit's usual place

# --fmad=true is nvcc's default, spelled out: multiply-adds contract (the
# source header of fused_step.cu says what that does to the tolerances).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=true", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC"]

_FUSED_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
               + [ctypes.c_double] * 2 + [ctypes.c_int] * 3
               + [ctypes.c_void_p])


class KernelLibrary:
    """The loaded library, with how it was built."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when reused from disk
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        for name in ("iblb_fused_step_f32", "iblb_fused_step_f64"):
            fn = getattr(self.lib, name)
            fn.argtypes = _FUSED_ARGS
            fn.restype = ctypes.c_int
        self.lib.iblb_error_string.argtypes = [ctypes.c_int]
        self.lib.iblb_error_string.restype = ctypes.c_char_p

    def check(self, err: int, what: str) -> None:
        if err:
            msg = self.lib.iblb_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_LIBRARY: KernelLibrary | None = None


def find_nvcc() -> str:
    """nvcc on PATH, under $CUDA_HOME or $CUDA_PATH, or under CUDA_ROOT;
    raises when there is none."""
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 CUDA_ROOT):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME, $CUDA_PATH, {CUDA_ROOT}): the "
        "CUDA kernels are built from csrc/ at first use and there is no "
        "fallback for CUDA tensors")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build(path: str) -> tuple[float, str]:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    units = [p for p in _sources() if p.endswith(".cu")]
    cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp] + units
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    with open(path + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return seconds, log


def load() -> KernelLibrary:
    """The kernel library, built from csrc/ on first use in this checkout."""
    global _LIBRARY
    if _LIBRARY is None:
        path = os.path.join(BUILD_DIR,
                            f"libiblb_kernels_{source_digest()}.so")
        if os.path.exists(path):   # built earlier in this checkout
            seconds = 0.0
            with open(path + ".log") as fh:
                log = fh.read()
        else:
            seconds, log = _build(path)
        _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY
