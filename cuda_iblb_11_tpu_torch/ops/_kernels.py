"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by nvcc for sm_90a into one shared
library with a plain C interface and loaded with ctypes.  The build runs at
first use, from the sources in the checkout, into ``build/kernels/`` at the
repository root (listed in .gitignore), keyed by a hash of the sources and
flags, so a fresh checkout builds itself and an unchanged one reuses its
library.  Each ``.cu`` compiles in its own nvcc process, all started
together, and one more links them.  There is no fallback: without nvcc a
CUDA tensor cannot be stepped, and the loader raises.
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
# source header of csrc/fused_step.cu says what that does to the
# tolerances).
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "--fmad=true", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC"]

_P, _LL, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_double)
# argument types of each C entry point, by name (both dtypes)
SIGNATURES = {
    "iblb_fused_step": [_P] * 5 + [_I] * 4 + [_D] * 2 + [_I] * 3 + [_P],
    "iblb_sharded_step": ([_P, _LL, _P, _LL] + [_P] * 6 + [_I] * 9
                          + [_D] * 2 + [_I] * 3 + [_P]),
    "iblb_temporal_bulk": ([_P, _LL, _P, _LL] + [_P] * 5 + [_I] * 4
                           + [_D] * 2 + [_I] * 3 + [_P]),
    "iblb_band_super": ([_P, _LL, _P, _LL] + [_P] * 15 + [_I] * 8
                        + [_D] * 2 + [_I] * 2 + [_P]),
}


class KernelLibrary:
    """The loaded library, with how it was built."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when reused from disk
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(self.lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        self.lib.iblb_error_string.argtypes = [ctypes.c_int]
        self.lib.iblb_error_string.restype = ctypes.c_char_p

    def entry(self, name: str, dtype):
        """The C entry point ``name`` for float32 or float64 tensors."""
        import torch

        return getattr(self.lib, name + ("_f32" if dtype == torch.float32
                                         else "_f64"))

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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their joined output, or raise."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    try:
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=900)
            logs.append(" ".join(cmd) + "\n" + out)
            if p.returncode:
                failed.append(f"nvcc failed ({p.returncode}):\n{logs[-1]}")
    finally:   # a timeout leaves no compiler running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "\n".join(logs)


def _build(path: str) -> tuple[float, str]:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{path}.tmp{os.getpid()}"
    units = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(u)}.o" for u in units]
    t0 = time.perf_counter()
    log = _run([[nvcc] + NVCC_FLAGS + ["-c", u, "-o", o]
                for u, o in zip(units, objs)])
    log += "\n" + _run([[nvcc] + ARCH + ["-shared", "-o", tag] + objs])
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    with open(path + ".log", "w") as fh:
        fh.write(log)
    os.replace(tag, path)  # atomic: a concurrent loader sees all or nothing
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


# --- what every wrapper checks before a launch --------------------------

def check_scheme(dtype, walls, forcing, storage, what: str) -> None:
    """The dtypes, walls, forcings and storages the kernels take."""
    import torch

    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"{what} kernel takes float32/float64, got {dtype} (bf16 "
            "storage: ROADMAP Queue 1 item 2)")
    if walls.left != "periodic" or walls.bottom != "noslip" \
            or walls.top not in ("slip", "noslip"):
        raise NotImplementedError(
            f"{what} kernel supports periodic x, bottom noslip, top "
            f"slip|noslip; got {walls}")
    if forcing not in ("trt_split", "reference"):
        raise ValueError(f"unknown forcing scheme {forcing!r}")
    if storage not in ("raw", "deviatoric"):
        raise ValueError(f"unknown storage {storage!r}")


def check_tensor(name: str, t, shape, dtype, device) -> None:
    """t has the shape, dtype and device, and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_planes(name: str, t, shape, dtype, device) -> None:
    """t is [P, R, X] with rows and columns contiguous (strides (s, X, 1)
    with s >= R*X): a whole tensor or a row range of a larger state."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    _, r, x = t.shape
    if t.stride(2) != 1 or t.stride(1) != x or t.stride(0) < r * x:
        raise ValueError(f"{name} must have contiguous rows (strides "
                         f"(>= {r * x}, {x}, 1), got {t.stride()})")


def _span(t) -> tuple[int, int]:
    n = sum((s - 1) * st for s, st in zip(t.shape, t.stride())) + 1
    return t.data_ptr(), t.data_ptr() + n * t.element_size()


def check_disjoint(name_a: str, a, name_b: str, b) -> None:
    """The memory a and b span does not overlap: the kernels read one
    while other blocks write the other."""
    lo_a, hi_a = _span(a)
    lo_b, hi_b = _span(b)
    if lo_a < hi_b and lo_b < hi_a:
        raise ValueError(f"{name_a} must not alias {name_b}: the kernel "
                         f"reads {name_b} while other blocks write "
                         f"{name_a}")


def ptr(t):
    """The device pointer of t, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def launch(name: str, dtype, device, *args) -> None:
    """Call the C entry point ``name`` on the device's current stream,
    with ``device`` current during the call (the caller's is restored),
    and raise on a launch error."""
    import torch

    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.entry(name, dtype)(*args, stream)
    lib.check(err, f"{name} launch")
