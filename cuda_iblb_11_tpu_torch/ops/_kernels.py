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

import contextlib
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
# Builds of the same sources with extra flags, each under its own key, for
# the probes' A/B runs only.  "identity_collide" turns collide_cell into a
# copy of its input (csrc/collide.cuh): probe_vpu.py's identity-collide
# A/B and probe_kstep.py's collide-free B4.  "one_block_per_sm" has each
# K-step block ask for 120 KiB of shared memory (csrc/ghost_temporal.cu),
# so that one block runs per SM: probe_kstep.py's residency A/B.
ONE_BLOCK_SMEM = 120 * 1024
VARIANTS = {"identity_collide": ["-DIBLB_IDENTITY_COLLIDE"],
            "one_block_per_sm": [f"-DIBLB_KSTEP_MIN_SMEM={ONE_BLOCK_SMEM}"]}

_P, _LL, _I, _D = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_double)
# argument types of each C entry point, by name (float32 and float64)
SIGNATURES = {
    "iblb_fused_step": [_P] * 5 + [_I] * 4 + [_D] * 2 + [_I] * 3 + [_P],
    "iblb_sharded_step": ([_P, _LL, _P, _LL] + [_P] * 6 + [_I] * 9
                          + [_D] * 2 + [_I] * 3 + [_P]),
    "iblb_band_super": ([_P, _LL, _P, _LL] + [_P] * 15 + [_I] * 9
                        + [_D] * 2 + [_I] * 2 + [_P]),
    "iblb_collide_slabs": [_P, _I, _P] + [_D] * 2 + [_I] * 2 + [_P],
    "iblb_ghost_temporal": ([_P, _LL] * 4 + [_P] * 5 + [_I] * 9 + [_D] * 2
                            + [_I] * 4 + [_P] * 2),
    "iblb_collide_stream": [_P] * 3 + [_I] * 3 + [_D] * 2 + [_I] * 3 + [_P],
}
# the probes (csrc/probes.cu) take float32 only
SIGNATURES_F32 = {
    "iblb_probe_copy": [_P, _P, _LL, _I, _I, _I, _P],
    "iblb_probe_ring_copy": [_P, _P, _LL, _I, _I, _I, _P],
    "iblb_probe_chain": [_P, _P, _LL, _I, _I, _P],
    "iblb_probe_empty": [_I, _P],
}
# the entry points with a bf16-storage build (f in bf16, all else float32):
# B2, B3, B2h, B4/B7 (one driver), B5/B6/B8 (one kernel) and B0
BF16_ENTRIES = ("iblb_fused_step", "iblb_sharded_step", "iblb_collide_stream",
                "iblb_ghost_temporal", "iblb_band_super",
                "iblb_collide_slabs")


def _suffixes():
    import torch

    return {torch.float32: "_f32", torch.float64: "_f64",
            torch.bfloat16: "_bf16"}


def entry_name(name: str, dtype) -> str:
    """The C symbol of entry point ``name`` for tensors of ``dtype`` (f's
    storage dtype); raises for a dtype the entry was not built for, so no
    dtype ever reaches another dtype's kernel."""
    sfx = _suffixes().get(dtype)
    built = (sfx == "_bf16" and name in BF16_ENTRIES
             or sfx in ("_f32", "_f64") and name in SIGNATURES
             or sfx == "_f32" and name in SIGNATURES_F32)
    if not built:
        raise NotImplementedError(
            f"{name} has no {dtype} kernel (built: float32, float64"
            + (", bfloat16" if name in BF16_ENTRIES else "") + ")")
    return name + sfx


class KernelLibrary:
    """The loaded library, with how it was built.  Every entry point is
    bound on load, so a stale or partial build raises here; bf16=False
    binds only the float32 and float64 entries (another checkout's build,
    held against this one for those: probe_band_super.other_library)."""

    def __init__(self, path: str, build_seconds: float, build_log: str,
                 bf16: bool = True):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when reused from disk
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        entries = [(n + sfx, a) for n, a in SIGNATURES.items()
                   for sfx in ("_f32", "_f64")]
        if bf16:
            entries += [(n + "_bf16", SIGNATURES[n]) for n in BF16_ENTRIES]
        entries += [(n + "_f32", a) for n, a in SIGNATURES_F32.items()]
        for name, argtypes in entries:
            try:
                fn = getattr(self.lib, name)
            except AttributeError as e:
                raise RuntimeError(
                    f"{path} has no entry point {name}: a stale or partial "
                    "build (delete it to rebuild from csrc/)") from e
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.iblb_error_string.argtypes = [ctypes.c_int]
        self.lib.iblb_error_string.restype = ctypes.c_char_p

    def check(self, err: int, what: str) -> None:
        if err:
            msg = self.lib.iblb_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_LIBRARY: KernelLibrary | None = None
_VARIANT_LIBRARIES: dict[str, KernelLibrary] = {}


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


def nvcc_flags(variant: str | None = None) -> list[str]:
    """The compile flags of the default build or of a VARIANTS entry."""
    if variant is None:
        return NVCC_FLAGS
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel build variant {variant!r} "
                         f"({', '.join(VARIANTS)})")
    return NVCC_FLAGS + VARIANTS[variant]


def source_digest(variant: str | None = None) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags(variant)).encode())
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


def _build(path: str, flags: list[str]) -> tuple[float, str]:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{path}.tmp{os.getpid()}"
    units = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(u)}.o" for u in units]
    t0 = time.perf_counter()
    log = _run([[nvcc] + flags + ["-c", u, "-o", o]
                for u, o in zip(units, objs)])
    log += "\n" + _run([[nvcc] + ARCH + ["-shared", "-o", tag] + objs])
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    with open(path + ".log", "w") as fh:
        fh.write(log)
    os.replace(tag, path)  # atomic: a concurrent loader sees all or nothing
    return seconds, log


def _load_built(variant: str | None) -> KernelLibrary:
    path = os.path.join(BUILD_DIR,
                        f"libiblb_kernels_{source_digest(variant)}.so")
    if os.path.exists(path):   # built earlier in this checkout
        seconds = 0.0
        with open(path + ".log") as fh:
            log = fh.read()
    else:
        seconds, log = _build(path, nvcc_flags(variant))
    return KernelLibrary(path, seconds, log)


def load(variant: str | None = None) -> KernelLibrary:
    """The kernel library, built from csrc/ on first use in this checkout;
    with ``variant``, the build of VARIANTS[variant] (the wrappers launch
    from it only inside ``using``)."""
    global _LIBRARY
    if variant is not None:
        if variant not in _VARIANT_LIBRARIES:
            _VARIANT_LIBRARIES[variant] = _load_built(variant)
        return _VARIANT_LIBRARIES[variant]
    if _LIBRARY is None:
        _LIBRARY = _load_built(None)
    return _LIBRARY


@contextlib.contextmanager
def using(lib: KernelLibrary):
    """Within the block every wrapper launches from ``lib`` (a variant
    build, or another checkout's library); the library it launched from
    before is restored on the way out."""
    global _LIBRARY
    saved = _LIBRARY
    _LIBRARY = lib
    try:
        yield lib
    finally:
        _LIBRARY = saved


# --- what every wrapper checks before a launch --------------------------

def check_scheme(dtype, walls, forcing, storage, what: str) -> None:
    """The dtypes, walls, forcings and storages the kernels take."""
    import torch

    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(
            f"{what} kernel takes float32/float64/bfloat16 f, got {dtype}")
    if dtype == torch.bfloat16 and storage != "deviatoric":
        # pallas_step.py:487-488, :2260-2262
        raise ValueError("bf16 storage requires deviatoric mode")
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

    symbol = entry_name(name, dtype)   # raises before a library loads
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib.lib, symbol)(*args, stream)
    lib.check(err, f"{name} launch")
