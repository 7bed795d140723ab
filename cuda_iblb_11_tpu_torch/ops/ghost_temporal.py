"""B7: K force-free steps of one shard's rows with ghost rows — the port of
make_ghost_temporal_substep (cuda_iblb_11_tpu/ops/pallas_step.py:2079,
kernel _ghost_temporal_kernel :1855).

    ghost_temporal(flags, f_loc, bot, top, bhalos, cfg, ...)
        -> (f_block [9, yl + 2 pad, W], flux [K])

f_loc [9, yl, W] is the shard's rows (and, on x-sharded meshes, 128 ghost
columns a side from its x-neighbours); bot and top [9, pad, W] the ghost
rows below and above it (pad = 16, ops/temporal.GHOST_PAD, sent by the
y-neighbours once per K steps); bhalos [K, 9, W] the f1 of global row
band-1 at each sub-step (the band leg's seam output).  flags = (inject,
is_top, seam_row, flux_lane, flux_owned), as csrc/ghost_temporal.cu says:
the seam row pad + clip(band - y0, 0, yl) pulls its up-going populations
from bhalos where the seam lies in the shard; the top wall applies at
block row pad + yl - 1 on the top shard; flux[s] sums mom_x / rho at
flux_lane over block rows [seam_row, pad + yl) after sub-step s, where the
shard owns the flux column (zeros elsewhere; the caller divides by 192).
The caller keeps rows [pad, pad + yl) (and the shard's own columns): the
edge rows and columns of the block carry garbage that moves one cell per
sub-step, and the rows below the seam are the band leg's.

``ghost_temporal`` launches csrc/ghost_temporal.cu for CUDA tensors (or
raises) and calls ``ghost_temporal_reference`` for CPU tensors.  B4
(ops/temporal_bulk.py) launches the same driver through
``launch_k_steps``, with no ghost rows.  ``kstep_geometry`` cuts a call
into the kernel's passes, strips and segments; the wrapper and the tests
call it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cuda_iblb_11_tpu_torch.core.lattice import CX
from cuda_iblb_11_tpu_torch.core.state import aux_dtype
from cuda_iblb_11_tpu_torch.ops import _kernels
from cuda_iblb_11_tpu_torch.ops import reference as ref
from cuda_iblb_11_tpu_torch.ops.fused_step import (
    TOP_PAIRS, _emit, _into, stream_block,
)
from cuda_iblb_11_tpu_torch.ops.temporal import check_ghost

SEAM_DIRS = (2, 5, 6)   # the up-going populations the seam row pulls

# The K-step kernel's limits (csrc/ghost_temporal.cu): levels per pass
# (every type), threads per CUDA block (its __launch_bounds__, by the
# compute type: bf16 storage computes in float32), rows per
# level's ring, level 0's input rows in flight; an H100's shared memory per
# CUDA block and per SM, threads per SM.
KB = 8
MAX_THREADS = {torch.float32: 1024, torch.float64: 768}
RING = 4
STAGES = 4
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
THREADS_SM = 2048
H100_SMS = 132


@dataclass(frozen=True)
class KStepPass:
    """One launch: kp levels over x-strips of wc loaded columns (wt = wc -
    2 kp kept) and y-segments of ly rows, one CUDA block each."""

    kp: int
    wc: int
    ly: int
    threads: int
    smem_bytes: int
    n_strips: int
    n_seg: int

    @property
    def wt(self) -> int:
        return self.wc - 2 * self.kp

    @property
    def collides_per_row(self) -> int:
        """Cells a CUDA block collides per row iteration: level 0's wc and
        wc - 2s for each level s in 1..kp-1."""
        return self.kp * self.wc - self.kp * (self.kp - 1)

    def strips(self, width: int) -> list[tuple[int, int]]:
        """The output columns [x0, x1) of each strip, as the kernel cuts
        them."""
        return [(i * self.wt, min((i + 1) * self.wt, width))
                for i in range(self.n_strips)]

    def segments(self, rows: int) -> list[tuple[int, int]]:
        """The output rows [y0, y1) of each segment."""
        return [(i * self.ly, min((i + 1) * self.ly, rows))
                for i in range(self.n_seg)]


@dataclass(frozen=True)
class KStepGeometry:
    """A K-step call on a block of rows x width: its passes, each one trip
    of the block through device memory, and the redundancy (the cells the
    CUDA blocks collide, ghost columns and wavefront fill included, over
    the K x rows x width the function needs)."""

    rows: int
    width: int
    K: int
    passes: tuple[KStepPass, ...]
    redundancy: float

    @property
    def hbm_passes(self) -> int:
        return len(self.passes)

    def geo_array(self):
        """The passes as the C entry takes them: (kp, Wc, Ly, threads)."""
        flat = [v for p in self.passes
                for v in (p.kp, p.wc, p.ly, p.threads)]
        return (ctypes.c_int * len(flat))(*flat)


def _warps32(n):
    return -(-n // 32) * 32


def _threads(kp, wc):
    """The kernel's threads, each group from a warp boundary: levels
    1..kp-1 (wc - 2s columns each), level 0's wc loaders, the last
    level's wc - 2 kp output columns."""
    return (_warps32((kp - 1) * wc - kp * (kp - 1)) + _warps32(wc)
            + _warps32(wc - 2 * kp))


def bar_bytes(kp):
    """The shared memory of a pass's mbarriers: RING for each of its kp + 1
    levels (the stores the last), 8 bytes each, rounded up to 16."""
    return -(-(kp + 1) * RING * 8 // 16) * 16


def _pass_geometry(rows, width, kp, dtype, n_sm):
    """One pass of depth kp; dtype is the compute type."""
    es = torch.empty((), dtype=dtype).element_size()
    wc = min((SMEM_BLOCK - bar_bytes(kp)) // ((RING * kp + STAGES) * 9 * es),
             width + 2 * kp)
    while wc > 2 * kp and _threads(kp, wc) > MAX_THREADS[dtype]:
        wc -= 1
    if wc <= 2 * kp:
        raise ValueError(f"K-step pass of depth {kp} does not fit a CUDA "
                         f"block in {dtype}")
    threads = _threads(kp, wc)
    smem = bar_bytes(kp) + (RING * kp + STAGES) * 9 * wc * es
    n_strips = -(-width // (wc - 2 * kp))
    per_sm = max(1, min(THREADS_SM // threads, SMEM_SM // (smem + 1024)))
    best = None
    for n in range(1, rows + 1):   # the fewest row iterations per SM
        ly = -(-rows // n)
        if n > 1 and ly == -(-rows // (n - 1)):
            continue
        n_seg = -(-rows // ly)
        waves = -(-(n_strips * n_seg) // (n_sm * per_sm))
        cost = waves * _row_iterations(ly, kp)
        if best is None or cost < best[0]:
            best = (cost, ly, n_seg)
    _, ly, n_seg = best
    return KStepPass(kp, wc, ly, threads, smem, n_strips, n_seg)


def _row_iterations(ly, kp):
    """The row iterations of a segment of ly output rows at depth kp: the
    wavefront's ly + 3 kp, rounded up to the ring's period (the kernel's
    loop is unrolled by it)."""
    return -(-(ly + 3 * kp) // RING) * RING


@functools.lru_cache(maxsize=None)
def _geometry(yl, pad, width, K, dtype, n_sm):
    rows = yl + 2 * pad
    n_pass = -(-K // KB)
    depths = [K // n_pass + (i < K % n_pass) for i in range(n_pass)]
    passes = tuple(_pass_geometry(rows, width, kp, dtype, n_sm)
                   for kp in depths)
    run = 0
    for p in passes:
        for y0, y1 in p.segments(rows):
            run += p.n_strips * _row_iterations(y1 - y0, p.kp) \
                * p.collides_per_row
    return KStepGeometry(rows, width, K, passes, run / (K * rows * width))


def kstep_geometry(yl, pad, width, K, dtype, n_sm=H100_SMS):
    """The passes of a K-step call on a block of yl rows with pad ghost
    rows a side (B4: pad = 0; B7 refuses K > pad and yl < pad) and width
    columns, with f stored in float32, float64 or bfloat16, on a card of
    n_sm SMs: ceil(K / KB) passes of near-equal depth, each as wide as the
    kernel's threads and shared memory allow, its rows cut into segments
    that fill the SMs in the fewest row iterations.  Threads and shared
    memory are sized by the compute type (the rings, the stage ring and the
    scratch between passes hold it), so a bf16 call has the float32
    geometry."""
    if pad:
        check_ghost(K, yl, pad)
    if K < 1 or yl < 1 or width < 1:
        raise ValueError(f"K-step block needs K, yl, width >= 1, got {K}, "
                         f"{yl}, {width}")
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise NotImplementedError(f"K-step kernel takes float32/float64/"
                                  f"bfloat16 f, got {dtype}")
    return _geometry(yl, pad, width, K, aux_dtype(dtype), n_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ghost_temporal_reference(flags, f_loc, bot, top, bhalos, cfg,
                             walls=ref.REFERENCE_WALLS, forcing="trt_split",
                             storage="raw", out=None):
    """Plain torch version, in >= f32 between sub-steps: K force-free
    collides (ops/reference.collide_rows) and pull-streams of the whole
    block, the rows beyond its edges read as zeros, the x-roll within the
    block; then the seam row's injected pulls, the top wall and the flux of
    the owned rows.  The block goes into ``out`` when given."""
    inject, is_top, seam_row, lane, owned = (int(v) for v in flags)
    pad, yl, width = bot.shape[1], f_loc.shape[1], f_loc.shape[2]
    cdt = torch.promote_types(f_loc.dtype, torch.float32)
    f = torch.cat([bot, f_loc, top], dim=1).to(cdt)
    force = f.new_zeros((2,) + tuple(f.shape[1:]))
    zero = f.new_zeros((9, width))
    wall = pad + yl - 1
    flux = []
    for s in range(bhalos.shape[0]):
        f1 = ref.collide_rows(f, force, cfg.tau, cfg.tau2, forcing, storage)
        f = stream_block(f1, zero, zero)
        if inject:
            h = bhalos[s].to(cdt)
            for d in SEAM_DIRS:
                f[d, seam_row] = torch.roll(h[d], int(CX[d]))
        if is_top:
            for dst, src in TOP_PAIRS[walls.top]:
                f[dst, wall] = f1[src, wall]
        if owned:
            _, fluxcol = _emit(f, 0, lane, storage)
            fluxcol = fluxcol[:, seam_row:pad + yl]
            flux.append((fluxcol[1] / fluxcol[0]).sum())
        else:
            flux.append(f.new_zeros(()))
    return _into(out, f.to(f_loc.dtype)), torch.stack(flux)


def launch_k_steps(flags, f_loc, bot, top, bhalos, cfg, walls, forcing,
                   storage, out, what):
    """Check the inputs and launch csrc/ghost_temporal.cu once on CUDA
    tensors: B7's block, or B4's with bot and top None (no ghost rows).
    f_loc, bot, top and ``out`` may be row ranges of larger tensors
    (contiguous rows); ``out`` overlaps none of the inputs.  Returns
    (out [9, yl + 2 pad, W], flux [K]).  Under bf16 storage f_loc, bot,
    top and ``out`` are bf16 and bhalos, the scratch and the flux
    float32."""
    dt, dev = f_loc.dtype, f_loc.device
    _kernels.check_scheme(dt, walls, forcing, storage, what)
    cdt = aux_dtype(dt)
    inject, is_top, seam_row, lane, owned = (int(v) for v in flags)
    _, yl, width = f_loc.shape
    pad = 0 if bot is None else bot.shape[1]
    if bhalos.dim() != 3 or bhalos.shape[0] < 1:
        raise ValueError(f"bhalos must be [K, 9, W], got "
                         f"{tuple(bhalos.shape)}")
    K = bhalos.shape[0]
    rows = yl + 2 * pad
    if not pad <= seam_row <= pad + yl:
        raise ValueError(f"seam_row {seam_row} outside [{pad}, {pad + yl}]")
    if owned and not 0 <= lane < width:
        raise ValueError(f"flux_lane {lane} outside [0, {width})")
    _kernels.check_planes("f_loc", f_loc, (9, yl, width), dt, dev)
    ghosts = (("bot", bot), ("top", top)) if pad else ()
    for name, t in ghosts:
        _kernels.check_planes(name, t, (9, pad, width), dt, dev)
    _kernels.check_tensor("bhalos", bhalos, (K, 9, width), cdt, dev)
    geo = kstep_geometry(yl, pad, width, K, dt, _sm_count(dev))
    if out is None:
        out = torch.empty((9, rows, width), dtype=dt, device=dev)
    _kernels.check_planes("out", out, (9, rows, width), dt, dev)
    for name, t in (("f_loc", f_loc),) + ghosts:
        _kernels.check_disjoint("out", out, name, t)
    tmp = [torch.empty((9, rows, width), dtype=cdt, device=dev)
           if geo.hbm_passes > 1 + i else None for i in range(2)]
    colbuf = (torch.empty((K, 2, rows), dtype=cdt, device=dev) if owned
              else None)
    flux = (torch.empty if owned else torch.zeros)((K,), dtype=cdt,
                                                   device=dev)
    geo_arr = geo.geo_array()
    _kernels.launch(
        "iblb_ghost_temporal", dt, dev, _kernels.ptr(bot),
        bot.stride(0) if pad else 0, f_loc.data_ptr(), f_loc.stride(0),
        _kernels.ptr(top), top.stride(0) if pad else 0, out.data_ptr(),
        out.stride(0), _kernels.ptr(tmp[0]), _kernels.ptr(tmp[1]),
        bhalos.data_ptr(), _kernels.ptr(colbuf),
        flux.data_ptr() if owned else None, yl, pad, width, K, inject,
        is_top, seam_row, lane if owned else -1, owned, float(cfg.tau),
        float(cfg.tau2), int(forcing == "trt_split"),
        int(storage == "deviatoric"), int(walls.top == "noslip"),
        geo.hbm_passes, ctypes.addressof(geo_arr))
    return out, flux


def ghost_temporal(flags, f_loc, bot, top, bhalos, cfg,
                   walls=ref.REFERENCE_WALLS, forcing="trt_split",
                   storage="raw", out=None):
    """(f_block, flux [K]).  CUDA tensors launch the hand kernel
    (launch_k_steps); CPU tensors take the plain version."""
    if f_loc.device.type == "cpu":
        return ghost_temporal_reference(flags, f_loc, bot, top, bhalos, cfg,
                                        walls, forcing, storage, out)
    if f_loc.device.type != "cuda":
        raise ValueError(f"ghost_temporal: unsupported device "
                         f"{f_loc.device}")
    res = launch_k_steps(flags, f_loc, bot, top, bhalos, cfg, walls, forcing,
                         storage, out, "ghost_temporal")
    ghost_temporal.launches += 1
    return res


# Wrapper calls that launched the kernel since the last reset (the CPU
# path does not count).
ghost_temporal.launches = 0
