// B4 and B7: K force-free steps of a block of rows behind one call.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_temporal_kernel (:790) as
// built by make_temporal_bulk_substep (:966, call :1045), B4, and
// _ghost_temporal_kernel (:1855) as built by make_ghost_temporal_substep
// (:2079, call :2189), B7.  The IB force is zero above the force band, so
// the rows there evolve K steps with no input but the band's seam rows.
//
// The block is [bottom ghost, pad rows; the yl rows of f_loc; top ghost,
// pad rows] of width W.  B4 is the block with pad = 0: the whole bulk
// [band, Y) at the domain's width.  B7 is one shard's rows with pad = 16
// ghost rows a side from its y-neighbours (and, on x-sharded meshes, 128
// ghost columns a side from its x-neighbours).  Each sub-step s collides
// every row force-free (collide_cell of collide.cuh) and pull-streams, x
// periodic within the block.  Garbage enters at the block's edges (the
// rows beyond them pull zeros, the x-roll wraps the block) and moves at
// most one row or column per sub-step, so with K <= pad it stays in the
// ghost rows and columns.  The five flags of :1874-1893 are plain
// arguments here:
//   inject      the band/bulk seam lies in this block: the up-going pulls
//               of block row seam_row come from bhalos[s] (the f1 of
//               global row band-1 at sub-step s, which the band leg
//               exposes), sealing the rows above from those below (B7:
//               garbage; the caller puts the band leg's rows there);
//   is_top      the top wall lies at block row pad + yl - 1 (on a B7
//               shard an interior row of the block): its fix-up applies;
//   seam_row    pad + clip(band - y0, 0, yl): the seam (a row, not the
//               TPU's tile) and the first row the flux counts;
//   flux_lane   the flux column's lane in the block;
//   flux_owned  1 where this block holds the flux column.
// B4's flags are (1, 1, 0, flux_x, 1).  flux[s] sums mom_x / rho at
// flux_lane over block rows [seam_row, pad + yl) after sub-step s (no
// force correction: the force is zero here); zeros where flux_owned is 0.
// The JAX B7 kernel adds its per-tile partials in float32 even in f64 runs
// (:2029); this one sums in the state's type.
//
// Design, a first version: K launches of the row kernel of step.cuh (one
// per sub-step, ping-ponging two scratch blocks).  The first reads the
// ghost rows and f_loc's rows in place from their three buffers, the last
// writes f_out; f_loc and f_out may be row ranges of larger states.  The
// seam and the wall are rows of the step kernel (inject_row, top_row).
// Each launch writes the flux column of its rows, and one launch of
// column_sum_kernel reduces the K columns in a fixed order (no atomics).
// The JAX package keeps B7 a mirrored copy of B4 to protect its TPU code
// generation (:1907-1921); here both are this one driver.  The TPU kernels
// are row wavefronts holding 3K full-width ring rows in VMEM; 3K rows of
// 2048 columns do not fit 227 KB of shared memory, and the x-strip or 2-D
// trapezoid forms that would fit are later work.
//
// What bounds it on an H100: the function reads the block once and writes
// it once (2 x 9 x rows x W values: 284 MB for B4 at 2048^2 in f32, 0.085
// ms at 3.35 TB/s) and does 101 operations per cell and sub-step in the
// force-free collide (6.4 GFLOP at K = 16, 0.095 ms at 67 TFLOP/s):
// arithmetic bounds it, barely, at K = 16.  This version instead moves the
// block through device memory once per sub-step, so it runs near K times
// the byte bound of one pass: 1.78 ms for B4 at 2048^2, K = 16, f32
// (chip_smoke.py; NVIDIA H100 80GB HBM3 at 700 W).  A single launch over
// x-strips with K ghost columns and a ring of rows per sub-step in shared
// memory is the design that would approach the bound.

#include "step.cuh"

namespace {

template <typename T>
int ghost_temporal(const void* bot, long long bot_plane, const void* f_loc,
                   long long loc_plane, const void* top, long long top_plane,
                   void* f_out, long long out_plane, void* tmp0, void* tmp1,
                   const void* bhalos, void* colbuf, void* flux, int yl,
                   int pad, int xdim, int K, int inject, int is_top,
                   int seam_row, int flux_lane, int flux_owned, double tau,
                   double tau2, int forcing_trt, int deviatoric,
                   int top_noslip, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = yl + 2 * pad;
  StepArgs<T> a{};
  a.rows = rows;
  a.out_rows = rows;
  a.xdim = xdim;
  a.is_bottom = 0;
  a.top_row = is_top ? pad + yl - 1 : -1;
  a.top_noslip = top_noslip;
  a.expose_row = -1;
  a.inject_row = inject ? seam_row : -1;
  a.flux_x = flux_lane;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);
  T* tmp[2] = {(T*)tmp0, (T*)tmp1};
  const long long plane = (long long)rows * xdim;
  for (int s = 0; s < K; ++s) {
    if (s == 0) {
      a.f_lo = (const T*)bot;
      a.lo_plane = bot_plane;
      a.lo_rows = pad;
      a.f_in = (const T*)f_loc;
      a.in_plane = loc_plane;
      a.f_hi = (const T*)top;
      a.hi_plane = top_plane;
      a.hi_start = pad + yl;
    } else {
      a.lo_rows = 0;
      a.hi_start = 1 << 30;
      a.f_in = tmp[(s - 1) % 2];
      a.in_plane = plane;
    }
    a.f_out = s == K - 1 ? (T*)f_out : tmp[s % 2];
    a.out_plane = s == K - 1 ? out_plane : plane;
    a.inject = (const T*)bhalos + (long long)s * 9 * xdim;
    a.fluxcol = flux_owned ? (T*)colbuf + (long long)s * 2 * rows : nullptr;
    const int err = launch_step<T>(a, false, st);
    if (err) return err;
  }
  if (!flux_owned) return 0;
  column_sum_kernel<T, true><<<K, SUM_THREADS, 0, st>>>(
      (const T*)colbuf + seam_row, pad + yl - seam_row, rows, 2LL * rows,
      (T*)flux);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's.  bot [9, pad, W], f_loc
// [9, yl, W], top [9, pad, W] and f_out [9, yl + 2 pad, W] have plane
// strides bot_plane, loc_plane, top_plane and out_plane (elements; rows
// contiguous); f_out overlaps none of the inputs; bot and top are unused
// (may be NULL) when pad is 0; tmp0 and tmp1 are contiguous scratch of
// f_out's shape (tmp1 unused for K <= 2, both for K = 1); bhalos
// [K, 9, W]; colbuf [K, 2, yl + 2 pad] scratch and flux [K] (both unused,
// may be NULL, when flux_owned is 0).
#define IBLB_GHOST(NAME, T)                                                  \
  extern "C" int NAME(const void* bot, long long bot_plane,                  \
                      const void* f_loc, long long loc_plane,                \
                      const void* top, long long top_plane, void* f_out,     \
                      long long out_plane, void* tmp0, void* tmp1,           \
                      const void* bhalos, void* colbuf, void* flux, int yl,  \
                      int pad, int xdim, int K, int inject, int is_top,      \
                      int seam_row, int flux_lane, int flux_owned,           \
                      double tau, double tau2, int forcing_trt,              \
                      int deviatoric, int top_noslip, void* stream) {        \
    return ghost_temporal<T>(bot, bot_plane, f_loc, loc_plane, top,          \
                             top_plane, f_out, out_plane, tmp0, tmp1,        \
                             bhalos, colbuf, flux, yl, pad, xdim, K, inject, \
                             is_top, seam_row, flux_lane, flux_owned, tau,   \
                             tau2, forcing_trt, deviatoric, top_noslip,      \
                             stream);                                        \
  }
IBLB_GHOST(iblb_ghost_temporal_f32, float)
IBLB_GHOST(iblb_ghost_temporal_f64, double)
