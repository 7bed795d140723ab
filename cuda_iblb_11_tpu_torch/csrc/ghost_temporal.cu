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
// Design: temporal blocking.  A call runs in P = ceil(K / 8) passes of
// near-equal depth kp <= 8, one kernel launch each, so the block crosses
// device memory P times: twice at K = 16 (f32 and f64), not K times.  A
// pass cuts the block into x-strips of Wt = Wc - 2 kp output columns, each
// loaded with kp ghost columns a side (Wc columns, wrapped modulo W as the
// x-roll wraps the block), and into y-segments of Ly output rows; one CUDA
// block per strip and segment.  The CUDA block sweeps its segment's rows
// upward as a wavefront, from kp rows below it to kp rows above it: in
// iteration i level 0 collides row i, and level s (1..kp) pulls row i - 2s
// from level s-1's ring and collides it into its own (the last level
// stores it instead).  Each level's ring holds four post-collision rows of
// Wc cells in dynamic shared memory, a cell's nine values in a row (stride
// 9, odd, so a warp's 32 columns hit 32 banks); the lag of two rows per
// level lets every level of an iteration run between the same two
// barriers, one __syncthreads per row.  Level 0 copies its input rows
// three rows ahead into a stage ring of four rows (cp.async, one commit
// group per row).  Level s is exact on columns [s, Wc - s) and on rows
// [segment - kp + s, segment end + kp - s), so the output strip and
// segment are exact, and every output cell is computed by the same
// operations on the same values as K launches of the row kernel of
// step.cuh would: bit for bit, ghost rows and garbage columns included.
// Rows outside the block are zeros at every level, as there.  The seam's
// injected pulls and the top wall are those of step.cuh, in its order.
// The threads are three groups, each from a warp boundary: Wc - 2s for
// each level s in 1..kp-1 (pull, collide), level 0's Wc loaders (copy,
// collide) and the last level's Wt (pull, store), so every thread but the
// last group's collides one cell per row.  The geometry is
// ops/ghost_temporal.py's kstep_geometry, which both the wrapper and the
// tests call: Wc as wide as the kernel's threads (1,024 in f32, 768 in
// f64, its __launch_bounds__) and 227 KB of shared memory allow, and Ly
// so that the strips times the segments fill the card's SMs in the fewest
// row iterations.  At K = 16 (two passes of 8):
//   f32: Wc = 117, Wt = 101, 1,024 threads, (8 x 4 + 4) x 9 x 117 x 4 B =
//        151,632 B of shared memory;
//   f64: Wc = 89, Wt = 73, 768 threads, (8 x 4 + 4) x 9 x 89 x 8 B =
//        230,688 B.
// Depth 8 is the choice for both types from probe_kstep.py's timings of
// depths 4, 8 and 16 (PERF.md): one pass of 16 is slower (Wc = 73 in f32,
// so more ghost columns per kept one), four of 4 about as fast as two of 8.
// Each level of the flux lane writes (rho, mom_x) of its owned rows into
// colbuf from the one CUDA block whose output strip and segment hold the
// cell, and one launch of column_sum_kernel reduces the K columns in a
// fixed order (no atomics).  The JAX package keeps B7 a mirrored copy of
// B4 to protect its TPU code generation (:1907-1921); here both are this
// one driver.
//
// What bounds it on an H100: the function reads the block once and writes
// it once (2 x 9 x rows x W values: 283 MB for B4 at 2048^2 in f32, 0.085
// ms at 3.35 TB/s) and does 101 operations per cell and sub-step in the
// force-free collide (6.4 GFLOP at K = 16, 0.095 ms at 67 TFLOP/s):
// arithmetic bounds it, barely, at K = 16.  The blocking trades passes
// for redundant collides (the trapezoid's ghost columns and the
// wavefront's 3 kp rows of fill per segment): kstep_geometry counts the
// factor, cells collided over cells kept, 1.213 for f32 at 2048^2, K = 16,
// so the arithmetic bound with the redundancy is 0.115 ms.  What holds it
// above that is instruction issue, not memory, occupancy or the barrier:
// each collided cell costs the collide's instructions (its divide
// included) and as many again of pulls, stores, indices and fix-ups.
// probe_kstep.py times a build with the collide replaced by a copy, which
// keeps most of the time, and a residency A/B: a CUDA block of 1,024
// threads fills an SM's registers (64 a thread), so 32 warps a SM; split
// into two 512-thread blocks (two barrier domains) the time per collided
// cell is the same, and one 512-thread block a SM (16 warps) is only
// 1.25x slower, not 2x (NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
// bf16 storage (the _bf16 entry, B4 on the JAX package's --dtype
// bfloat16; B7 shares it, but no mesh runs bf16 yet): the block is read
// and written as bf16 and computed in f32; the rings, the stage ring, the
// scratch between passes, the seam rows, colbuf and the flux are f32, so
// f rounds once per call, on the last pass's store, as the TPU kernel
// rounds once when its f32 rings go back to HBM.  The geometry is the f32
// one (kstep_geometry sizes threads and shared memory by the compute type).
// The call moves half the f32 bytes (142 MB at 2048^2, 0.042 ms), so the
// arithmetic bound, which bf16 does not change, bounds it more.
// The first version made K launches of the row kernel, K passes through
// device memory: 1.76-1.80 ms for B4 at 2048^2, K = 16, f32
// (chip_smoke.py; NVIDIA H100 80GB HBM3 at 700 W).

#include "step.cuh"

namespace {

// threads per CUDA block at most (registers: 64 a thread in f32, 85 in
// f64); ops/ghost_temporal.py's MAX_THREADS mirrors these
template <typename T>
struct KStepLimits;
template <>
struct KStepLimits<float> {
  static constexpr int kThreads = 1024;
};
template <>
struct KStepLimits<double> {
  static constexpr int kThreads = 768;
};
constexpr int RING = 4;     // rows per level's ring
constexpr int STAGES = 4;   // level 0's input rows in flight (a power of 2)

__device__ constexpr int warps32(int n) { return (n + 31) / 32 * 32; }

// The f arrays are untyped here: a pass reads them as Sin and writes them
// as Sout (kstep_kernel's template arguments), the storage type of f on
// the call's first read and last write and the compute type T between
// passes.
template <typename T>
struct KStepArgs {
  const void* f_lo;       // rows [0, lo_rows) (lo_rows = 0: none)
  long long lo_plane;
  int lo_rows;
  const void* f_in;       // rows [lo_rows, hi_start)
  long long in_plane;
  const void* f_hi;       // rows [hi_start, rows)
  long long hi_plane;
  int hi_start;
  void* f_out;
  long long out_plane;
  const T* bhalos;        // [kp, 9, W]: this pass's seam rows
  T* colbuf;              // [kp, 2, rows] or nullptr
  int rows;
  int xdim;
  int kp;                 // levels of this pass
  int wc;                 // columns a strip loads
  int ly;                 // output rows a segment holds
  int top_row;            // the top wall's row, or -1
  int top_noslip;
  int inject_row;         // the seam row, or -1
  int flux_x;             // the flux lane, or -1
  Coeffs<T> k;
};

template <typename Sin, typename T>
__device__ __forceinline__ const Sin* row_src(const KStepArgs<T>& a, int r,
                                              long long& plane) {
  if (r < a.lo_rows) {
    plane = a.lo_plane;
    return (const Sin*)a.f_lo + (long long)r * a.xdim;
  }
  if (r >= a.hi_start) {
    plane = a.hi_plane;
    return (const Sin*)a.f_hi + (long long)(r - a.hi_start) * a.xdim;
  }
  plane = a.in_plane;
  return (const Sin*)a.f_in + (long long)(r - a.lo_rows) * a.xdim;
}

// Asynchronous copies global -> shared (cp.async, sm_80+), one value each.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  }
}

// Level 0's input: start copying the nine values of block row r, column
// gx into the stage cell `dst` (nine values in a row) where the row lies
// in the block and below `end` (the rows the segment needs); one commit
// group either way, so the groups count rows.
template <typename T>
__device__ __forceinline__ void fetch_row(const KStepArgs<T>& a, int r,
                                          int end, int gx, T* dst) {
  if (r >= 0 && r < a.rows && r < end) {
    long long plane;
    const T* src = row_src<T>(a, r, plane) + gx;
#pragma unroll
    for (int d = 0; d < 9; ++d) copy_async(dst + d, src + d * plane);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The post-stream values p of level s at global row r and column gx,
// pulled from level s-1's ring: lo, mid and hi index the cells of this
// column in its rows r - 1, r and r + 1 (a cell's nine values lie in a
// row, its x-neighbours 9 values away); then the seam's and the top
// wall's fix-ups of step.cuh, and (rho, mom_x) into colbuf[s-1] where the
// cell is the flux lane's and `owner`.
template <typename T>
__device__ __forceinline__ void pull_level(const KStepArgs<T>& a,
                                           const T* ring, int lo, int mid,
                                           int hi, int s, int r, int gx,
                                           bool owner, T (&p)[9]) {
  // pull from (r - cy, x - cx)
  p[0] = ring[mid];
  p[1] = ring[mid - 9 + 1];
  p[2] = ring[lo + 2];
  p[3] = ring[mid + 9 + 3];
  p[4] = ring[hi + 4];
  p[5] = ring[lo - 9 + 5];
  p[6] = ring[lo + 9 + 6];
  p[7] = ring[hi + 9 + 7];
  p[8] = ring[hi - 9 + 8];
  const int xdim = a.xdim;
  if (r == a.inject_row) {  // the seam: pull (r - 1, x - cx) from bhalos
    const T* inj = a.bhalos + (long long)(s - 1) * 9 * xdim;
    const int xm = gx == 0 ? xdim - 1 : gx - 1;
    const int xp = gx == xdim - 1 ? 0 : gx + 1;
    p[2] = inj[2 * xdim + gx];
    p[5] = inj[5 * xdim + xm];
    p[6] = inj[6 * xdim + xp];
  }
  if (r == a.top_row) {
    p[4] = ring[mid + 2];
    if (a.top_noslip) {  // bounce-back
      p[7] = ring[mid + 5];
      p[8] = ring[mid + 6];
    } else {  // specular slip
      p[8] = ring[mid + 5];
      p[7] = ring[mid + 6];
    }
  }
  if (owner && gx == a.flux_x) {
    T rho, mom_x, mom_y;
    moments9(p, a.k.deviatoric, rho, mom_x, mom_y);
    T* col = a.colbuf + (long long)(s - 1) * 2 * a.rows;
    col[r] = rho;
    col[a.rows + r] = mom_x;
  }
}

// Sin and Sout: the types the pass reads and writes f as.  Level 0 stages
// its input rows with cp.async where Sin is T; a bf16 input (cp.async
// copies 4, 8 or 16 bytes, not 2) is loaded row by row and widened in
// registers, its latency hidden by the other levels' warps.
template <typename T, typename Sin, typename Sout>
__global__ void __launch_bounds__(KStepLimits<T>::kThreads)
    kstep_kernel(const KStepArgs<T> a) {
  constexpr bool kAsync = sizeof(Sin) == sizeof(T);
  // shared memory: a ring [RING][wc][9] for each level 0..kp-1, then
  // level 0's stage ring [STAGES][wc][9]; a cell's nine values in a row
  // (an odd stride: a warp's 32 columns hit 32 banks)
  extern __shared__ __align__(16) unsigned char kstep_smem[];
  T* const ring = reinterpret_cast<T*>(kstep_smem);
  const int wc = a.wc, kp = a.kp, xdim = a.xdim;
  const int wt = wc - 2 * kp;
  const int x0 = blockIdx.x * wt;           // the strip's first column
  const int y0 = blockIdx.y * a.ly;         // the segment's output rows
  const int y1 = min(y0 + a.ly, a.rows);
  const int ybase = y0 - kp;                // level 0's first row
  const int n_it = y1 - ybase + 2 * kp;
  const int row_cells = 9 * wc;
  const int level_cells = RING * row_cells;

  for (int e = threadIdx.x; e < kp * level_cells; e += blockDim.x) {
    ring[e] = T(0.0);
  }
  // this thread's role, each group starting at a warp: the columns [s, wc
  // - s) of levels s = 1..kp-1 (pull, collide), level 0's wc loaders
  // (copy, collide) and the last level's wt columns [kp, wc - kp) (pull,
  // store); kstep_geometry counts the same threads
  const int n_lev = warps32((kp - 1) * wc - kp * (kp - 1));
  const int n_load = warps32(wc);
  int lev, c = threadIdx.x;
  bool active;
  if (c < n_lev) {
    lev = 1;
    for (int width = wc - 2; c >= width && lev < kp;) {
      c -= width;
      ++lev;
      width = wc - 2 * lev;
    }
    active = lev < kp;
    c += lev;
  } else if (c < n_lev + n_load) {
    lev = 0;
    c -= n_lev;
    active = c < wc;
  } else {
    lev = kp;
    c += kp - n_lev - n_load;
    active = c < wc - kp && x0 + c - kp < xdim;
  }
  if (!active) c = kp;   // an idle thread: any column in range
  int gx = (x0 - kp + c) % xdim;
  if (gx < 0) gx += xdim;
  // whether this column is the strip's output (the flux lane's owner)
  const bool out_col = c >= kp && c < wc - kp && x0 + c - kp < xdim;
  // this thread's cell in its level's ring, and in the ring it reads
  const int own = lev * level_cells + 9 * c;
  const int src = (lev - 1) * level_cells + 9 * c;

  // level 0 copies its input rows STAGES - 1 rows ahead into its own cell
  // of the stage ring (no barrier: each loader reads only what it copied)
  T* const stage = ring + kp * level_cells + 9 * c;
  if constexpr (kAsync) {
    if (active && lev == 0) {
      for (int q = 0; q < STAGES - 1; ++q) {
        fetch_row(a, ybase + q, y1 + kp, gx, stage + q * row_cells);
      }
    }
  }
  __syncthreads();

  for (int i = 0; i < n_it; ++i) {
    if (active && lev == 0) {
      const int r = ybase + i;
      const bool in_block = r >= 0 && r < a.rows && r < y1 + kp;
      T f[9];
      if constexpr (kAsync) {
        fetch_row(a, r + STAGES - 1, y1 + kp, gx,
                  stage + ((i + STAGES - 1) & (STAGES - 1)) * row_cells);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
        const T* in = stage + (i & (STAGES - 1)) * row_cells;
#pragma unroll
        for (int d = 0; d < 9; ++d) f[d] = in[d];
      } else if (in_block) {
        long long plane;
        const Sin* row = row_src<Sin>(a, r, plane) + gx;
#pragma unroll
        for (int d = 0; d < 9; ++d) f[d] = load_f(row + d * plane);
      }
      T f1[9];
      if (in_block) {
        collide_cell<T, false>(f, T(0.0), T(0.0), a.k, f1);
      } else {
#pragma unroll
        for (int d = 0; d < 9; ++d) f1[d] = T(0.0);
      }
      T* dst = ring + own + (i & (RING - 1)) * row_cells;
#pragma unroll
      for (int d = 0; d < 9; ++d) dst[d] = f1[d];
    } else if (active && lev < kp) {
      const int j = i - 2 * lev;
      const int r = ybase + j;
      if (j >= 0) {
        T f1[9];
        if (r >= 0 && r < a.rows) {
          T p[9];
          pull_level(a, ring, src + ((j - 1) & (RING - 1)) * row_cells,
                     src + (j & (RING - 1)) * row_cells,
                     src + ((j + 1) & (RING - 1)) * row_cells, lev, r, gx,
                     a.colbuf != nullptr && out_col && r >= y0 && r < y1,
                     p);
          collide_cell<T, false>(p, T(0.0), T(0.0), a.k, f1);
        } else {
#pragma unroll
          for (int d = 0; d < 9; ++d) f1[d] = T(0.0);
        }
        T* dst = ring + own + (j & (RING - 1)) * row_cells;
#pragma unroll
        for (int d = 0; d < 9; ++d) dst[d] = f1[d];
      }
    } else if (active) {  // the last level: row i - 2 kp of the output
      const int j = i - 2 * kp;
      const int r = ybase + j;
      if (r >= y0 && r < y1) {
        T p[9];
        pull_level(a, ring, src + ((j - 1) & (RING - 1)) * row_cells,
                   src + (j & (RING - 1)) * row_cells,
                   src + ((j + 1) & (RING - 1)) * row_cells, kp, r, gx,
                   a.colbuf != nullptr, p);
        Sout* o = (Sout*)a.f_out + (long long)r * xdim + (x0 + c - kp);
#pragma unroll
        for (int d = 0; d < 9; ++d) store_f(o + d * a.out_plane, p[d]);
      }
    }
    __syncthreads();
  }
}

template <typename T, typename Sin, typename Sout>
int launch_pass(const KStepArgs<T>& a, int threads, cudaStream_t st) {
  if (a.kp < 1 || a.wc <= 2 * a.kp || a.ly < 1 || threads < 1
      || threads > KStepLimits<T>::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  int smem = (a.kp * RING + STAGES) * 9 * a.wc * (int)sizeof(T);
#ifdef IBLB_KSTEP_MIN_SMEM
  // probe_kstep.py's residency A/B (ops/_kernels.VARIANTS): each block
  // asks for at least this much, so that fewer blocks fit on an SM
  smem = smem > IBLB_KSTEP_MIN_SMEM ? smem : IBLB_KSTEP_MIN_SMEM;
#endif
  const cudaError_t err = cudaFuncSetAttribute(
      kstep_kernel<T, Sin, Sout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int wt = a.wc - 2 * a.kp;
  const dim3 grid((a.xdim + wt - 1) / wt, (a.rows + a.ly - 1) / a.ly);
  kstep_kernel<T, Sin, Sout><<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// S: the storage type of bot, f_loc, top and f_out; tmp0 and tmp1 hold T
// between passes, so f rounds to S once per call, as the TPU kernel keeps
// its rows in f32 rings for all K sub-steps (pallas_step.py:994-1002).
template <typename T, typename S>
int ghost_temporal(const void* bot, long long bot_plane, const void* f_loc,
                   long long loc_plane, const void* top, long long top_plane,
                   void* f_out, long long out_plane, void* tmp0, void* tmp1,
                   const void* bhalos, void* colbuf, void* flux, int yl,
                   int pad, int xdim, int K, int inject, int is_top,
                   int seam_row, int flux_lane, int flux_owned, double tau,
                   double tau2, int forcing_trt, int deviatoric,
                   int top_noslip, int n_pass, const int* geo, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = yl + 2 * pad;
  int depth = 0;
  for (int p = 0; p < n_pass; ++p) depth += geo[4 * p];
  if (n_pass < 1 || depth != K) return (int)cudaErrorInvalidValue;
  KStepArgs<T> a{};
  a.rows = rows;
  a.xdim = xdim;
  a.top_row = is_top ? pad + yl - 1 : -1;
  a.top_noslip = top_noslip;
  a.inject_row = inject ? seam_row : -1;
  a.flux_x = flux_owned ? flux_lane : -1;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);
  T* tmp[2] = {(T*)tmp0, (T*)tmp1};
  const long long plane = (long long)rows * xdim;
  int s0 = 0;   // the pass's first sub-step
  for (int p = 0; p < n_pass; ++p) {
    if (p == 0) {
      a.f_lo = bot;
      a.lo_plane = bot_plane;
      a.lo_rows = pad;
      a.f_in = f_loc;
      a.in_plane = loc_plane;
      a.f_hi = top;
      a.hi_plane = top_plane;
      a.hi_start = pad + yl;
    } else {
      a.lo_rows = 0;
      a.hi_start = rows;
      a.f_in = tmp[(p - 1) % 2];
      a.in_plane = plane;
    }
    const bool last = p == n_pass - 1;
    a.f_out = last ? f_out : (void*)tmp[p % 2];
    a.out_plane = last ? out_plane : plane;
    a.kp = geo[4 * p];
    a.wc = geo[4 * p + 1];
    a.ly = geo[4 * p + 2];
    a.bhalos = (const T*)bhalos + (long long)s0 * 9 * xdim;
    a.colbuf = flux_owned ? (T*)colbuf + (long long)s0 * 2 * rows : nullptr;
    const int th = geo[4 * p + 3];
    const int err = p == 0 ? (last ? launch_pass<T, S, S>(a, th, st)
                                   : launch_pass<T, S, T>(a, th, st))
                           : (last ? launch_pass<T, T, S>(a, th, st)
                                   : launch_pass<T, T, T>(a, th, st));
    if (err) return err;
    s0 += a.kp;
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
// f_out's shape between passes (tmp0 unused for one pass, tmp1 for up to
// two); bhalos [K, 9, W]; colbuf [K, 2, yl + 2 pad] scratch and flux [K]
// (both unused, may be NULL, when flux_owned is 0).  geo is a host array
// of n_pass rows (kp, Wc, Ly, threads), the passes of kstep_geometry;
// their kp add up to K.
#define IBLB_GHOST(NAME, T, S)                                               \
  extern "C" int NAME(const void* bot, long long bot_plane,                  \
                      const void* f_loc, long long loc_plane,                \
                      const void* top, long long top_plane, void* f_out,     \
                      long long out_plane, void* tmp0, void* tmp1,           \
                      const void* bhalos, void* colbuf, void* flux, int yl,  \
                      int pad, int xdim, int K, int inject, int is_top,      \
                      int seam_row, int flux_lane, int flux_owned,           \
                      double tau, double tau2, int forcing_trt,              \
                      int deviatoric, int top_noslip, int n_pass,            \
                      const int* geo, void* stream) {                        \
    return ghost_temporal<T, S>(bot, bot_plane, f_loc, loc_plane, top,       \
                                top_plane, f_out, out_plane, tmp0, tmp1,     \
                                bhalos, colbuf, flux, yl, pad, xdim, K,      \
                                inject, is_top, seam_row, flux_lane,         \
                                flux_owned, tau, tau2, forcing_trt,          \
                                deviatoric, top_noslip, n_pass, geo,         \
                                stream);                                     \
  }
IBLB_GHOST(iblb_ghost_temporal_f32, float, float)
IBLB_GHOST(iblb_ghost_temporal_f64, double, double)
IBLB_GHOST(iblb_ghost_temporal_bf16, float, __nv_bfloat16)
