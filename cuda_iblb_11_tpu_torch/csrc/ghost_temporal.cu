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
// level lets level s pull rows j - 1, j, j + 1 while level s - 1 writes
// row j + 2 into the fourth.  The levels meet at mbarriers in shared
// memory, not at a barrier of the whole CUDA block: each waits only for
// its two neighbours' last iteration (struct Sync), so the warps of an SM
// leave their waits at their own times.  Level 0 copies its input rows
// three rows ahead into a stage ring of four rows (cp.async, one commit
// group per row).  Level s is exact on columns [s, Wc - s) and on rows
// [segment - kp + s, segment end + kp - s), so the output strip and
// segment are exact, and every output cell is computed by the same
// operations on the same values as K launches of the row kernel of
// step.cuh would: bit for bit.  Rows outside the block are zeros at
// every level, as there.  The seam's injected pulls and the top wall are
// those of step.cuh, in its order.  The threads are three roles, each
// from a warp boundary: Wc - 2s for each level s in 1..kp-1 (pull,
// collide), level 0's Wc loaders (copy, collide) and the last level's Wt
// (pull, store), so every thread but the last role's collides one cell
// per row.
// Per-row work outside the collide is what an issue-bound kernel spends
// its time on, so each role runs its own row loop (per row: its waits,
// its step, one arrival), unrolled by the rings' period of four: every
// ring row a step reads or writes, and every mbarrier it waits or arrives
// on, is one of four the thread computed once, chosen at compile time.
// The segment's row count is rounded up to that period (at most three
// more iterations, on rows no output needs).  A level's
// step takes a fast path on the rows that are plain for it (j >= 0,
// inside the block, neither the seam's nor the top wall's): nine pulls,
// the flux if it is the flux lane's, the collide, nine stores.  The
// others take the full path (the fix-ups, zeros outside the block).  The
// loop-invariant values live in registers, not in the kernel's
// parameters.  The geometry is ops/ghost_temporal.py's kstep_geometry,
// which both the wrapper and the tests call: Wc as wide as the kernel's
// threads (1,024 in f32, 768 in f64, its __launch_bounds__) and 227 KB of
// shared memory allow, and Ly so that the strips times the segments fill
// the card's SMs in the fewest row iterations.  At K = 16 (two passes of
// 8):
//   f32: Wc = 117, Wt = 101, 1,024 threads, (8 x 4 + 4) x 9 x 117 x 4 B
//        and 288 B of mbarriers = 151,920 B of shared memory, redundancy
//        1.213 at 2048^2;
//   f64: Wc = 89, Wt = 73, 768 threads, (8 x 4 + 4) x 9 x 89 x 8 + 288 B =
//        230,976 B, redundancy 1.301 at 2048^2.
// Depth 8 is the choice for both types from probe_kstep.py's timings of
// depths 4, 8 and 16 (PERF.md): one pass of 16 is slower (Wc = 73 in f32,
// so more ghost columns per kept one), four of 4 about as fast as two of
// 8.  Each level of the flux lane writes (rho, mom_x) of its owned rows
// into colbuf from the one CUDA block whose output strip and segment hold
// the cell, and one launch of column_sum_kernel reduces the K columns in a
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
// above that is instruction issue and the warps' waits, not memory or
// occupancy.  A collided cell's collide is about 105 SASS instructions
// (its divide and the two storages' selects included: the storage stays a
// runtime flag, as in every kernel, since as a constant it lets the
// compiler contract the collide's a*b - c*d the other way, and B4 would
// no longer be bit for bit K launches of B3).  Around it a level's fast
// step issues about 32 more (pulls, stores, the row's tests) and its
// mbarriers about 5 (two try-waits with their branches, one arrival; a
// warp of two levels waits twice as often); level 0's step issues about
// 190 (its copies) and the last level's about 70 (no collide).
// probe_kstep.py reads the issue slots per collided cell from the time,
// the SM clock and the collided cells: 229 at 2048^2 in f32 (149 with the
// collide a copy), against 247 (163) when every row ended at a barrier of
// the whole block (the design before the mbarriers: the warps left it in
// lockstep, and those done first waited for the loaders' longer steps and
// each row's tail); per call 0.52 ms against 0.56 at 2048^2, 7.7 against
// 8.3 ms at 8192^2, 0.84 against 0.90 in f64 at 2048^2 (NVIDIA H100 80GB
// HBM3 at 700 W; the two builds in turns, PERF.md).  Measured slower and
// not kept: each lane of a warp of two levels waiting for its own level's
// neighbours alone (the lanes part at the wait, and the step runs once
// for each part: 0.65 ms), rings of six rows in f32 (a level may run
// three rows ahead of the one above it, but the larger unrolled loop is
// slower: 0.57 ms), one arrival a warp after a __syncwarp, one waiting
// lane a warp, polling with test_wait, the write's wait moved after the
// collide, and the full row path out of line.  A CUDA block of 1,024
// threads is 32 warps a SM (58 registers a thread in f32); two 512-thread
// blocks a SM are 7% slower per collided cell, one 512-thread block a SM
// (16 warps) 1.29x slower than two.
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

// threads per CUDA block at most (registers: 58 a thread in f32, 80 in
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
static_assert(STAGES == RING, "the stage rows follow the ring rows");
constexpr int NO_ROW = -(1 << 30);   // a row index no block row equals

__device__ constexpr int warps32(int n) { return (n + 31) / 32 * 32; }

// The mbarriers between neighbouring levels (shared memory, 8 bytes each,
// addressed as 32-bit shared-space addresses).  arrive: release the
// thread's earlier shared-memory reads and writes to the threads that wait
// on the phase it completes; wait: until the phase of the given parity has
// completed, then acquire them (a barrier in phase 0 has completed the
// phase of parity 1 before it, so that wait passes at once).
__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

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
  int top_row;            // the top wall's row, or NO_ROW
  int top_noslip;
  int inject_row;         // the seam row, or NO_ROW
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

// The post-stream values p of a cell, pulled from the ring of the sub-step
// before: lo, mid and hi point at its column's cells in rows r - 1, r and
// r + 1 (a cell's nine values lie in a row, its x-neighbours 9 values
// away).
template <typename T>
__device__ __forceinline__ void pull_plain(const T* lo, const T* mid,
                                           const T* hi, T (&p)[9]) {
  // pull from (r - cy, x - cx)
  p[0] = mid[0];
  p[1] = mid[-9 + 1];
  p[2] = lo[2];
  p[3] = mid[9 + 3];
  p[4] = hi[4];
  p[5] = lo[-9 + 5];
  p[6] = lo[9 + 6];
  p[7] = hi[9 + 7];
  p[8] = hi[-9 + 8];
}

// pull_plain at block row r and column gx of sub-step s, then the seam's
// and the top wall's fix-ups of step.cuh, in its order.
template <typename T>
__device__ __forceinline__ void pull_cell(const KStepArgs<T>& a,
                                          const T* lo, const T* mid,
                                          const T* hi, int s, int r, int gx,
                                          T (&p)[9]) {
  pull_plain(lo, mid, hi, p);
  if (r == a.inject_row) {  // the seam: pull (r - 1, x - cx) from bhalos
    const int xdim = a.xdim;
    const T* inj = a.bhalos + (long long)(s - 1) * 9 * xdim;
    const int xm = gx == 0 ? xdim - 1 : gx - 1;
    const int xp = gx == xdim - 1 ? 0 : gx + 1;
    p[2] = inj[2 * xdim + gx];
    p[5] = inj[5 * xdim + xm];
    p[6] = inj[6 * xdim + xp];
  }
  if (r == a.top_row) {
    p[4] = mid[2];
    if (a.top_noslip) {  // bounce-back
      p[7] = mid[5];
      p[8] = mid[6];
    } else {  // specular slip
      p[8] = mid[5];
      p[7] = mid[6];
    }
  }
}

// (rho, mom_x) of the post-stream values p of sub-step s at row r into
// colbuf[s - 1]: the flux lane's column sums them.
template <typename T>
__device__ __forceinline__ void flux_cell(const KStepArgs<T>& a,
                                          const T (&p)[9], int s, int r) {
  T rho, mom_x, mom_y;
  moments9(p, a.k.deviatoric, rho, mom_x, mom_y);
  T* col = a.colbuf + (long long)(s - 1) * 2 * a.rows;
  col[r] = rho;
  col[a.rows + r] = mom_x;
}

template <typename T>
__device__ __forceinline__ void put_cell(T* dst, const T (&f1)[9]) {
#pragma unroll
  for (int d = 0; d < 9; ++d) dst[d] = f1[d];
}

template <typename T>
__device__ __forceinline__ void zero_cell(T* dst) {
#pragma unroll
  for (int d = 0; d < 9; ++d) dst[d] = T(0.0);
}

// The synchronisation of one role (level s: 0 the loaders, kp the
// stores), in place of a barrier for the whole CUDA block each row.
// done[s] holds RING mbarriers, one a slot of RING iterations, and counts
// level s's threads; each of them arrives on done[s][i mod RING] when it
// has finished iteration i: its ring row of that iteration written, its
// pulls from the ring below done.  Before iteration i it waits for
//   below (s >= 1): done[s - 1] of iteration i - 1, where level s - 1
//     wrote row j + 1, the newest of the rows j - 1, j, j + 1 that level s
//     pulls (the older two were waited for before);
//   above (s < kp): done[s + 1] of iteration i - 1, where level s + 1
//     pulled for the last time from ring row j - 4, the one that
//     iteration i overwrites.
// So no level waits for more than its neighbours' last iteration, and the
// levels' warps leave their waits at their own times, not in lockstep.
// Each wait strictly precedes its iteration, so nothing waits in a cycle;
// and no level can finish a slot's next phase before its neighbours have
// waited on this one, so a wait by parity sees the phase it means.  par is
// the parity of iteration i's round, i / 4; the wait of iteration 0 is for
// the phase before the barriers' first, which passes at once.
template <bool kBelow, bool kAbove>
struct Sync {
  unsigned below, above, own;   // done[s - 1], done[s + 1], done[s]
  // A warp that holds two levels (s and s + 1: levels 1..kp-1 share
  // warps) waits for what either waits for, below and below + 1, above
  // and above + 1 of its lower level, so that its lanes never part at a
  // wait: lanes parted there ran the rest of the step twice.
  bool two;

  template <int kPh>
  __device__ __forceinline__ void wait(unsigned par) const {
    // done[.][(i - 1) mod 4] in round (i - 1) / 4
    const unsigned slot = 8 * ((kPh + RING - 1) & (RING - 1));
    const unsigned p = kPh == 0 ? par ^ 1 : par;
    if constexpr (kBelow) {
      bar_wait(below + slot, p);
      if (two) bar_wait(below + 8 * RING + slot, p);
    }
    if constexpr (kAbove) {
      bar_wait(above + slot, p);
      if (two) bar_wait(above + 8 * RING + slot, p);
    }
  }

  template <int kPh>
  __device__ __forceinline__ void arrive() const {
    bar_arrive(own + 8 * kPh);
  }
};

template <int kPh, typename Row>
__device__ __forceinline__ void sync_step(Row& row, int i, unsigned par) {
  row.sync.template wait<kPh>(par);
  row.template step<kPh>(i);
  row.sync.template arrive<kPh>();
}

// The row loop every role runs: n_it iterations, a multiple of the ring's
// period, unrolled by that period so that each iteration's ring rows and
// mbarriers are compile-time choices among four (ph = i mod 4).
template <typename Row>
__device__ __forceinline__ void row_loop(int n_it, Row& row) {
  static_assert(RING == 4, "the loop is unrolled by the ring's period");
  unsigned par = 0;
  for (int i = 0; i < n_it; i += RING, par ^= 1) {
    sync_step<0>(row, i, par);
    sync_step<1>(row, i + 1, par);
    sync_step<2>(row, i + 2, par);
    sync_step<3>(row, i + 3, par);
  }
}

// In every role a thread works on one column c of the strip; ring row j of
// a level holds its rows j, j + 4, ... (rc = 9 wc values a row), and
// slot[m] points at this thread's cell in the ring row that iteration i
// with i mod 4 = m works on, so a step's ring rows are slot[ph] and its
// neighbours slot[ph -+ 1 mod 4].  The segment's output rows are [y0,
// y1); level 0 starts kp rows below them, at ybase, and level s works on
// row ybase + i - 2 s.

// Level 0: the input row ybase + i, copied STAGES - 1 rows ahead into this
// thread's cell of the stage ring (stage_off values on from its ring 0
// cell; no mbarrier: each loader reads only what it copied), collided into
// ring 0.  kAsync: Sin is T, so cp.async stages it; a bf16 input
// (cp.async copies 4, 8 or 16 bytes, not 2) is loaded row by row and
// widened in registers, its latency hidden by the other roles' warps.
template <typename T, typename Sin, bool kAsync>
struct LoadRows {
  const KStepArgs<T>& a;
  const Coeffs<T>& k;
  Sync<false, true> sync;
  T* slot[RING];     // ring 0
  int stage_off;     // the stage ring's cell, from ring 0's
  int gx, ybase, end, rows;

  template <int kPh>
  __device__ __forceinline__ void step(int i) {
    const int r = ybase + i;
    const bool in_block = r >= 0 && r < rows && r < end;
    T f[9];
    if constexpr (kAsync) {
      fetch_row(a, r + STAGES - 1, end, gx,
                slot[(kPh + STAGES - 1) & (RING - 1)] + stage_off);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
      const T* in = slot[kPh] + stage_off;
#pragma unroll
      for (int d = 0; d < 9; ++d) f[d] = in[d];
    } else {
#pragma unroll
      for (int d = 0; d < 9; ++d) f[d] = T(0.0);
      if (in_block) {
        long long plane;
        const Sin* row = row_src<Sin>(a, r, plane) + gx;
#pragma unroll
        for (int d = 0; d < 9; ++d) f[d] = load_f(row + d * plane);
      }
    }
    T f1[9];
    collide_cell<T, false>(f, T(0.0), T(0.0), k, f1);
    if (in_block) {
      put_cell(slot[kPh], f1);
    } else {
      zero_cell(slot[kPh]);
    }
  }
};

// Levels 1..kp-1: pull row j = i - 2 lev of the level below from its ring
// rows j - 1, j, j + 1 (slot), collide, write ring row j of this level
// (own_off values on); flux: this thread is the flux lane's output column,
// whose rows [y0, y1) it sums.  The rows the fast path takes: j >= 0
// inside the block, not the seam's or the top wall's; the rest take the
// full path (step.cuh's fix-ups in its order, zeros outside the block).
template <typename T>
struct LevelRows {
  const KStepArgs<T>& a;
  const Coeffs<T>& k;
  Sync<true, true> sync;
  const T* slot[RING];   // ring lev - 1
  int own_off;
  int lev, gx, ybase, y0, y1, lo, n_fast, inject_row, top_row;
  bool flux;

  template <int kPh>
  __device__ __forceinline__ void step(int i) {
    const T* lo_row = slot[(kPh + 3) & (RING - 1)];
    const T* mid = slot[kPh];
    const T* hi = slot[(kPh + 1) & (RING - 1)];
    T* dst = const_cast<T*>(mid) + own_off;
    const int r = ybase + i - 2 * lev;
    T p[9], f1[9];
    if ((unsigned)(r - lo) < (unsigned)n_fast && r != inject_row
        && r != top_row) {
      pull_plain(lo_row, mid, hi, p);
      if (flux && r >= y0 && r < y1) flux_cell(a, p, lev, r);
      collide_cell<T, false>(p, T(0.0), T(0.0), k, f1);
      put_cell(dst, f1);
    } else if (r >= ybase) {   // row j >= 0 of this level
      pull_cell(a, lo_row, mid, hi, lev, r, gx, p);
      if (flux && r >= y0 && r < y1) flux_cell(a, p, lev, r);
      collide_cell<T, false>(p, T(0.0), T(0.0), k, f1);
      if (r >= 0 && r < a.rows) {
        put_cell(dst, f1);
      } else {
        zero_cell(dst);
      }
    }
  }
};

// Level kp: pull output row j = i - 2 kp of the segment from ring kp-1
// and store it at out (this thread's column in row 0 of f_out).
template <typename T, typename Sout>
struct StoreRows {
  const KStepArgs<T>& a;
  Sync<true, false> sync;
  const T* slot[RING];   // ring kp - 1
  Sout* out;
  long long out_plane;
  int xdim, kp, gx, ybase, y0, y1;
  bool flux;

  template <int kPh>
  __device__ __forceinline__ void step(int i) {
    const int r = ybase + i - 2 * kp;
    if (r >= y0 && r < y1) {
      T p[9];
      pull_cell(a, slot[(kPh + 3) & (RING - 1)], slot[kPh],
                slot[(kPh + 1) & (RING - 1)], kp, r, gx, p);
      if (flux) flux_cell(a, p, kp, r);
      Sout* o = out + (long long)r * xdim;
#pragma unroll
      for (int d = 0; d < 9; ++d) store_f(o + d * out_plane, p[d]);
    }
  }
};

// Bytes of a pass's mbarriers ahead of its rings: done[0..kp], RING each,
// rounded up to 16 (the rings' alignment).
__host__ __device__ constexpr int kstep_bar_bytes(int kp) {
  return ((kp + 1) * RING * 8 + 15) / 16 * 16;
}

// Sin and Sout: the types the pass reads and writes f as.
template <typename T, typename Sin, typename Sout>
__global__ void __launch_bounds__(KStepLimits<T>::kThreads)
    kstep_kernel(const KStepArgs<T> a) {
  // shared memory: the mbarriers done[kp + 1][RING], then a ring
  // [RING][wc][9] for each level 0..kp-1, then level 0's stage ring
  // [STAGES][wc][9]; a cell's nine values in a row (an odd stride: a
  // warp's 32 columns hit 32 banks)
  extern __shared__ __align__(16) unsigned char kstep_smem[];
  const int wc = a.wc, kp = a.kp, xdim = a.xdim, rows = a.rows;
  T* const ring = reinterpret_cast<T*>(kstep_smem + kstep_bar_bytes(kp));
  const unsigned bars = (unsigned)__cvta_generic_to_shared(kstep_smem);
  const int wt = wc - 2 * kp;
  const int x0 = blockIdx.x * wt;           // the strip's first column
  const int y0 = blockIdx.y * a.ly;         // the segment's output rows
  const int y1 = min(y0 + a.ly, rows);
  const int ybase = y0 - kp;                // level 0's first row
  // the rows level 0 to level kp sweep, rounded up to the ring's period
  // (the last iterations then work on rows no output needs)
  const int n_it = (y1 - ybase + 2 * kp + RING - 1) / RING * RING;
  const int rc = 9 * wc;
  const int level_cells = RING * rc;
  const Coeffs<T> k = a.k;

  for (int e = threadIdx.x; e < kp * level_cells; e += blockDim.x) {
    ring[e] = T(0.0);
  }
  // this thread's role, each group starting at a warp: the columns [s, wc
  // - s) of levels s = 1..kp-1 (pull, collide), level 0's wc loaders
  // (copy, collide) and the last level's wt columns [kp, wc - kp) (pull,
  // store), those of the strip's output; kstep_geometry counts the same
  // threads.  The others leave after the set-up.
  const int n_lev = warps32((kp - 1) * wc - kp * (kp - 1));
  const int n_load = warps32(wc);
  const int n_store = min(wt, xdim - x0);
  if (threadIdx.x == 0) {   // each level's threads arrive on its done[s]
    for (int s = 0; s <= kp; ++s) {
      const int count = s == 0 ? wc : s < kp ? wc - 2 * s : n_store;
      for (int m = 0; m < RING; ++m) {
        bar_init(bars + 8 * (s * RING + m), count);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
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
    c -= n_lev + n_load;
    active = c < n_store;
    c += kp;
  }
  int gx = (x0 - kp + c) % xdim;
  if (gx < 0) gx += xdim;
  // whether this column is the strip's output and the flux lane
  const bool flux = a.colbuf != nullptr && c >= kp && c < wc - kp
                    && x0 + c - kp < xdim && gx == a.flux_x;

  constexpr bool kAsync = sizeof(Sin) == sizeof(T);
  T* const own0 = ring + 9 * c;   // this column's cell, ring 0, row 0
  const int stage_off = kp * level_cells;
  if constexpr (kAsync) {
    if (active && lev == 0) {
      for (int q = 0; q < STAGES - 1; ++q) {
        fetch_row(a, ybase + q, y1 + kp, gx, own0 + stage_off + q * rc);
      }
    }
  }
  // the lowest and highest level of this warp's working lanes
  const int lev_lo = __reduce_min_sync(0xffffffffu, active ? lev : kp);
  const int lev_hi = __reduce_max_sync(0xffffffffu, active ? lev : 0);
  __syncthreads();
  if (!active) return;
  const Sync<true, true> sync{bars + 8 * RING * (lev_lo - 1),
                              bars + 8 * RING * (lev_lo + 1),
                              bars + 8 * RING * lev, lev_hi != lev_lo};
  if (lev == 0) {
    LoadRows<T, Sin, kAsync> row{a, k, {sync.below, sync.above, sync.own,
                                        false},
                                 {}, stage_off, gx, ybase, y1 + kp, rows};
#pragma unroll
    for (int m = 0; m < RING; ++m) row.slot[m] = own0 + m * rc;
    row_loop(n_it, row);
  } else if (lev < kp) {
    // rows a fast step may take: j >= 0, inside the block
    const int lo = max(ybase, 0);
    LevelRows<T> row{a, k, sync, {}, level_cells, lev, gx, ybase, y0, y1,
                     lo, rows - lo, a.inject_row, a.top_row, flux};
#pragma unroll
    for (int m = 0; m < RING; ++m) {
      row.slot[m] = own0 + (lev - 1) * level_cells
                    + ((m - 2 * lev) & (RING - 1)) * rc;
    }
    row_loop(n_it, row);
  } else {
    StoreRows<T, Sout> row{a, {sync.below, sync.above, sync.own, false},
                           {}, (Sout*)a.f_out + (x0 + c - kp), a.out_plane,
                           xdim, kp, gx, ybase, y0, y1, flux};
#pragma unroll
    for (int m = 0; m < RING; ++m) {
      row.slot[m] = own0 + (kp - 1) * level_cells
                    + ((m - 2 * kp) & (RING - 1)) * rc;
    }
    row_loop(n_it, row);
  }
}

template <typename T, typename Sin, typename Sout>
int launch_pass(const KStepArgs<T>& a, int threads, cudaStream_t st) {
  if (a.kp < 1 || a.wc <= 2 * a.kp || a.ly < 1 || threads < 1
      || threads > KStepLimits<T>::kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  int smem = kstep_bar_bytes(a.kp)
             + (a.kp * RING + STAGES) * 9 * a.wc * (int)sizeof(T);
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
  a.top_row = is_top ? pad + yl - 1 : NO_ROW;
  a.top_noslip = top_noslip;
  a.inject_row = inject ? seam_row : NO_ROW;
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
