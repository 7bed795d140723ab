// B5, B6 and B8: the resident-band super-step, K band sub-steps plus the
// whole IB coupling behind one call.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_band_super_kernel (:1085)
// as built through _build_band_super_call (:1411, calls :1482 and :1496)
// in all of its layouts:
//   B5  make_band_super_substep (:1509), fold=True: the block is the whole
//       domain; cilium m's window starts at m*c_space - halo and wraps
//       periodically (win_lo0 = -halo);
//   B6  make_band_super_substep_tiled (:1582), fold=False: the block is one
//       x-tile of tile + 2 gx columns (ops/band_super_tiled.py gathers it
//       and keeps its interior); the tile's j-th lifted cilium has its
//       window at win_lo0 + j*c_space inside the block, with no wrap and
//       no fold, and the x-roll of the step wraps at the tile's own width
//       (garbage that the ghost columns absorb, as :1174-1175 does in a
//       JAX tile); flux_x = -1 on the tiles that do not own the flux
//       column;
//   B8  make_band_super_substep_xsharded (:1727, runtime_flux=True): the
//       block is one x-shard's xl columns plus gx ghost columns each side
//       (ops/band_super_xsharded.py); the B6 layout, with the flux column
//       at the shard's lane (-1 where another shard owns it) and, where xl
//       is not a c_space multiple, windows wwin = W + c_space wide from
//       win_lo0 = 0 (the phase-general layout, :1753-1769).
// Two arguments, win_lo0 and wwin, tell the layouts apart: a window that lies
// inside the block is never wrapped by the circle arithmetic below, so
// the same index expressions serve both.  The extended band f_ext
// [9, rows = band + pad, X] (the band plus a pad >= K row copy of the bulk
// bottom, the ghost trapezoid) advances K sub-steps; each sub-step s does
// what :1141-1319 does:
//   1. collide (collide_cell of collide.cuh), with the force below `band`
//      only, and expose the f1 of row band-1 as bhalos[s] (the temporal
//      bulk's seam halo);
//   2. pull-stream with bottom bounce-back; the top ghost row pulls zeros
//      (garbage that reaches at most K rows down, inside the pad);
//   3. take the band moments q = (rho, mom_x, mom_y) [3, band, X];
//   4. interpolate: each cilium's 128 points (nodes padded with inert
//      points) see the moments through the 3-point delta, over the window
//      of wwin (= c_space + 2 halo but in B8's phase-general layout)
//      columns from win_lo0 + m*c_space;
//   5. spread the point forces back over the windows, summing overlaps
//      (the JAX kernel's overlap-add and periodic fold);
//   6. take the flux column: the sum over band rows of the half-force
//      corrected u_x at x = flux_x.
// Outputs: f_band [9, band, X] (a row range of a larger state allowed),
// bhalos [K, 9, X], force [2, band, X] (after the last sub-step) and
// flux [K] (raw sums; the caller divides by 192; not written when
// flux_x = -1).
//
// Design: one launch per stage per sub-step, with the band L2-resident
// between them (at 2048^2 the extended band is 10.6 MB in f32, inside the
// 50 MB L2): stages 1-3 are the row kernel of step.cuh, stage 4
// interp_kernel, stages 5-6 spread_kernel, and after the K sub-steps one
// column_sum_kernel launch: 3K + 1 launches per call.  The TPU contracts
// each window densely on the MXU (a [3 band, W] x [W, 128] interpolation
// and a [2 band, 128] x [128, W] spread per cilium, with a bf16 split for
// f32 precision, :1226-1251).
// The delta has a 3-cell support (ops/ib.py:50-63), so here both stages
// are stencil gathers in full-precision FMA, in a fixed order, with no
// atomics, so a run repeats bit for bit:
//   interp_kernel: five lanes a point, one per stencil row (6 points a
//     warp, 24 a 128-thread block: 86 blocks for the 2,048 points at
//     2048^2, where one thread a point gave 16); lane r gathers row
//     ay - 2 + r, then lane 0 of the group folds the five rows in row
//     order.  No shared memory.
//   spread_kernel: one thread a band cell, 32 x 8 a block.  The block
//     first lists its candidates in shared memory: the windows that meet
//     its tile (a ballot over the cilia), then, two windows a round, the
//     points whose 5 x 5 support meets the tile widened by 2 (a ballot and
//     prefix count over each window's 128 points), in point order, each
//     with dy a0, dy a1 and dx for its five row and column offsets.  Each
//     cell then tests that list alone (the nodes that come within two
//     cells of the tile), where the all-points loop tested 384 points a
//     cell (3 windows of 128 at 2048^2), and the delta factors are formed
//     once a candidate, not once a cell.  Shared memory: 21,536 bytes a
//     block in f32, 37,920 in f64 (the list holds SCAP = 256
//     candidates).  A round that would pass 256 is preceded by a pass over
//     the list so far, which is then emptied: a block with more candidates
//     (three cilia curled into one tile hold 384) sums them in more
//     passes, in the same order, never cut.
// Both reductions take each cell's terms in the order of the earlier
// all-points loop (cilium, then point; fma for fma), so every output
// equals that version's bit for bit (PERF.md §6).
// Registers (ptxas, sm_90a): spread_kernel 47 (float) and 62 (double),
// interp_kernel 32 and 52, the forced step_kernel 32 and 63; no spills.
//
// What bounds it on an H100: arithmetic, at K = 16.  The call must read
// f_ext, the force and the points and write f_band, bhalos and the force
// (26 MB at 2048^2 in f32, 0.008 ms at 3.35 TB/s); it must do 163
// operations per band cell and sub-step in the forced collide, 101 in the
// force-free collide of the K - s ghost rows that still reach the band at
// sub-step s, plus the moments and each point's 3 x 3 delta support
// (0.80 GFLOP at K = 16, 0.012 ms at 67 TFLOP/s).  The call takes about
// 0.40 ms at 2048^2 (PERF.md; NVIDIA H100 80GB HBM3 at 700 W): per
// sub-step the forced step about 0.0096 ms, the spread 0.0072 and the
// interpolation 0.0046, each a dependent pass over the L2-resident band,
// and the 49 launches' gaps the rest.  The interpolation's and the
// spread's times are mostly each launch's fixed cost.
//
// B6 at 8192^2 (f32, K = 16), on a plan held to the card's L2 size as a
// budget: 8 tiles of 1,024 interior + 2 x 512 ghost columns, so each
// tile's working set (about 50 MB: f_ext and two scratch copies of
// 144 x 2,048 cells, f_band, q, the force) stays L2-resident across its
// 3K + 1 launches, where the whole 8192-wide band (about 42 MB of f_ext
// alone) streams each launch through HBM.  The cost of the design is
// 2 gx / tile = 2x redundant band columns and 8x the launches, and on the
// card they cost more than the HBM passes they save: the whole band (B5)
// is the faster (PERF.md), so the simulations plan no budget and run B6
// only where a caller builds a budgeted plan.  Its bound is B5's (the
// same function).
//
// bf16 storage (the _bf16 entry, the JAX package's --dtype bfloat16; B8
// shares it, but no mesh runs bf16 yet): f_ext is read and f_band written
// as bf16; the K sub-steps in between keep the band in f32 scratch, and
// the points, q, the IB stages, the force, the seam halos and the flux are
// f32, as the TPU kernel's resident state and outputs are
// (pallas_step.py:1450-1462).  f rounds once per call.  The bytes fall by
// the f_ext and f_band halves (about 20 MB at 2048^2); the arithmetic bound
// is unchanged.

#include "step.cuh"

namespace {

constexpr int NPT = 128;  // points per cilium block (nodes padded to 128)

// The reference's 3-point regularized delta (ImmersedBoundary.cu:31-78),
// spelled as ops/ib.py:delta_1d spells it.
template <typename T>
__device__ __forceinline__ T delta_1d(T r) {
  r = fabs(r);
  const T inner =
      T(0.33333) * (T(1.0) + sqrt(fmax(T(1.0) - T(3.0) * r * r, T(0.0))));
  const T d = T(1.0) - r;
  const T outer = T(0.16667) * (T(5.0) - T(3.0) * r -
                                sqrt(fmax(T(-3.0) * d * d + T(1.0), T(0.0))));
  return r <= T(0.5) ? inner : (r <= T(1.5) ? outer : T(0.0));
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <typename T>
struct IbArgs {
  const T* q;        // [3, band, X] this sub-step's band moments
  int band;
  int xdim;
  int c_num;
  int cw;            // c_space
  int win_lo0;       // window start of point block 0 in block columns
  int wwin;          // window width: c_space + 2 halo (+ c_space)
  // this sub-step's points: us [2, c, 128], the rest [c, 128]; axl is the
  // window-local anchor x (anchor_x - (m c_space - halo)), ay the anchor y
  const T* us;
  const T* eps;
  const int* axl;
  const T* fx;
  const int* ay;
  const T* fy;
  T* amp;            // [2, c, 128] point forces times eps
  T* force;          // [2, band, X] out
  T* fluxcol;        // [band] out: u_x at flux_x per band row
  int flux_x;
};

// Stage 4: F_s = 2 (u_s I_rho - I_mom) per point (ImmersedBoundary.cu:
// 94-133), times the overlap mask, from the 5 x 5 cells around its anchor
// (the delta vanishes beyond 1.5 cells and |frac| <= 0.5).  IROW lanes a
// point, lane r on stencil row ay - 2 + r with its five columns; lane 0 of
// the group then folds the rows in row order.  The sums are the
// one-thread-a-point loop's, fma for fma: t = fma(q, dx, t) along the row,
// iq = fma(dy, t, iq) down the rows, rows and columns outside the band or
// the window skipped.
constexpr int IROW = 5;                      // lanes a point
constexpr int IPW = 32 / IROW;               // points a warp (6; 2 lanes idle)
constexpr int ITHREADS = 128;
constexpr int IPB = IPW * (ITHREADS / 32);   // points a block (24)

template <typename T>
__global__ void __launch_bounds__(ITHREADS) interp_kernel(const IbArgs<T> b) {
  const int lane = threadIdx.x & 31;
  const int g = lane / IROW;
  const int r = lane - g * IROW;
  const int i = blockIdx.x * IPB + (threadIdx.x >> 5) * IPW + g;
  const int npts = b.c_num * NPT;
  const bool active = g < IPW && i < npts;
  int ok = 0;
  T dy = T(0.0);
  T t[3] = {T(0.0), T(0.0), T(0.0)};
  T em = T(0.0), us0 = T(0.0), us1 = T(0.0);
  if (active) {
    const int m = i / NPT;
    const int ay = b.ay[i];
    const int ax = b.axl[i];
    const T fx = b.fx[i];
    if (r == 0) {   // the fold's inputs, loaded early
      em = b.eps[i];
      us0 = b.us[i];
      us1 = b.us[npts + i];
    }
    const int yy = ay - 2 + r;
    if (yy >= 0 && yy < b.band) {
      ok = 1;
      dy = delta_1d(T(yy - ay) - b.fy[i]);
      const int wstart = b.win_lo0 + m * b.cw;
      const long long plane = (long long)b.band * b.xdim;
      for (int ww = ax - 2; ww <= ax + 2; ++ww) {
        if (ww < 0 || ww >= b.wwin) continue;
        const T dx = delta_1d(T(ww - ax) - fx);
        const long long j = (long long)yy * b.xdim + wrap(wstart + ww, b.xdim);
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = fma(b.q[c * plane + j], dx, t[c]);
      }
    }
  }
  // every lane takes part in the shuffles; lane 0 of a group folds
  const int base = min(g * IROW, 32 - IROW);
  T iq[3] = {T(0.0), T(0.0), T(0.0)};
#pragma unroll
  for (int rr = 0; rr < IROW; ++rr) {
    const int src = base + rr;
    const int okr = __shfl_sync(0xffffffffu, ok, src);
    const T dyr = __shfl_sync(0xffffffffu, dy, src);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T tr = __shfl_sync(0xffffffffu, t[c], src);
      if (okr) iq[c] = fma(dyr, tr, iq[c]);
    }
  }
  if (!active || r != 0) return;
  b.amp[i] = (T(2.0) * (us0 * iq[0] - iq[1])) * em;
  b.amp[npts + i] = (T(2.0) * (us1 * iq[0] - iq[2])) * em;
}

// Stages 5-6: each band cell gathers the forces of the points whose delta
// support covers it, cilium by cilium in order (every window that covers
// the cell, under the periodic wrap; in block order on a tile), then the
// flux column.  A block first lists its candidates in shared memory: the
// windows that meet its tile (the circle test below), two at a time, and
// of each the points whose 5 x 5 support meets the tile's rows and
// columns, compacted by a warp ballot in point order.  Each candidate
// carries its window start and anchor, dy * a0 and dy * a1 for the five
// row offsets and dx for the five column offsets, formed once for the
// block.  Each cell then runs the per-cell test and sum over the list
// alone: a point that misses the cell adds nothing, so its force takes
// the terms of every point that reaches it, cilium by cilium and point by
// point, as a loop over all the points would.  A list that would pass
// SCAP entries is summed and emptied first (a second pass over the rest,
// in order), never cut.
constexpr int STHREADS = TX * TY;            // 256: two windows of points
constexpr int SWARPS = STHREADS / 32;
constexpr int SCAP = 256;                    // candidates a pass
constexpr int SV = 16;                       // values a candidate (15 used)

template <typename T>
struct SpreadList {
  int win[STHREADS];     // the windows met, in order (one chunk of c_num)
  int cnt[SWARPS];       // per-warp ballot counts of a round
  int4 pt[SCAP];         // (window start on the circle, ax, ay, 0)
  T v[SCAP][SV];         // dy(o) a0, dy(o) a1, dx(o), o = 0..4: offset o - 2
};

// The block's prefix over the warps' ballots: the slot of thread tid (its
// linear index) among the set predicates, and the round's total in tot.
// Synchronises the block between writing the counts and reading them.
__device__ __forceinline__ int block_ballot(bool pred, int tid, int* cnt,
                                            int& tot) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) cnt[warp] = __popc(bal);
  __syncthreads();
  int off = __popc(bal & ((1u << lane) - 1u));
  tot = 0;
#pragma unroll
  for (int w = 0; w < SWARPS; ++w) {
    off += w < warp ? cnt[w] : 0;
    tot += cnt[w];
  }
  return off;
}

template <typename T>
__device__ __forceinline__ void spread_sum(const SpreadList<T>& s, int n,
                                           int x, int y, int xdim, int wwin,
                                           T& acc0, T& acc1) {
  for (int k = 0; k < n; ++k) {
    const int4 p = s.pt[k];
    const int oy = y - p.z + 2;
    if ((unsigned)oy > 4u) continue;
    int w = x - p.x;
    w += w < 0 ? xdim : 0;
    const int ox = w - p.y + 2;
    if (w >= wwin || (unsigned)ox > 4u) continue;
    const T dx = s.v[k][10 + ox];
    acc0 = fma(s.v[k][oy], dx, acc0);
    acc1 = fma(s.v[k][5 + oy], dx, acc1);
  }
}

template <typename T>
__global__ void __launch_bounds__(STHREADS) spread_kernel(const IbArgs<T> b) {
  __shared__ SpreadList<T> s;
  const int x0 = blockIdx.x * TX;
  const int tw = min(TX, b.xdim - x0);
  const int y0 = blockIdx.y * TY;
  const int y1 = min(y0 + TY, b.band) - 1;   // the tile's last row
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool valid = x < b.xdim && y < b.band;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int npts = b.c_num * NPT;
  T acc0 = T(0.0);
  T acc1 = T(0.0);
  int n = 0;   // entries in the list (the same in every thread)
  for (int mb = 0; mb < b.c_num; mb += STHREADS) {
    const int m = mb + tid;
    bool meet = false;
    if (m < b.c_num) {
      const int wstart = wrap(b.win_lo0 + m * b.cw, b.xdim);
      // window [wstart, wstart + W) and tile [x0, x0 + tw), on the circle
      meet = wrap(x0 - wstart, b.xdim) < b.wwin ||
             wrap(wstart - x0, b.xdim) < tw;
    }
    int nwin;
    const int wslot = block_ballot(meet, tid, s.cnt, nwin);
    if (meet) s.win[wslot] = m;
    __syncthreads();
    for (int wi = 0; wi < nwin; wi += STHREADS / NPT) {
      const int mi = wi + tid / NPT;
      bool pred = false;
      int i = 0, ws = 0, ax = 0, ay = 0;
      if (mi < nwin) {
        const int mw = s.win[mi];
        i = mw * NPT + tid % NPT;
        ws = wrap(b.win_lo0 + mw * b.cw, b.xdim);
        ay = b.ay[i];
        ax = b.axl[i];
        // the tile's columns have window columns wl .. wl + tw - 1, taken
        // modulo X: a superset of spread_sum's per-cell test
        int wl = x0 - ws;
        wl += wl < 0 ? b.xdim : 0;
        const int wh = wl + tw - 1;
        pred = ay + 2 >= y0 && ay - 2 <= y1 &&
               ((ax + 2 >= wl && ax - 2 <= wh) ||
                (ax + 2 >= wl - b.xdim && ax - 2 <= wh - b.xdim));
      }
      int tot;
      const int slot = block_ballot(pred, tid, s.cnt, tot);
      if (n + tot > SCAP) {   // block-uniform: sum the list, empty it
        if (valid) spread_sum(s, n, x, y, b.xdim, b.wwin, acc0, acc1);
        n = 0;
        __syncthreads();
      }
      if (pred) {
        const int k = n + slot;
        const T fy = b.fy[i];
        const T fx = b.fx[i];
        const T a0 = b.amp[i];
        const T a1 = b.amp[npts + i];
        s.pt[k] = make_int4(ws, ax, ay, 0);
#pragma unroll
        for (int o = 0; o < 5; ++o) {
          const T dy = delta_1d(T(o - 2) - fy);
          s.v[k][o] = dy * a0;
          s.v[k][5 + o] = dy * a1;
          s.v[k][10 + o] = delta_1d(T(o - 2) - fx);
        }
      }
      n += tot;
      __syncthreads();   // the entries are written
    }
  }
  if (!valid) return;
  spread_sum(s, n, x, y, b.xdim, b.wwin, acc0, acc1);
  const long long j = (long long)y * b.xdim + x;
  b.force[j] = acc0;
  b.force[(long long)b.band * b.xdim + j] = acc1;
  if (x == b.flux_x) {  // never for flux_x = -1
    const long long plane = (long long)b.band * b.xdim;
    b.fluxcol[y] = (b.q[plane + j] + T(0.5) * acc0) / b.q[j];
  }
}

// S: the storage type of f_ext and f_band.  The sub-steps between the
// first read and the last write keep the band in buf0 and buf1 as T, so f
// rounds to S once per call, as the TPU kernel's resident f32 scratch
// (pallas_step.py:1452-1462) keeps the IB feedback at full precision.
template <typename T, typename S>
int band_super(const void* f_ext, long long ext_plane, void* f_band,
               long long band_plane, const void* force_in, void* force_out,
               const void* us, const void* eps, const void* axl,
               const void* fx, const void* ay, const void* fy, void* bhalos,
               void* buf0, void* buf1, void* q, void* amp, void* colbuf,
               void* flux, int rows, int band, int xdim, int K, int c_num,
               int cw, int wwin, int win_lo0, int flux_x, double tau,
               double tau2, int forcing_trt, int deviatoric, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  StepArgs<T> a{};
  a.rows = rows;
  a.xdim = xdim;
  a.band = band;
  a.y0 = 0;
  a.is_bottom = 1;
  a.expose_row = band - 1;
  a.q_rows = band;
  a.q = (T*)q;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);

  IbArgs<T> b{};
  b.q = (const T*)q;
  b.band = band;
  b.xdim = xdim;
  b.c_num = c_num;
  b.cw = cw;
  b.win_lo0 = win_lo0;
  b.wwin = wwin;
  b.amp = (T*)amp;
  b.force = (T*)force_out;
  b.flux_x = flux_x;

  void* buf[2] = {buf0, buf1};
  const long long bplane = (long long)rows * xdim;
  const long long pts = (long long)c_num * NPT;
  const dim3 sgrid((xdim + TX - 1) / TX, (band + TY - 1) / TY);
  const int iblocks = (int)((pts + IPB - 1) / IPB);
  for (int s = 0; s < K; ++s) {
    a.f_in = s == 0 ? f_ext : buf[(s - 1) % 2];
    a.in_plane = s == 0 ? ext_plane : bplane;
    const bool last = s == K - 1;
    a.f_out = last ? f_band : buf[s % 2];
    a.out_plane = last ? band_plane : bplane;
    a.out_rows = last ? band : rows;
    a.force = s == 0 ? (const T*)force_in : (const T*)force_out;
    a.f1out = (T*)bhalos + (long long)s * 9 * xdim;
    int err = s == 0 ? (last ? launch_step<S, S>(a, true, st)
                             : launch_step<S, T>(a, true, st))
                     : (last ? launch_step<T, S>(a, true, st)
                             : launch_step<T, T>(a, true, st));
    if (err) return err;

    b.us = (const T*)us + s * 2 * pts;
    b.eps = (const T*)eps + s * pts;
    b.axl = (const int*)axl + s * pts;
    b.fx = (const T*)fx + s * pts;
    b.ay = (const int*)ay + s * pts;
    b.fy = (const T*)fy + s * pts;
    b.fluxcol = flux_x >= 0 ? (T*)colbuf + (long long)s * band : nullptr;
    interp_kernel<T><<<iblocks, ITHREADS, 0, st>>>(b);
    err = (int)cudaGetLastError();
    if (err) return err;
    spread_kernel<T><<<sgrid, dim3(TX, TY), 0, st>>>(b);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (flux_x < 0) return 0;  // a tile without the flux column
  column_sum_kernel<T, false><<<K, SUM_THREADS, 0, st>>>(
      (const T*)colbuf, band, 0, band, (T*)flux);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's: _f32, _f64, and _bf16 with
// f_ext and f_band bf16 and every other array float (the points, force,
// bhalos, q, amp, colbuf, flux and the scratch buf0 and buf1).  X is the
// block's width (the domain for B5, tile + 2 gx for B6); f_ext [9, rows, X]
// and f_band
// [9, band, X] have plane strides ext_plane and band_plane (elements) and
// must not overlap; force_in and force_out [2, band, X] must not overlap;
// point arrays [K, (2,) c_num, 128] (axl, ay int32; c_num the block's
// point blocks); bhalos [K, 9, X]; scratch buf0, buf1 [9, rows, X] (buf1
// unused for K <= 2, both for K = 1), q [3, band, X], amp
// [2, c_num, 128], colbuf [K, band]; flux [K].  wwin is the window width
// (c_space + 2 halo, or c_space wider in B8's phase-general layout);
// win_lo0 = -halo is B5's layout; flux_x = -1 leaves colbuf and flux
// unused (may be NULL).
#define IBLB_BAND_SUPER(NAME, T, S)                                          \
  extern "C" int NAME(                                                       \
      const void* f_ext, long long ext_plane, void* f_band,                  \
      long long band_plane, const void* force_in, void* force_out,           \
      const void* us, const void* eps, const void* axl, const void* fx,      \
      const void* ay, const void* fy, void* bhalos, void* buf0, void* buf1,  \
      void* q, void* amp, void* colbuf, void* flux, int rows, int band,      \
      int xdim, int K, int c_num, int cw, int wwin, int win_lo0,             \
      int flux_x, double tau, double tau2, int forcing_trt, int deviatoric,  \
      void* stream) {                                                        \
    return band_super<T, S>(f_ext, ext_plane, f_band, band_plane, force_in,  \
                            force_out, us, eps, axl, fx, ay, fy, bhalos,     \
                            buf0, buf1, q, amp, colbuf, flux, rows, band,    \
                            xdim, K, c_num, cw, wwin, win_lo0, flux_x, tau,  \
                            tau2, forcing_trt, deviatoric, stream);          \
  }
IBLB_BAND_SUPER(iblb_band_super_f32, float, float)
IBLB_BAND_SUPER(iblb_band_super_f64, double, double)
IBLB_BAND_SUPER(iblb_band_super_bf16, float, __nv_bfloat16)
