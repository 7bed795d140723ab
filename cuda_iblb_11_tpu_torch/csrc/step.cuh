// The collide + pull-stream step over a block of rows, shared by B2/B3
// and B2h (fused_step.cu) and the first stage of each B5/B6/B8 sub-step
// (band_super.cu; from the second sub-step on with the spread of the one
// before folded in: the kSpread flag below).  B4 and B7
// (ghost_temporal.cu) repeat its pulls, seam and top wall operation for
// operation in their temporally blocked kernel, and use its flux sum
// (column_sum_kernel).  B0's bf16 entry
// (collide_rows.cu) reads f through its load_f.
//
// Replaces the body of cuda_iblb_11_tpu/ops/pallas_step.py:_pipelined_kernel
// (:181), both as make_fused_substep builds it (B2: the whole domain) and
// with sharded=True as make_sharded_fused_substep builds it (B3: a row
// block with flags, neighbour halo rows, an exposed f1 row and emission).
//
// What it computes, per cell (r, x) of a block f [9, rows, X] whose rows
// are the global rows y0 + r:
//   1. collide (B1, collide.cuh) with the force of global row y0 + r when
//      it is below the force band (force holds the band rows [0, band));
//   2. pull-stream: out[d](r, x) = f1[d](r - cy, x - cx), x periodic; the
//      row below the block is the bhalo row and the row above it the
//      thalo row (each [9, X], already post-collision; zeros when absent);
//   3. wall fix-ups from the same cell's own f1: bottom (r = 0, when
//      is_bottom) halfway bounce-back 2<-4 5<-7 6<-8; top (r = top_row,
//      usually rows-1, -1 for none) slip 4<-2 8<-5 7<-6 or no-slip 4<-2
//      7<-5 8<-6; and the seam (r = inject_row, -1 for none), whose
//      up-going pulls 2, 5, 6 come from the injected row ([9, X], the f1
//      of the row below the block's bulk) instead of row r-1 (B7);
//   4. outputs: the streamed rows r < out_rows; the f1 of row expose_row
//      ([9, X], the temporal bulk's seam halo); q = (rho, mom_x, mom_y)
//      for rows r < q_rows; fluxcol = (rho, mom_x) at x = flux_x for every
//      row.  Every output but the streamed rows is optional, and the
//      kEmit = false instantiation (B2h, the collide + stream without
//      emission) carries none of their code: it writes the streamed rows
//      only.
// Template flags: kForced (the force read below the band), kEmit, and
// kSpread, which only band_super.cu's band step of sub-steps s >= 1
// takes: it forms the force of the cells it collides from sub-step
// s - 1's points (the spread, fma for fma as spread_kernel forms it)
// instead of reading it, and writes s - 1's flux column, and in double
// asks the compiler for 4 blocks an SM (StepKernel::kMinBlocks; 0, no
// request, for every other instantiation).  B2, B2h, B3 (fused_step.cu)
// and B5's first sub-step never take it, so their instantiations are the
// kSpread = false ones, as before the flag (the same registers and SASS).
//
// Design: one block per 32 x 8 tile.  The block collides its tile plus a
// one-cell halo (34 x 10 cells) into shared memory (9 x 10 x 34 values,
// 12 KB in f32), synchronises, and each thread then pulls its nine
// post-stream values from shared memory.  Ragged tiles are masked; any
// rows >= 1 and any X work.  The input and output rows are read and written
// with a plane stride of their own, so a block may be a row range of a
// larger [9, Y, X] state; the rows may also come from three buffers, rows
// [0, lo_rows) from f_lo, [hi_start, rows) from f_hi and the rest from
// f_in (B7's first sub-step reads the ghost rows and the shard's own rows
// where they lie).  f is read from one buffer and written to
// another: CUDA blocks run in no order, so the TPU kernel's in-place update
// (safe there only by its lag-1 grid order, pallas_step.py:548) is not
// used.
//
// What bounds it on an H100: memory.  Per f32 cell it reads 9 f values
// (36 B) plus the force inside the band (8 B) and writes 9 f values (36 B)
// plus q inside the band (12 B): about 80 B/cell (in bf16 storage f moves
// at 2 B a value, about 44 B/cell).  The 1.33x halo re-read
// of f (34*10 / (32*8)) mostly hits L2.  About 200 flop/cell is far below
// the card's f32 (and f64) rate.

#pragma once

#include <cuda_bf16.h>

#include "collide.cuh"

namespace {

// Storage and compute types.  Every kernel computes in T (float or double)
// and reads and writes f in HBM as a storage type S: T itself, or
// __nv_bfloat16 under bf16 storage with T = float, as the TPU kernels keep
// f in HBM at the storage dtype and compute in f32 (pallas_step.py:
// 482-497).  A load widens exactly; a store rounds to nearest even
// (__float2bfloat16_rn, as torch's .to(torch.bfloat16) and JAX's astype
// round).  Everything else (force, halos, exposed rows, q, flux columns)
// stays in T.
template <typename T>
__device__ __forceinline__ T load_f(const T* p) {
  return *p;
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename S, typename T>
__device__ __forceinline__ void store_f(S* p, T v) {
  *p = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SX = TX + 2;
constexpr int SY = TY + 2;

// T is the compute type.  The f arrays are untyped: step_kernel reads
// f_in, f_lo and f_hi as its Sin and writes f_out as its Sout (B5's first
// and last sub-steps read and write the storage type, the resident ones T).
template <typename T>
struct StepArgs {
  const void* f_in;
  long long in_plane;     // elements between populations of f_in
  const void* f_lo = nullptr;  // rows [0, lo_rows) (lo_rows = 0: none)
  long long lo_plane = 0;
  int lo_rows = 0;
  const void* f_hi = nullptr;  // rows [hi_start, rows)
  long long hi_plane = 0;
  int hi_start = 1 << 30;
  void* f_out;
  long long out_plane;
  int out_rows;           // rows written to f_out (<= rows)
  int rows;
  int xdim;
  const T* force;         // [2, band, X] or nullptr (force-free)
  int band;
  int y0;                 // global row of local row 0
  int is_bottom;
  int top_row = -1;       // local row of the top wall, or -1
  int top_noslip;
  const T* bhalo;         // [9, X] or nullptr (zeros)
  const T* thalo;         // [9, X] or nullptr (zeros)
  int inject_row = -1;    // local row whose up-going pulls read inject
  const T* inject = nullptr;  // [9, X]
  int expose_row;         // local row, or -1
  T* f1out;               // [9, X]
  int q_rows;             // 0: no q
  T* q;                   // [3, q_rows, X]
  int flux_x;
  T* fluxcol;             // [2, rows] or nullptr
  Coeffs<T> k;
};

// kSpread's arguments, shared memory (the collide tile aliased with the
// spread's candidate list) and register request are BandStep<T>'s, which
// band_super.cu defines.  BandStep<T>::form_forces leaves each collided
// band cell's force in planes 0 and 1 of the collide tile, at the cell's
// own place, where the thread that collides the cell reads it before it
// writes the cell's f1 there.
template <typename T>
struct BandStep;

template <typename T, bool kSpread>
struct StepKernel {
  using Args = StepArgs<T>;
  struct Shared {
    T s[9][SY][SX];
  };
  static constexpr int kMinBlocks = 0;   // no register cap
};
template <typename T>
struct StepKernel<T, true> {
  using Args = typename BandStep<T>::Args;
  using Shared = typename BandStep<T>::Shared;
  static constexpr int kMinBlocks = BandStep<T>::kMinBlocks;
};

template <typename T, typename Sin, typename Sout, bool kForced,
          bool kEmit = true, bool kSpread = false>
__global__ void __launch_bounds__(TX * TY,
                                  StepKernel<T, kSpread>::kMinBlocks)
    step_kernel(const typename StepKernel<T, kSpread>::Args a) {
  __shared__ typename StepKernel<T, kSpread>::Shared sm;
  auto& s = sm.s;
  if constexpr (kSpread) BandStep<T>::form_forces(a, sm);
  const int x0 = blockIdx.x * TX;
  const int r0 = blockIdx.y * TY;
  const int xdim = a.xdim;
  const long long fplane = (long long)a.band * xdim;

  for (int c = threadIdx.y * TX + threadIdx.x; c < SY * SX; c += TX * TY) {
    const int ly = c / SX;
    const int lx = c - ly * SX;
    const int r = r0 + ly - 1;
    int gx = (x0 + lx - 1) % xdim;
    if (gx < 0) gx += xdim;
    T f1[9];
    if (r >= 0 && r < a.rows) {
      const Sin* src = (const Sin*)a.f_in;
      long long plane = a.in_plane;
      int rs = r - a.lo_rows;
      if (r < a.lo_rows) {
        src = (const Sin*)a.f_lo;
        plane = a.lo_plane;
        rs = r;
      } else if (r >= a.hi_start) {
        src = (const Sin*)a.f_hi;
        plane = a.hi_plane;
        rs = r - a.hi_start;
      }
      const long long js = (long long)rs * xdim + gx;
      T fi[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) fi[d] = load_f(src + d * plane + js);
      T gxv = T(0.0);
      T gyv = T(0.0);
      const int yg = a.y0 + r;
      if (kForced && yg < a.band) {  // force is band-only: never read above
        if constexpr (kSpread) {
          gxv = s[0][ly][lx];
          gyv = s[1][ly][lx];
        } else {
          const long long jf = (long long)yg * xdim + gx;
          gxv = a.force[jf];
          gyv = a.force[fplane + jf];
        }
      }
      collide_cell<T, kForced>(fi, gxv, gyv, a.k, f1);
      if (kEmit && r == a.expose_row && ly >= 1 && ly <= TY && lx >= 1
          && lx <= TX && x0 + lx - 1 < xdim) {
#pragma unroll
        for (int d = 0; d < 9; ++d) a.f1out[d * xdim + gx] = f1[d];
      }
    } else {
      const T* h = r < 0 ? a.bhalo : a.thalo;
#pragma unroll
      for (int d = 0; d < 9; ++d) f1[d] = h ? h[d * xdim + gx] : T(0.0);
    }
#pragma unroll
    for (int d = 0; d < 9; ++d) s[d][ly][lx] = f1[d];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int r = r0 + threadIdx.y;
  if (x >= xdim || r >= a.rows) return;
  const int ly = threadIdx.y + 1;
  const int lx = threadIdx.x + 1;
  // pull from (r - cy, x - cx)
  T p[9];
  p[0] = s[0][ly][lx];
  p[1] = s[1][ly][lx - 1];
  p[2] = s[2][ly - 1][lx];
  p[3] = s[3][ly][lx + 1];
  p[4] = s[4][ly + 1][lx];
  p[5] = s[5][ly - 1][lx - 1];
  p[6] = s[6][ly - 1][lx + 1];
  p[7] = s[7][ly + 1][lx + 1];
  p[8] = s[8][ly + 1][lx - 1];
  if (r == 0 && a.is_bottom) {  // halfway bounce-back
    p[2] = s[4][ly][lx];
    p[5] = s[7][ly][lx];
    p[6] = s[8][ly][lx];
  }
  if (r == a.inject_row) {  // the seam: pull (r - 1, x - cx) from inject
    const int xm = x == 0 ? xdim - 1 : x - 1;
    const int xp = x == xdim - 1 ? 0 : x + 1;
    p[2] = a.inject[2 * xdim + x];
    p[5] = a.inject[5 * xdim + xm];
    p[6] = a.inject[6 * xdim + xp];
  }
  if (r == a.top_row) {
    p[4] = s[2][ly][lx];
    if (a.top_noslip) {  // bounce-back
      p[7] = s[5][ly][lx];
      p[8] = s[6][ly][lx];
    } else {  // specular slip
      p[8] = s[5][ly][lx];
      p[7] = s[6][ly][lx];
    }
  }
  const long long j = (long long)r * xdim + x;
  if (r < a.out_rows) {
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      store_f((Sout*)a.f_out + d * a.out_plane + j, p[d]);
    }
  }
  if constexpr (kEmit) {
    if (r < a.q_rows || (a.fluxcol && x == a.flux_x)) {
      T rho, mom_x, mom_y;
      moments9(p, a.k.deviatoric, rho, mom_x, mom_y);
      if (r < a.q_rows) {
        const long long qplane = (long long)a.q_rows * xdim;
        a.q[j] = rho;
        a.q[qplane + j] = mom_x;
        a.q[2 * qplane + j] = mom_y;
      }
      if (a.fluxcol && x == a.flux_x) {
        a.fluxcol[r] = rho;
        a.fluxcol[a.rows + r] = mom_x;
      }
    }
  }
}

// emit = false: the forced instantiation without emission (B2h); the
// expose_row, q and fluxcol arguments are then ignored.  f is read as Sin
// and written as Sout.
template <typename Sin, typename Sout, typename T>
int launch_step(const StepArgs<T>& a, bool forced, cudaStream_t stream,
                bool emit = true) {
  const dim3 block(TX, TY);
  const dim3 grid((a.xdim + TX - 1) / TX, (a.rows + TY - 1) / TY);
  if (!emit) {
    step_kernel<T, Sin, Sout, true, false><<<grid, block, 0, stream>>>(a);
  } else if (forced) {
    step_kernel<T, Sin, Sout, true><<<grid, block, 0, stream>>>(a);
  } else {
    step_kernel<T, Sin, Sout, false><<<grid, block, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Per-sub-step flux sums without atomics: block s sums n values of the
// column at cols + s * stride (kRatio: summing c[plane + r] / c[r], the
// u_x = mom_x / rho of a flux column whose rho and mom_x lie `plane`
// apart) into out[s].  Each thread strides the rows in a fixed order and
// a fixed-shape tree joins the threads, so the sum is the same in every
// run.
constexpr int SUM_THREADS = 256;

template <typename T, bool kRatio>
__global__ void __launch_bounds__(SUM_THREADS)
column_sum_kernel(const T* __restrict__ cols, int n, long long plane,
                  long long stride, T* __restrict__ out) {
  __shared__ T part[SUM_THREADS];
  const T* c = cols + (long long)blockIdx.x * stride;
  T acc = T(0.0);
  for (int r = threadIdx.x; r < n; r += SUM_THREADS) {
    acc += kRatio ? c[plane + r] / c[r] : c[r];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

}  // namespace
