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
// Design, a first version: one launch per stage per sub-step, with the
// band L2-resident between them (at 2048^2 the extended band is 10.6 MB
// in f32, inside the 50 MB L2): stage 1-3 is the row kernel of step.cuh,
// stage 4 one thread per point (interp_kernel), stage 5-6 one thread per
// band cell (spread_kernel), and after the K sub-steps one
// column_sum_kernel launch (3K + 1 launches).  The TPU contracts each
// window densely on the MXU (a [3 band, W] x [W, 128] interpolation and a
// [2 band, 128] x [128, W] spread per cilium, with a bf16 split for f32
// precision, :1226-1251).  The delta has a 3-cell support (ops/ib.py:50-63),
// so here each point gathers its 5 x 5 stencil in full-precision FMA, and
// each cell gathers the points of the windows that cover it, rejecting the
// points whose stencil misses it: the same function, about 1000x less
// arithmetic.  Both reductions are gathers in a fixed order, with no
// atomics, so a run repeats bit for bit.
//
// What bounds it on an H100: arithmetic, at K = 16.  The call must read
// f_ext, the force and the points and write f_band, bhalos and the force
// (26 MB at 2048^2 in f32, 0.008 ms at 3.35 TB/s); it must do 163
// operations per band cell and sub-step in the forced collide, 101 in the
// force-free collide of the K - s ghost rows that still reach the band at
// sub-step s, plus the moments and each point's 3 x 3 delta support
// (0.80 GFLOP at K = 16, 0.012 ms at 67 TFLOP/s).  This version takes 1.36 ms (chip_smoke.py; NVIDIA H100 80GB
// HBM3 at 700 W): per sub-step the spread gather (each cell tests the 128
// points of every window that covers it) takes about 0.061 ms, the
// interpolation 0.012 ms and the step 0.010 ms (profile_step.py), each
// launch a dependent pass over the L2-resident band.
//
// B6 at 8192^2 (f32, K = 16): the JAX rule with the card's L2 as the
// budget takes 8 tiles of 1,024 interior + 2 x 512 ghost columns, so each
// tile's working set (about 50 MB: f_ext and two scratch copies of
// 144 x 2,048 cells, f_band, q, the force) stays L2-resident across its
// 3K + 1 launches, where the whole 8192-wide band (about 42 MB of f_ext
// alone) streams each launch through HBM.  The cost of the design is
// 2 gx / tile = 2x redundant band columns; its bound is B5's (the same
// function).

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
// (the delta vanishes beyond 1.5 cells and |frac| <= 0.5).
template <typename T>
__global__ void interp_kernel(const IbArgs<T> b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int npts = b.c_num * NPT;
  if (i >= npts) return;
  const int m = i / NPT;
  const int ay = b.ay[i];
  const int ax = b.axl[i];
  const T fy = b.fy[i];
  const T fx = b.fx[i];
  const int wstart = b.win_lo0 + m * b.cw;
  const long long plane = (long long)b.band * b.xdim;
  T iq[3] = {T(0.0), T(0.0), T(0.0)};
  for (int yy = ay - 2; yy <= ay + 2; ++yy) {
    if (yy < 0 || yy >= b.band) continue;
    const T dy = delta_1d(T(yy - ay) - fy);
    T t[3] = {T(0.0), T(0.0), T(0.0)};
    for (int ww = ax - 2; ww <= ax + 2; ++ww) {
      if (ww < 0 || ww >= b.wwin) continue;
      const T dx = delta_1d(T(ww - ax) - fx);
      const long long j = (long long)yy * b.xdim + wrap(wstart + ww, b.xdim);
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c] += b.q[c * plane + j] * dx;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) iq[c] += dy * t[c];
  }
  const T em = b.eps[i];
  b.amp[i] = (T(2.0) * (b.us[i] * iq[0] - iq[1])) * em;
  b.amp[npts + i] = (T(2.0) * (b.us[npts + i] * iq[0] - iq[2])) * em;
}

// Stages 5-6: each band cell gathers the forces of the points whose delta
// support covers it, cilium by cilium in order (every window that covers
// the cell, under the periodic wrap; in block order on a tile), then the
// flux column.
template <typename T>
__global__ void __launch_bounds__(TX * TY) spread_kernel(const IbArgs<T> b) {
  __shared__ int s_ax[NPT];
  __shared__ int s_ay[NPT];
  __shared__ T s_fx[NPT];
  __shared__ T s_fy[NPT];
  __shared__ T s_a0[NPT];
  __shared__ T s_a1[NPT];
  const int x0 = blockIdx.x * TX;
  const int tw = min(TX, b.xdim - x0);
  const int x = x0 + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const bool valid = x < b.xdim && y < b.band;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int npts = b.c_num * NPT;
  T acc0 = T(0.0);
  T acc1 = T(0.0);
  for (int m = 0; m < b.c_num; ++m) {
    const int wstart = wrap(b.win_lo0 + m * b.cw, b.xdim);
    // window [wstart, wstart + W) and tile [x0, x0 + tw), on the circle
    if (wrap(x0 - wstart, b.xdim) >= b.wwin &&
        wrap(wstart - x0, b.xdim) >= tw) {
      continue;  // block-uniform
    }
    __syncthreads();
    if (tid < NPT) {
      const int i = m * NPT + tid;
      s_ax[tid] = b.axl[i];
      s_ay[tid] = b.ay[i];
      s_fx[tid] = b.fx[i];
      s_fy[tid] = b.fy[i];
      s_a0[tid] = b.amp[i];
      s_a1[tid] = b.amp[npts + i];
    }
    __syncthreads();
    if (!valid) continue;
    const int w = wrap(x - wstart, b.xdim);
    if (w >= b.wwin) continue;
    for (int k = 0; k < NPT; ++k) {
      if ((unsigned)(y - s_ay[k] + 2) > 4u ||
          (unsigned)(w - s_ax[k] + 2) > 4u) {
        continue;
      }
      const T dy = delta_1d(T(y - s_ay[k]) - s_fy[k]);
      const T dx = delta_1d(T(w - s_ax[k]) - s_fx[k]);
      acc0 += (dy * s_a0[k]) * dx;
      acc1 += (dy * s_a1[k]) * dx;
    }
  }
  if (!valid) return;
  const long long j = (long long)y * b.xdim + x;
  b.force[j] = acc0;
  b.force[(long long)b.band * b.xdim + j] = acc1;
  if (x == b.flux_x) {  // never for flux_x = -1
    const long long plane = (long long)b.band * b.xdim;
    b.fluxcol[y] = (b.q[plane + j] + T(0.5) * acc0) / b.q[j];
  }
}

template <typename T>
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

  T* buf[2] = {(T*)buf0, (T*)buf1};
  const long long bplane = (long long)rows * xdim;
  const long long pts = (long long)c_num * NPT;
  const dim3 sgrid((xdim + TX - 1) / TX, (band + TY - 1) / TY);
  const int iblocks = (int)((pts + NPT - 1) / NPT);
  for (int s = 0; s < K; ++s) {
    a.f_in = s == 0 ? (const T*)f_ext : buf[(s - 1) % 2];
    a.in_plane = s == 0 ? ext_plane : bplane;
    const bool last = s == K - 1;
    a.f_out = last ? (T*)f_band : buf[s % 2];
    a.out_plane = last ? band_plane : bplane;
    a.out_rows = last ? band : rows;
    a.force = s == 0 ? (const T*)force_in : (const T*)force_out;
    a.f1out = (T*)bhalos + (long long)s * 9 * xdim;
    int err = launch_step<T>(a, true, st);
    if (err) return err;

    b.us = (const T*)us + s * 2 * pts;
    b.eps = (const T*)eps + s * pts;
    b.axl = (const int*)axl + s * pts;
    b.fx = (const T*)fx + s * pts;
    b.ay = (const int*)ay + s * pts;
    b.fy = (const T*)fy + s * pts;
    b.fluxcol = flux_x >= 0 ? (T*)colbuf + (long long)s * band : nullptr;
    interp_kernel<T><<<iblocks, NPT, 0, st>>>(b);
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

// C interface (ctypes), as fused_step.cu's.  X is the block's width (the
// domain for B5, tile + 2 gx for B6); f_ext [9, rows, X] and f_band
// [9, band, X] have plane strides ext_plane and band_plane (elements) and
// must not overlap; force_in and force_out [2, band, X] must not overlap;
// point arrays [K, (2,) c_num, 128] (axl, ay int32; c_num the block's
// point blocks); bhalos [K, 9, X]; scratch buf0, buf1 [9, rows, X] (buf1
// unused for K <= 2, both for K = 1), q [3, band, X], amp
// [2, c_num, 128], colbuf [K, band]; flux [K].  wwin is the window width
// (c_space + 2 halo, or c_space wider in B8's phase-general layout);
// win_lo0 = -halo is B5's layout; flux_x = -1 leaves colbuf and flux
// unused (may be NULL).
#define IBLB_BAND_SUPER(NAME, T)                                             \
  extern "C" int NAME(                                                       \
      const void* f_ext, long long ext_plane, void* f_band,                  \
      long long band_plane, const void* force_in, void* force_out,           \
      const void* us, const void* eps, const void* axl, const void* fx,      \
      const void* ay, const void* fy, void* bhalos, void* buf0, void* buf1,  \
      void* q, void* amp, void* colbuf, void* flux, int rows, int band,      \
      int xdim, int K, int c_num, int cw, int wwin, int win_lo0,             \
      int flux_x, double tau, double tau2, int forcing_trt, int deviatoric,  \
      void* stream) {                                                        \
    return band_super<T>(f_ext, ext_plane, f_band, band_plane, force_in,     \
                         force_out, us, eps, axl, fx, ay, fy, bhalos, buf0,  \
                         buf1, q, amp, colbuf, flux, rows, band, xdim, K,    \
                         c_num, cw, wwin, win_lo0, flux_x, tau, tau2,        \
                         forcing_trt, deviatoric, stream);                   \
  }
IBLB_BAND_SUPER(iblb_band_super_f32, float)
IBLB_BAND_SUPER(iblb_band_super_f64, double)
