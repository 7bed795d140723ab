// Fused D2Q9 TRT + Guo collide and pull-stream: one pass over f per step.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_pipelined_kernel, as built
// by make_fused_substep(pipeline=True, emit_moments=True), and, as the
// __device__ function collide_cell below, _collide_tile: the one collide
// expression tree that every kernel of the JAX package shares.  Every later
// kernel of this port (the temporal and band-super kernels) must call
// collide_cell too: seam halos stay bit-consistent across kernels only if
// they all round the same way (docs/DESIGN.md:229-232).
//
// What it computes, per cell (y, x) of f [9, Y, X]:
//   1. collide (B1): pair-form TRT + Guo with the previous step's IB force,
//      which is stored only for rows y < band and is zero above;
//   2. pull-stream: out[d](y, x) = f1[d](y - cy, x - cx), x periodic;
//   3. wall fix-ups from the same cell's own f1, applied after the pull
//      and before the moments: bottom (y = 0) halfway bounce-back
//      2<-4 5<-7 6<-8; top (y = Y-1) slip 4<-2 8<-5 7<-6 or no-slip
//      4<-2 7<-5 8<-6;
//   4. emission from the post-stream, post-fix-up values: q = (rho, mom_x,
//      mom_y) for rows y < band, and fluxcol = (rho, mom_x) at x = flux_x
//      for every row.
//
// Design: one block per 32 x 8 tile.  The block collides its tile plus a
// one-cell halo (34 x 10 cells) into shared memory (9 x 10 x 34 values,
// 12 KB in f32), synchronises, and each thread then pulls its nine
// post-stream values from shared memory.  Halo rows outside the domain are
// never pulled into a value that survives (the wall fix-ups overwrite
// them), so they are zero-filled instead of collided.  Ragged tiles are
// masked; any Y >= 3 and any X work.  f is read from one buffer and
// written to another: CUDA blocks run in no order, so the TPU kernel's
// in-place update (safe there only by its lag-1 grid order) is not used.
//
// What bounds it on an H100: memory.  Per f32 cell it reads 9 f values
// (36 B) plus the force inside the band (8 B) and writes 9 f values (36 B)
// plus q inside the band (12 B): about 80 B/cell, so a 2048 x 2048 step
// needs at least 0.1 ms at 3.35 TB/s.  The 1.33x halo re-read of f
// (34*10 / (32*8)) mostly hits L2.  About 200 flop/cell is far below the
// card's f32 (and f64) rate.
//
// Rounding: built with nvcc's default --fmad=true (ops/_kernels.py passes
// it explicitly), so multiply-adds contract and f32 results differ from
// the plain torch version (eager ops do not contract) at round-off.  The
// constants are spelled as the JAX kernel spells them: through CS2 and CS4
// of CS_KERNEL = 0.57735, each formed in double and rounded once to T.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SX = TX + 2;
constexpr int SY = TY + 2;

constexpr double CS = 0.57735;  // CS_KERNEL (core/lattice.py)
constexpr double CS2 = CS * CS;
constexpr double CS4 = CS2 * CS2;
constexpr double W0 = 4.0 / 9.0;
constexpr double W_AX = 1.0 / 9.0;
constexpr double W_DI = 1.0 / 36.0;

// Relaxation coefficients: formed on the host in double, as the JAX
// kernel forms them from Python floats, and rounded once to T.
template <typename T>
struct Coeffs {
  T omega_p;   // 1 / tau
  T hp;        // 0.5 / tau
  T hm;        // 0.5 / tau2
  T lam_p;     // 1 - 1 / (2 tau)
  T lam_odd;   // lam_p ("reference" forcing) or 1 - 1 / (2 tau2)
  int deviatoric;
};

// B1: pair-form TRT + Guo collide of one cell (pallas_step.py:642-739,
// transcribed operation for operation).
template <typename T>
__device__ __forceinline__ void collide_cell(const T (&f)[9], T gx, T gy,
                                             const Coeffs<T>& k, T (&f1)[9]) {
  const T p57 = f[5] - f[7];
  const T d68 = f[6] - f[8];
  const T fsum = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8];
  const T rho = k.deviatoric ? T(1.0) + fsum : fsum;
  const T drho = fsum;
  const T mom_x = (f[1] - f[3]) + p57 - d68;
  const T mom_y = (f[2] - f[4]) + p57 + d68;
  const T inv_rho = T(1.0) / rho;
  // previous step's spread-corrected velocity (ImmersedBoundary.cu:249-255)
  const T ux = (mom_x + T(0.5) * gx) * inv_rho;
  const T uy = (mom_y + T(0.5) * gy) * inv_rho;
  const T ug = T(1.0 / CS2) * (ux * gx + uy * gy);

  // cu per pair (first member): dirs 1, 2, 5, 6 = (1,0), (0,1), (1,1), (-1,1)
  const T d1 = ux + uy;
  const T d2 = uy - ux;
  const T cu[4] = {ux, uy, d1, d2};
  const T qq[4] = {ux * ux, uy * uy, d1 * d1, d2 * d2};
  const T u2h = T(0.5 / CS2) * (qq[0] + qq[1]);

  // per-weight-class products (axis w = 1/9, diagonal w = 1/36); f0p2 and
  // f0m2 are doubled equilibria, the 0.5 of the projections sits in hp/hm
  const T wd2[2] = {T(2.0 * W_AX) * drho, T(2.0 * W_DI) * drho};
  const T wr2[2] = {T(2.0 * W_AX) * rho, T(2.0 * W_DI) * rho};
  const T wrc[2] = {T(1.0 / CS2) * wr2[0], T(1.0 / CS2) * wr2[1]};

  // rest population: BGK with omega+, no forcing (LatticeBoltzmann.cu:86)
  const T f0_0 = k.deviatoric ? T(W0) * drho - rho * (T(W0) * u2h)
                              : rho * (T(W0) * (T(1.0) - u2h));
  f1[0] = f[0] - k.omega_p * (f[0] - f0_0);

  // pairs (a, b) = (1,3), (2,4), (5,7), (6,8); c.g of the first member
  const int pa[4] = {1, 2, 5, 6};
  const int pb[4] = {3, 4, 7, 8};
  const T cg[4] = {gx, gy, gx + gy, -gx + gy};
  const T wa[4] = {T(W_AX), T(W_AX), T(W_DI), T(W_DI)};
  const T wa_cs2[4] = {T(W_AX / CS2), T(W_AX / CS2), T(W_DI / CS2),
                       T(W_DI / CS2)};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int c = p < 2 ? 0 : 1;
    const int a = pa[p];
    const int b = pb[p];
    const T tp = T(0.5 / CS4) * qq[p] - u2h;
    const T f0p2 = k.deviatoric ? wd2[c] + wr2[c] * tp : wr2[c] + wr2[c] * tp;
    const T f0m2 = wrc[c] * cu[p];
    const T even = k.hp * ((f[a] + f[b]) - f0p2);
    const T odd = k.hm * ((f[a] - f[b]) - f0m2);
    const T s_even = wa[p] * (cu[p] * cg[p] * T(1.0 / CS4) - ug);
    const T s_odd = wa_cs2[p] * cg[p];
    f1[a] = (f[a] - (even + odd)) + (k.lam_p * s_even + k.lam_odd * s_odd);
    f1[b] = (f[b] - (even - odd)) + (k.lam_p * s_even - k.lam_odd * s_odd);
  }
}

// B2: collide (tile + halo into shared memory), pull-stream, wall
// fix-ups, emission.  q is [3, band, X]; fluxcol is [2, Y].
template <typename T>
__global__ void __launch_bounds__(TX * TY)
fused_step_kernel(const T* __restrict__ f_in, const T* __restrict__ force,
                  T* __restrict__ f_out, T* __restrict__ q,
                  T* __restrict__ fluxcol, int ydim, int xdim, int band,
                  int flux_x, Coeffs<T> k, int top_noslip) {
  __shared__ T s[9][SY][SX];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = (long long)ydim * xdim;
  const long long fplane = (long long)band * xdim;

  for (int c = threadIdx.y * TX + threadIdx.x; c < SY * SX; c += TX * TY) {
    const int ly = c / SX;
    const int lx = c - ly * SX;
    const int gy = y0 + ly - 1;
    int gx = (x0 + lx - 1) % xdim;
    if (gx < 0) gx += xdim;
    T f1[9];
    if (gy >= 0 && gy < ydim) {
      const long long j = (long long)gy * xdim + gx;
      T fi[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) fi[d] = f_in[d * plane + j];
      T gxv = T(0.0);
      T gyv = T(0.0);
      if (gy < band) {  // force is band-only: never indexed above it
        gxv = force[j];
        gyv = force[fplane + j];
      }
      collide_cell(fi, gxv, gyv, k, f1);
    } else {
#pragma unroll
      for (int d = 0; d < 9; ++d) f1[d] = T(0.0);
    }
#pragma unroll
    for (int d = 0; d < 9; ++d) s[d][ly][lx] = f1[d];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= xdim || y >= ydim) return;
  const int ly = threadIdx.y + 1;
  const int lx = threadIdx.x + 1;
  // pull from (y - cy, x - cx)
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
  if (y == 0) {  // bottom halfway bounce-back
    p[2] = s[4][ly][lx];
    p[5] = s[7][ly][lx];
    p[6] = s[8][ly][lx];
  }
  if (y == ydim - 1) {
    p[4] = s[2][ly][lx];
    if (top_noslip) {  // bounce-back
      p[7] = s[5][ly][lx];
      p[8] = s[6][ly][lx];
    } else {  // specular slip
      p[8] = s[5][ly][lx];
      p[7] = s[6][ly][lx];
    }
  }
  const long long j = (long long)y * xdim + x;
#pragma unroll
  for (int d = 0; d < 9; ++d) f_out[d * plane + j] = p[d];

  T fsum = p[0];
#pragma unroll
  for (int d = 1; d < 9; ++d) fsum = fsum + p[d];
  const T rho = k.deviatoric ? T(1.0) + fsum : fsum;
  const T mom_x = p[1] - p[3] + p[5] - p[6] - p[7] + p[8];
  if (y < band) {
    const T mom_y = p[2] - p[4] + p[5] + p[6] - p[7] - p[8];
    q[j] = rho;
    q[fplane + j] = mom_x;
    q[2 * fplane + j] = mom_y;
  }
  if (x == flux_x) {
    fluxcol[y] = rho;
    fluxcol[ydim + y] = mom_x;
  }
}

template <typename T>
int launch(const void* f_in, const void* force, void* f_out, void* q,
           void* fluxcol, int ydim, int xdim, int band, int flux_x,
           double tau, double tau2, int forcing_trt, int deviatoric,
           int top_noslip, void* stream) {
  Coeffs<T> k;
  k.omega_p = T(1.0 / tau);
  k.hp = T(0.5 * (1.0 / tau));
  k.hm = T(0.5 * (1.0 / tau2));
  k.lam_p = T(1.0 - 1.0 / (2.0 * tau));
  k.lam_odd = forcing_trt ? T(1.0 - 1.0 / (2.0 * tau2)) : k.lam_p;
  k.deviatoric = deviatoric;
  const dim3 block(TX, TY);
  const dim3 grid((xdim + TX - 1) / TX, (ydim + TY - 1) / TY);
  fused_step_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)f_in, (const T*)force, (T*)f_out, (T*)q, (T*)fluxcol, ydim,
      xdim, band, flux_x, k, top_noslip);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes): every pointer and the stream are void*, the return
// value is the cudaError_t of the launch (0 = success).  The launch runs on
// the calling thread's current device, which the caller sets to the device
// of the tensors and restores afterwards.
extern "C" int iblb_fused_step_f32(const void* f_in, const void* force,
                                   void* f_out, void* q, void* fluxcol,
                                   int ydim, int xdim, int band, int flux_x,
                                   double tau, double tau2, int forcing_trt,
                                   int deviatoric, int top_noslip,
                                   void* stream) {
  return launch<float>(f_in, force, f_out, q, fluxcol, ydim, xdim,
                       band, flux_x, tau, tau2, forcing_trt, deviatoric,
                       top_noslip, stream);
}

extern "C" int iblb_fused_step_f64(const void* f_in, const void* force,
                                   void* f_out, void* q, void* fluxcol,
                                   int ydim, int xdim, int band, int flux_x,
                                   double tau, double tau2, int forcing_trt,
                                   int deviatoric, int top_noslip,
                                   void* stream) {
  return launch<double>(f_in, force, f_out, q, fluxcol, ydim, xdim,
                        band, flux_x, tau, tau2, forcing_trt, deviatoric,
                        top_noslip, stream);
}

extern "C" const char* iblb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
