// B1: the one collide expression tree of the port, shared by every kernel.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_collide_tile (:642), which
// every Pallas kernel of the JAX package routes its collision through.
// The fused step (B2/B3, fused_step.cu), the K-step bulk (B4/B7,
// ghost_temporal.cu), the band super-step (B5/B6/B8, band_super.cu) and
// the slab collide (B0, collide_rows.cu) all call collide_cell below, so
// the seam halos one kernel hands another round exactly as the consumer
// would have computed them (an f1 value that
// merely rounds differently at the seam is amplified by the stiff IB
// feedback, docs/DESIGN.md:229-232).  Every source is built with
// --fmad=true (ops/_kernels.py), so all kernels contract the same way.
//
// Also here: the relaxation coefficients, the post-stream moment sums in
// the order every kernel emits them, and the step kernel's tile shape.

#pragma once

#include <cuda_runtime.h>

namespace {

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

template <typename T>
Coeffs<T> make_coeffs(double tau, double tau2, int forcing_trt,
                      int deviatoric) {
  Coeffs<T> k;
  k.omega_p = T(1.0 / tau);
  k.hp = T(0.5 * (1.0 / tau));
  k.hm = T(0.5 * (1.0 / tau2));
  k.lam_p = T(1.0 - 1.0 / (2.0 * tau));
  k.lam_odd = forcing_trt ? T(1.0 - 1.0 / (2.0 * tau2)) : k.lam_p;
  k.deviatoric = deviatoric;
  return k;
}

// Pair-form TRT + Guo collide of one cell (pallas_step.py:642-739,
// transcribed operation for operation).  kForced = false is the JAX
// kernels' force-free form (gx = gy = None): no half-force velocity shift
// and no source terms, as the temporal bulk collides its rows.
//
// Built with -DIBLB_IDENTITY_COLLIDE (ops/_kernels.VARIANTS, loaded only by
// probe_vpu.py's A/B), collide_cell passes f through unchanged, as
// scripts/probe_vpu.py:198-204 replaces _collide_tile: every kernel keeps
// its movement, IB and flux (the flux sums moments9 of its own, outside
// this function), and loses only the collide's arithmetic.
template <typename T, bool kForced = true>
__device__ __forceinline__ void collide_cell(const T (&f)[9], T gx, T gy,
                                             const Coeffs<T>& k, T (&f1)[9]) {
#ifdef IBLB_IDENTITY_COLLIDE
#pragma unroll
  for (int d = 0; d < 9; ++d) f1[d] = f[d];
#else
  const T p57 = f[5] - f[7];
  const T d68 = f[6] - f[8];
  const T fsum = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8];
  const T rho = k.deviatoric ? T(1.0) + fsum : fsum;
  const T drho = fsum;
  const T mom_x = (f[1] - f[3]) + p57 - d68;
  const T mom_y = (f[2] - f[4]) + p57 + d68;
  const T inv_rho = T(1.0) / rho;
  T ux, uy, ug = T(0.0);
  if constexpr (kForced) {
    // previous step's spread-corrected velocity (ImmersedBoundary.cu:249-255)
    ux = (mom_x + T(0.5) * gx) * inv_rho;
    uy = (mom_y + T(0.5) * gy) * inv_rho;
    ug = T(1.0 / CS2) * (ux * gx + uy * gy);
  } else {
    ux = mom_x * inv_rho;
    uy = mom_y * inv_rho;
  }

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
    if constexpr (kForced) {
      const T s_even = wa[p] * (cu[p] * cg[p] * T(1.0 / CS4) - ug);
      const T s_odd = wa_cs2[p] * cg[p];
      f1[a] = (f[a] - (even + odd)) + (k.lam_p * s_even + k.lam_odd * s_odd);
      f1[b] = (f[b] - (even - odd)) + (k.lam_p * s_even - k.lam_odd * s_odd);
    } else {
      f1[a] = f[a] - (even + odd);
      f1[b] = f[b] - (even - odd);
    }
  }
#endif
}

// Moments of nine post-stream values, in the order every kernel (and the
// JAX kernels' emission, pallas_step.py:411-422) sums them.
template <typename T>
__device__ __forceinline__ void moments9(const T (&p)[9], int deviatoric,
                                         T& rho, T& mom_x, T& mom_y) {
  T fsum = p[0];
#pragma unroll
  for (int d = 1; d < 9; ++d) fsum = fsum + p[d];
  rho = deviatoric ? T(1.0) + fsum : fsum;
  mom_x = p[1] - p[3] + p[5] - p[6] - p[7] + p[8];
  mom_y = p[2] - p[4] + p[5] + p[6] - p[7] - p[8];
}

}  // namespace
