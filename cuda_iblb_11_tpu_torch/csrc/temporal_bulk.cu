// B4: K steps of the force-free bulk rows [band, Y) behind one call.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_temporal_kernel (:790) as
// built by make_temporal_bulk_substep (:966, call :1045).  The IB force is
// zero above the force band, so the bulk evolves K steps with no input but
// the band's seam rows: sub-step s collides the bulk (force-free collide_cell
// of collide.cuh), pulls its row 0's up-going populations from bhalos[s]
// (the f1 of global row band-1 at sub-step s, which the band leg exposes),
// applies the top wall, and streams.  flux[s] is the sum over the bulk rows
// of mom_x / rho at x = flux_x after sub-step s's stream, with no force
// correction (the force is zero here), as :910-963 sums it.
//
// Design, a first version: K launches of the row kernel of step.cuh (one
// per sub-step, ping-ponging two scratch buffers; the first reads f_in and
// the last writes f_out, either of which may be a row range of a larger
// state), each writing the flux column of its rows, then one launch of
// column_sum_kernel that reduces the K columns in a fixed order (no
// atomics).  The TPU kernel is a row wavefront holding 3K full-width ring
// rows in VMEM; 3K rows of 2048 columns do not fit 227 KB of shared memory,
// and the x-strip or 2-D trapezoid forms that would fit are later work.
//
// What bounds it on an H100: the function reads f once and writes it once
// (2 x 9 x rows x X values: 284 MB at 2048^2 in f32, 0.085 ms at
// 3.35 TB/s) and does 101 operations per cell and sub-step in the
// force-free collide (6.4 GFLOP at K = 16, 0.095 ms at 67 TFLOP/s):
// arithmetic bounds it, barely, at K = 16.  This version instead moves the
// state through device memory once per sub-step (K x 284 MB), so it runs
// near K times the byte bound of one pass: 1.78 ms at 2048^2, K = 16, f32,
// against the bound's 0.095 ms (chip_smoke.py; NVIDIA H100 80GB HBM3 at
// 700 W).  A single launch over x-strips with K ghost columns and a ring
// of rows per sub-step in shared memory is the design that would approach
// the bound.

#include "step.cuh"

namespace {

template <typename T>
int temporal_bulk(const void* f_in, long long in_plane, void* f_out,
                  long long out_plane, void* tmp0, void* tmp1,
                  const void* bhalos, void* colbuf, void* flux, int rows,
                  int xdim, int K, int flux_x, double tau, double tau2,
                  int forcing_trt, int deviatoric, int top_noslip,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  StepArgs<T> a{};
  a.rows = rows;
  a.xdim = xdim;
  a.is_bottom = 0;
  a.is_top = 1;
  a.top_noslip = top_noslip;
  a.expose_row = -1;
  a.flux_x = flux_x;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);
  T* tmp[2] = {(T*)tmp0, (T*)tmp1};
  const long long tplane = (long long)rows * xdim;
  for (int s = 0; s < K; ++s) {
    a.f_in = s == 0 ? (const T*)f_in : tmp[(s - 1) % 2];
    a.in_plane = s == 0 ? in_plane : tplane;
    a.f_out = s == K - 1 ? (T*)f_out : tmp[s % 2];
    a.out_plane = s == K - 1 ? out_plane : tplane;
    a.out_rows = rows;
    a.bhalo = (const T*)bhalos + (long long)s * 9 * xdim;
    a.fluxcol = (T*)colbuf + (long long)s * 2 * rows;
    const int err = launch_step<T>(a, false, st);
    if (err) return err;
  }
  column_sum_kernel<T, true><<<K, SUM_THREADS, 0, st>>>(
      (const T*)colbuf, rows, (T*)flux);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's.  f_in and f_out have plane
// strides in_plane and out_plane (elements) and must not overlap; tmp0 and
// tmp1 are [9, rows, X] scratch (tmp1 unused for K <= 2, both for K = 1);
// bhalos [K, 9, X]; colbuf [K, 2, rows] scratch; flux [K].
#define IBLB_BULK(NAME, T)                                                   \
  extern "C" int NAME(const void* f_in, long long in_plane, void* f_out,     \
                      long long out_plane, void* tmp0, void* tmp1,           \
                      const void* bhalos, void* colbuf, void* flux,          \
                      int rows, int xdim, int K, int flux_x, double tau,     \
                      double tau2, int forcing_trt, int deviatoric,          \
                      int top_noslip, void* stream) {                        \
    return temporal_bulk<T>(f_in, in_plane, f_out, out_plane, tmp0, tmp1,    \
                            bhalos, colbuf, flux, rows, xdim, K, flux_x,     \
                            tau, tau2, forcing_trt, deviatoric, top_noslip,  \
                            stream);                                         \
  }
IBLB_BULK(iblb_temporal_bulk_f32, float)
IBLB_BULK(iblb_temporal_bulk_f64, double)
