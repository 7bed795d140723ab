// B0: collide only, on a slab of cells.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:make_collide_rows_kernel
// (:742, call :775): f1 = collide_cell(f, force) (collide.cuh, B1) for each
// cell of a [9, n, m] slab, with no streaming.  The sharded path computes
// the f1 it hands its neighbours this way: the four edge lines of a shard
// each step (parallel/sharded.py:_pallas_fluid) and the two seam columns
// of the band block each band sub-step (_band_substep_x).  Those values
// are pulled across a seam in place of what the neighbour's own step
// kernel would have computed internally, so they must round exactly as
// the step kernels round (the JAX package's reason for this kernel,
// :749-756: the IB feedback amplifies a seam f1 that merely rounds
// differently).  Sharing collide_cell and the build flags guarantees it.
//
// Design: one thread per cell.  f and the force are read through element
// strides (plane, row, column), so an edge row [9, 1, xl] or an edge
// column [9, yl, 1] of a shard's state is read in place; f1 is written
// contiguous [9, n, m].  The slab is small (a row or a column), so the
// launch, not the bytes, is its cost.
//
// What bounds it: memory.  It reads 11 values per cell (9 f, 2 force) and
// writes 9, against 163 operations of the forced collide.

#include "collide.cuh"

namespace {

constexpr int RB = 256;

template <typename T>
__global__ void __launch_bounds__(RB)
collide_rows_kernel(const T* __restrict__ f, long long fp, long long fr,
                    long long fc, const T* __restrict__ force, long long gp,
                    long long gr, long long gc, T* __restrict__ f1, int n,
                    int m, Coeffs<T> k) {
  const long long cell = (long long)blockIdx.x * RB + threadIdx.x;
  const long long cells = (long long)n * m;
  if (cell >= cells) return;
  const int r = (int)(cell / m);
  const int c = (int)(cell - (long long)r * m);
  const long long jf = r * fr + c * fc;
  const long long jg = r * gr + c * gc;
  T fi[9];
#pragma unroll
  for (int d = 0; d < 9; ++d) fi[d] = f[d * fp + jf];
  T out[9];
  collide_cell<T, true>(fi, force[jg], force[gp + jg], k, out);
#pragma unroll
  for (int d = 0; d < 9; ++d) f1[d * cells + cell] = out[d];
}

template <typename T>
int collide_rows(const void* f, long long fp, long long fr, long long fc,
                 const void* force, long long gp, long long gr, long long gc,
                 void* f1, int n, int m, double tau, double tau2,
                 int forcing_trt, int deviatoric, void* stream) {
  const long long cells = (long long)n * m;
  const int blocks = (int)((cells + RB - 1) / RB);
  collide_rows_kernel<T><<<blocks, RB, 0, (cudaStream_t)stream>>>(
      (const T*)f, fp, fr, fc, (const T*)force, gp, gr, gc, (T*)f1, n, m,
      make_coeffs<T>(tau, tau2, forcing_trt, deviatoric));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's.  f [9, n, m] and force
// [2, n, m] are read with element strides (plane, row, column); f1 is
// written contiguous [9, n, m] and must not overlap them.
#define IBLB_COLLIDE_ROWS(NAME, T)                                           \
  extern "C" int NAME(const void* f, long long fp, long long fr,             \
                      long long fc, const void* force, long long gp,         \
                      long long gr, long long gc, void* f1, int n, int m,    \
                      double tau, double tau2, int forcing_trt,              \
                      int deviatoric, void* stream) {                        \
    return collide_rows<T>(f, fp, fr, fc, force, gp, gr, gc, f1, n, m, tau,  \
                           tau2, forcing_trt, deviatoric, stream);           \
  }
IBLB_COLLIDE_ROWS(iblb_collide_rows_f32, float)
IBLB_COLLIDE_ROWS(iblb_collide_rows_f64, double)
