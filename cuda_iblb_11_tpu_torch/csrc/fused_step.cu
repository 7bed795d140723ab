// B2 and B3: one fused D2Q9 TRT + Guo collide and pull-stream pass.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:_pipelined_kernel (:181) as
// built by
//   B2  make_fused_substep(pipeline=True, emit_moments=True) (:444, call
//       :542): the whole domain, bottom and top walls, q over the force
//       band and the flux column over every row;
//   B3  make_sharded_fused_substep (:2217, call :2337): a row block with
//       flags [y0, is_bottom, is_top], neighbour f1 halo rows pulled in
//       where a wall flag is off, the f1 of one row exposed (the temporal
//       bulk's seam halo), q and the flux column.
// Both are the one kernel of step.cuh (B2 is B3 with flags [0, 1, 1] and
// no halos), whose source header says what it computes, what bounds it on
// an H100 (memory: about 80 B/cell, so a 2048 x 2048 step needs at least
// 0.09 ms at 3.35 TB/s) and what its design does about that.  The collide
// is collide_cell of collide.cuh (B1), shared with every other kernel.
//
// Rounding: built with nvcc's default --fmad=true (ops/_kernels.py passes
// it explicitly), so multiply-adds contract and f32 results differ from
// the plain torch version (eager ops do not contract) at round-off.  The
// constants are spelled as the JAX kernel spells them: through CS2 and CS4
// of CS_KERNEL = 0.57735, each formed in double and rounded once to T.

#include "step.cuh"

namespace {

template <typename T>
int fused_step(const void* f_in, const void* force, void* f_out, void* q,
               void* fluxcol, int ydim, int xdim, int band, int flux_x,
               double tau, double tau2, int forcing_trt, int deviatoric,
               int top_noslip, void* stream) {
  StepArgs<T> a{};
  a.f_in = (const T*)f_in;
  a.in_plane = (long long)ydim * xdim;
  a.f_out = (T*)f_out;
  a.out_plane = a.in_plane;
  a.out_rows = ydim;
  a.rows = ydim;
  a.xdim = xdim;
  a.force = (const T*)force;
  a.band = band;
  a.y0 = 0;
  a.is_bottom = 1;
  a.is_top = 1;
  a.top_noslip = top_noslip;
  a.expose_row = -1;
  a.q_rows = band;
  a.q = (T*)q;
  a.flux_x = flux_x;
  a.fluxcol = (T*)fluxcol;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);
  return launch_step<T>(a, true, (cudaStream_t)stream);
}

template <typename T>
int sharded_step(const void* f_in, long long in_plane, void* f_out,
                 long long out_plane, const void* force, const void* bhalo,
                 const void* thalo, void* f1out, void* q, void* fluxcol,
                 int rows, int xdim, int band, int y0, int is_bottom,
                 int is_top, int expose_row, int q_rows, int flux_x,
                 double tau, double tau2, int forcing_trt, int deviatoric,
                 int top_noslip, void* stream) {
  StepArgs<T> a{};
  a.f_in = (const T*)f_in;
  a.in_plane = in_plane;
  a.f_out = (T*)f_out;
  a.out_plane = out_plane;
  a.out_rows = rows;
  a.rows = rows;
  a.xdim = xdim;
  a.force = (const T*)force;
  a.band = band;
  a.y0 = y0;
  a.is_bottom = is_bottom;
  a.is_top = is_top;
  a.top_noslip = top_noslip;
  a.bhalo = (const T*)bhalo;
  a.thalo = (const T*)thalo;
  a.expose_row = expose_row;
  a.f1out = (T*)f1out;
  a.q_rows = q_rows;
  a.q = (T*)q;
  a.flux_x = flux_x;
  a.fluxcol = (T*)fluxcol;
  a.k = make_coeffs<T>(tau, tau2, forcing_trt, deviatoric);
  return launch_step<T>(a, force != nullptr, (cudaStream_t)stream);
}

}  // namespace

// C interface (ctypes): every pointer and the stream are void*, the return
// value is the cudaError_t of the launch (0 = success).  The launch runs on
// the calling thread's current device, which the caller sets to the device
// of the tensors and restores afterwards.
#define IBLB_FUSED(NAME, T)                                                  \
  extern "C" int NAME(const void* f_in, const void* force, void* f_out,      \
                      void* q, void* fluxcol, int ydim, int xdim, int band,  \
                      int flux_x, double tau, double tau2, int forcing_trt,  \
                      int deviatoric, int top_noslip, void* stream) {        \
    return fused_step<T>(f_in, force, f_out, q, fluxcol, ydim, xdim, band,   \
                         flux_x, tau, tau2, forcing_trt, deviatoric,         \
                         top_noslip, stream);                                \
  }
IBLB_FUSED(iblb_fused_step_f32, float)
IBLB_FUSED(iblb_fused_step_f64, double)

// B3.  Pointers that may be null: force (a force-free block), bhalo and
// thalo (zero rows), f1out (no exposed row, expose_row = -1), q (q_rows =
// 0), fluxcol.
#define IBLB_SHARDED(NAME, T)                                                \
  extern "C" int NAME(const void* f_in, long long in_plane, void* f_out,     \
                      long long out_plane, const void* force,                \
                      const void* bhalo, const void* thalo, void* f1out,     \
                      void* q, void* fluxcol, int rows, int xdim, int band,  \
                      int y0, int is_bottom, int is_top, int expose_row,     \
                      int q_rows, int flux_x, double tau, double tau2,       \
                      int forcing_trt, int deviatoric, int top_noslip,       \
                      void* stream) {                                        \
    return sharded_step<T>(f_in, in_plane, f_out, out_plane, force, bhalo,   \
                           thalo, f1out, q, fluxcol, rows, xdim, band, y0,   \
                           is_bottom, is_top, expose_row, q_rows, flux_x,    \
                           tau, tau2, forcing_trt, deviatoric, top_noslip,   \
                           stream);                                          \
  }
IBLB_SHARDED(iblb_sharded_step_f32, float)
IBLB_SHARDED(iblb_sharded_step_f64, double)

extern "C" const char* iblb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
