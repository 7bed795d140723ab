// B0: collide only, on a table of slabs of cells, in one launch.
//
// Replaces cuda_iblb_11_tpu/ops/pallas_step.py:make_collide_rows_kernel
// (:742, call :775): f1 = collide_cell(f, force) (collide.cuh, B1) for each
// cell of a [9, n, m] slab, with no streaming.  The sharded path computes
// the f1 it hands its neighbours this way: the edge lines of every shard
// each step (parallel/sharded.py:_fluid_step) and the two seam columns of
// every x-column's band block each band sub-step (_band_substep_x).  Those
// values are pulled across a seam in place of what the neighbour's own
// step kernel would have computed internally, so they must round exactly
// as the step kernels round (the JAX package's reason for this kernel,
// :749-756: the IB feedback amplifies a seam f1 that merely rounds
// differently).  Sharing collide_cell and the build flags guarantees it.
//
// What bounds it: the launch.  A slab is a row or a column of a shard (a
// 2048^2 (2, 2) shard's edge column is 1,024 cells, 80 KB in f32: 0.02 us
// of bytes at 3.35 TB/s), so one launch per slab costs its fixed launch
// time over and over: 16 launches a step on a (2, 2) mesh.  Design: one
// launch collides every slab of one exchange.  The slabs' table (each
// slab's f and force addresses, element strides (plane, row, column),
// shape, output offset and first block) reaches the kernel by value as a
// __grid_constant__ kernel parameter, at most MAX_SLABS a launch, inside
// the 4 KB parameter space: no host-to-device copy per call.  Each slab
// takes ceil(n m / RB) blocks; a block finds its slab by walking the
// table's block prefix.  One thread per cell reads its nine f and two
// force values through the strides (an edge column is read in place) and
// writes its slab's f1 contiguous [9, n, m], the slabs back to back in one
// output buffer.  Every cell goes through the same collide_cell as before,
// so each f1 equals the single-slab kernel's bit for bit.
//
// bf16 storage (the _bf16 entry, the JAX package's --dtype bfloat16 on a
// mesh): f is read as bf16 through the slab's strides and widened exactly
// (load_f of step.cuh); the force is float and the collide runs in float
// through the same collide_cell; f1 is written in float.  That is JAX's B0
// in bf16 (pallas_step.py:760-783: the inputs cast to the compute type,
// the output in it) and what its mesh collides at the seams
// (ref.collide_rows(rows_f.astype(aux), ...), sharded.py:578-581,
// 1007-1011): the f1 a neighbour pulls stays float, and B3 and
// _patch_x_seams round it where the TPU path rounds it.  So on the same
// values widened, the bf16 entry's f1 equals the f32 entry's bit for bit.

#include "step.cuh"

namespace {

constexpr int RB = 256;
constexpr int MAX_SLABS = 32;   // 32 x 88 B of table: well inside 4 KB
constexpr int TABLE_COLS = 10;  // int64 per slab in the host table

struct Slab {
  const void* f;
  long long fp, fr, fc;   // f's element strides (plane, row, column)
  const void* g;
  long long gp, gr, gc;   // the force's
  long long out;          // element offset of the slab's f1 in the output
  int n, m;               // rows, columns
  int block0;             // the slab's first block
};

struct SlabTable {
  Slab s[MAX_SLABS];
  int count;
};

// T is the compute type (and f1's and the force's), S f's storage type.
template <typename T, typename S>
__global__ void __launch_bounds__(RB)
collide_slabs_kernel(const __grid_constant__ SlabTable tab,
                     T* __restrict__ f1, Coeffs<T> k) {
  int s = 0;
  while (s + 1 < tab.count && (int)blockIdx.x >= tab.s[s + 1].block0) ++s;
  const Slab& sl = tab.s[s];
  const long long cells = (long long)sl.n * sl.m;
  const long long cell = (long long)(blockIdx.x - sl.block0) * RB
                         + threadIdx.x;
  if (cell >= cells) return;
  const int r = (int)(cell / sl.m);
  const int c = (int)(cell - (long long)r * sl.m);
  const S* f = static_cast<const S*>(sl.f);
  const T* force = static_cast<const T*>(sl.g);
  const long long jf = r * sl.fr + c * sl.fc;
  const long long jg = r * sl.gr + c * sl.gc;
  T fi[9];
#pragma unroll
  for (int d = 0; d < 9; ++d) fi[d] = load_f(f + d * sl.fp + jf);
  T out[9];
  collide_cell<T, true>(fi, force[jg], force[sl.gp + jg], k, out);
  T* dst = f1 + sl.out;
#pragma unroll
  for (int d = 0; d < 9; ++d) dst[d * cells + cell] = out[d];
}

template <typename T, typename S>
int collide_slabs(const long long* table, int count, void* f1, double tau,
                  double tau2, int forcing_trt, int deviatoric,
                  void* stream) {
  if (count < 1 || count > MAX_SLABS) return (int)cudaErrorInvalidValue;
  SlabTable tab;
  long long out = 0, blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* row = table + (long long)i * TABLE_COLS;
    Slab& sl = tab.s[i];
    sl.f = reinterpret_cast<const void*>(row[0]);
    sl.fp = row[1];
    sl.fr = row[2];
    sl.fc = row[3];
    sl.g = reinterpret_cast<const void*>(row[4]);
    sl.gp = row[5];
    sl.gr = row[6];
    sl.gc = row[7];
    sl.n = (int)row[8];
    sl.m = (int)row[9];
    sl.out = out;
    sl.block0 = (int)blocks;
    const long long cells = row[8] * row[9];
    out += 9 * cells;
    blocks += (cells + RB - 1) / RB;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  tab.count = count;
  if (blocks == 0) return 0;   // every slab empty: nothing to launch
  collide_slabs_kernel<T, S>
      <<<(unsigned)blocks, RB, 0, (cudaStream_t)stream>>>(
          tab, (T*)f1, make_coeffs<T>(tau, tau2, forcing_trt, deviatoric));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's.  `table` is a host array of
// count x 10 int64, one row per slab: f's address and element strides
// (plane, row, column), the force's address and strides, n, m.  The slabs'
// f1 are written contiguous [9, n, m], back to back in slab order, into
// f1, which must not overlap any input.  At most 32 slabs a call.  Each
// entry is built for a compute type T and a storage type S of f: _f32
// (float, float), _f64 (double, double) and _bf16 (float, __nv_bfloat16),
// whose f is bf16 and whose force and f1 are float.
#define IBLB_COLLIDE_SLABS(NAME, T, S)                                       \
  extern "C" int NAME(const long long* table, int count, void* f1,           \
                      double tau, double tau2, int forcing_trt,              \
                      int deviatoric, void* stream) {                        \
    return collide_slabs<T, S>(table, count, f1, tau, tau2, forcing_trt,     \
                               deviatoric, stream);                          \
  }
IBLB_COLLIDE_SLABS(iblb_collide_slabs_f32, float, float)
IBLB_COLLIDE_SLABS(iblb_collide_slabs_f64, double, double)
IBLB_COLLIDE_SLABS(iblb_collide_slabs_bf16, float, __nv_bfloat16)
