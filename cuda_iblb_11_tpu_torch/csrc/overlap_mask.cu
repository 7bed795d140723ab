// The cilia's overlap mask: boundary_check's neighbour test (upstream
// main.cu:176-252) for a batch of steps, in one launch.
//
// Replaces no TPU kernel: the JAX package masks in jnp
// (cuda_iblb_11_tpu/models/cilia.py), and the port did so in eager torch
// (models/cilia.py, whose plain version stays in ops/overlap_mask.py).
// Node j of cilium m is switched off (eps 0) where it lies closer than one
// lattice unit, on both axes, to any node of cilia m - 1 ... m - (r_max -
// 1), the cilium index taken modulo c; r_max = 2 LENGTH / c_space.  At
// upstream's own spacing (c_space 48, LENGTH 96) r_max is 4: three
// neighbours, each of LENGTH nodes, for each node.  The eager version
// builds [n, c, LENGTH, LENGTH] differences for each neighbour: at 256
// cilia a 512-step chunk makes 4.8 GB float32 temporaries and moves
// ≈ 137 GB of device memory, for 7.1 M pair tests a step.
//
// What bounds it: operations.  A step reads x and y (8 bytes a node in
// float32) and writes eps (4 bytes), 295 KB at 256 cilia, and tests
// (r_max - 1) LENGTH pairs a node, 4 operations a pair (two differences,
// two compares): 28 MOP a step, 0.42 us at 67 TFLOP/s against 0.09 us of
// bytes.  Design: a warp takes one cilium of one step, each lane holding
// NP = ceil(LENGTH / 32) (at most 4) of its nodes in registers; for each
// neighbour the warp stages that cilium's nodes into shared memory as
// (x, y) pairs, and every lane reads each pair once (all lanes read the
// same address: a broadcast) and tests it against its NP nodes.  A pair
// test is two subtractions, the larger magnitude of the two and the least
// of those kept: min over the pairs of max(|dx|, |dy|) < 1 is "some pair
// closer than one on both axes", exactly, since min and max round nothing.
// Every pair is tested, with no early exit, so the work is the same for
// every step.  Eight warps a block, one step's eight neighbouring cilia;
// no barrier of the block (each warp stages its own neighbour).
//
// Bit for bit the eager mask: the same differences (neighbour minus own)
// in the points' dtype, the same compares with 1; x and y are finite.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;    // cilia of one step a block, one a warp
constexpr int KCH = 128;    // neighbour nodes a warp stages at once

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__device__ __forceinline__ float nearer(float d, float dx, float dy) {
  return fminf(d, fmaxf(fabsf(dx), fabsf(dy)));
}
__device__ __forceinline__ double nearer(double d, double dx, double dy) {
  return fmin(d, fmax(fabs(dx), fabs(dy)));
}

template <typename T, int NP>
__global__ void __launch_bounds__(WARPS * 32)
overlap_mask_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    int* __restrict__ eps, int c, int len, int r_max,
                    int groups) {
  using T2 = typename Pair<T>::type;
  __shared__ T2 nb[WARPS][KCH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long step = blockIdx.x / groups;
  const int m = (int)(blockIdx.x % groups) * WARPS + warp;
  if (m >= c) return;   // the whole warp: no barrier waits for it
  const long long first = step * c;   // the step's cilium 0
  const T* xm = x + (first + m) * len;
  const T* ym = y + (first + m) * len;
  int* em = eps + (first + m) * len;
  for (int j0 = 0; j0 < len; j0 += 32 * NP) {
    T xi[NP], yi[NP], d[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = j0 + lane + 32 * i;
      xi[i] = j < len ? xm[j] : T(0);
      yi[i] = j < len ? ym[j] : T(0);
      d[i] = T(1);
    }
    for (int r = 1; r < r_max; ++r) {
      const int mo = ((m - r) % c + c) % c;
      const T* xo = x + (first + mo) * len;
      const T* yo = y + (first + mo) * len;
      for (int k0 = 0; k0 < len; k0 += KCH) {
        const int kn = min(KCH, len - k0);
        __syncwarp();   // the last chunk's reads are done
        for (int k = lane; k < kn; k += 32) {
          T2 p;
          p.x = xo[k0 + k];
          p.y = yo[k0 + k];
          nb[warp][k] = p;
        }
        __syncwarp();
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const T2 p = nb[warp][k];
#pragma unroll
          for (int i = 0; i < NP; ++i)
            d[i] = nearer(d[i], p.x - xi[i], p.y - yi[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = j0 + lane + 32 * i;
      if (j < len) em[j] = d[i] < T(1) ? 0 : 1;
    }
  }
}

template <typename T, int NP>
void launch(const void* x, const void* y, void* eps, int c, int len,
            int r_max, int groups, unsigned blocks, cudaStream_t stream) {
  overlap_mask_kernel<T, NP><<<blocks, WARPS * 32, 0, stream>>>(
      (const T*)x, (const T*)y, (int*)eps, c, len, r_max, groups);
}

template <typename T>
int overlap_mask(const void* x, const void* y, void* eps, long long n,
                 int c, int len, int r_max, void* stream) {
  if (n < 0 || c < 1 || len < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int groups = (c + WARPS - 1) / WARPS;
  const long long blocks = n * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = (unsigned)blocks;
  switch ((len + 31) / 32) {
    case 1: launch<T, 1>(x, y, eps, c, len, r_max, groups, b, s); break;
    case 2: launch<T, 2>(x, y, eps, c, len, r_max, groups, b, s); break;
    case 3: launch<T, 3>(x, y, eps, c, len, r_max, groups, b, s); break;
    default: launch<T, 4>(x, y, eps, c, len, r_max, groups, b, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes), as fused_step.cu's.  x, y: [n, c, len] contiguous
// placed node positions of n steps; eps: [n, c, len] int32, written
// whole (all 1 for r_max <= 1).  _f32 and _f64 take float and double
// positions.
#define IBLB_OVERLAP_MASK(NAME, T)                                           \
  extern "C" int NAME(const void* x, const void* y, void* eps, long long n, \
                      int c, int len, int r_max, void* stream) {             \
    return overlap_mask<T>(x, y, eps, n, c, len, r_max, stream);             \
  }
IBLB_OVERLAP_MASK(iblb_overlap_mask_f32, float)
IBLB_OVERLAP_MASK(iblb_overlap_mask_f64, double)
