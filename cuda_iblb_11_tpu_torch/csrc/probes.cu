// P1, P2, P3: the probes that measure the card's own ceilings, f32 only.
//
// P2 replaces scripts/probe_bw.py:make_pallas_copy (:67, pallas_call :72,
// kernels copy_kernel :59 and scale_kernel :63): out = x, or out = x *
// 1.0000001, optionally in place (the aliased variant, :78).  One thread
// per 16-byte vector (float4), grid-stride over the array; out may be the
// same array as in (each vector is read and written by one thread), never
// a partial overlap.  Bound: each byte read once and written once, 302 MB
// for the [9, 2048, 2048] f32 state, so 0.090 ms at 3.35 TB/s.  The TPU's
// row-tile sweep becomes a sweep of block shapes (threads per block, and a
// grid of one vector per thread or a persistent grid), set by the wrapper.
//
// P3 replaces scripts/probe_bw.py:make_manual_dma_copy (:86, pallas_call
// :117): the copy through a ring of `depth` on-chip buffers, each filled
// by an asynchronous copy started depth - 1 tiles ahead (:104-113).  On
// Hopper the whole copy runs on the TMA, both ways: one thread per block
// drives the ring.  It loads each tile global -> shared memory with
// cp.async.bulk, completing on its stage's mbarrier, and stores it back
// shared -> global with cp.async.bulk in a bulk group of its own.  A stage
// is refilled once cp.async.bulk.wait_group.read says its store has
// finished reading it; no thread reads a tile into registers and no
// barrier of the block sits in the loop.  The load of tile i + depth - 1
// is issued right after the store of tile i, so a load and a store are in
// flight in every block at once.  Blocks are one warp, so shared memory
// alone sets how many a SM holds (227 KB over depth x tile, at most 32).
// Each block streams a run of `run` consecutive tiles (the wrapper's
// RING_RUN, 4: more than either depth, so each ring wraps, but at depth 2
// a stage is refilled only once; longer runs, whose parity flips both
// ways, are the same kernel and ran slower, since fewer blocks leave a
// tail); the grid is one block per run, and the card's block scheduler
// hands the runs out in address order as blocks finish.  A persistent grid of resident blocks striding over the tiles
// ran at 0.94 of copy_'s rate (probe_bw.py), as P2's persistent grid runs
// below its one-shot grid.  Both proxies of a stage are the async one, so
// no proxy fence is needed (one would be where threads wrote a stage).
// Same bound as P2; the ring must not alias its output.
//
// P1 replaces scripts/probe_vpu.py:timed (:55, pallas_call :59) with the
// bodies mk_fma / mk_add / mk_mul (:95-116): each thread holds one element
// in a register and runs R dependent links, fmaf(v, 1.0000001f, 1e-7f)
// (2 flops), v + 1e-7f or v * 1.0000001f (1 each).  R is a runtime
// argument and the loop is unrolled CHAIN_UNROLL links deep, so nothing
// folds at compile time and the loop's own instructions are about 1.5% of
// the instruction slots; the rate is the slope between two chain lengths
// (probe_vpu.py:79-89), which cancels the launch and the memory traffic.
// Bound: the operations over the card's 67 TFLOP/s f32 peak.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// --- P2 -------------------------------------------------------------------

template <bool kScale>
__global__ void copy_kernel(const float4* in, float4* out, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step) {
    float4 v = in[i];
    if (kScale) {
      v.x *= 1.0000001f;
      v.y *= 1.0000001f;
      v.z *= 1.0000001f;
      v.w *= 1.0000001f;
    }
    out[i] = v;
  }
}

// --- P3 -------------------------------------------------------------------

constexpr int RING_THREADS = 32;   // one warp; its first thread drives
constexpr int RING_HEAD = 128;     // mbarriers ahead of the stage buffers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__global__ void __launch_bounds__(RING_THREADS)
ring_copy_kernel(const char* in, char* out, long long n_tiles,
                 int tile_bytes, int depth, int run) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf = smem + RING_HEAD;
  const long long first = (long long)blockIdx.x * run;
  const long long n_mine = n_tiles - first < run ? n_tiles - first : run;
  for (int s = 0; s < depth; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bar[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // load the block's i-th tile into its stage
  auto fill = [&](long long i) {
    const int s = (int)(i % depth);
    const uint32_t b = smem_addr(&bar[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(tile_bytes) : "memory");
    const char* src = in + (first + i) * (long long)tile_bytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(buf + (long long)s * tile_bytes)), "l"(src),
           "r"(tile_bytes), "r"(b)
        : "memory");
  };

  for (long long i = 0; i < depth - 1 && i < n_mine; ++i) fill(i);
  for (long long i = 0; i < n_mine; ++i) {
    const int s = (int)(i % depth);
    const uint32_t parity = (uint32_t)((i / depth) & 1);
    while (!mbar_try_wait(smem_addr(&bar[s]), parity)) {
    }
    char* dst = out + (first + i) * (long long)tile_bytes;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n"
        :: "l"(dst), "r"(smem_addr(buf + (long long)s * tile_bytes)),
           "r"(tile_bytes)
        : "memory");
    if (i + depth - 1 < n_mine) {
      // tile i + depth - 1 takes the stage tile i - 1 was stored from:
      // wait until only the newest store (tile i's) may still read
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      fill(i + depth - 1);
    }
  }
  // every store has left shared memory and landed before the block ends
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- the launch floor ------------------------------------------------------

// A kernel that does nothing: timed back to back, the fixed device time of
// one launch, the floor under a kernel as small as B0.
__global__ void empty_kernel() {}

// --- P1 -------------------------------------------------------------------

constexpr int CHAIN_UNROLL = 200;   // divides both chain lengths, 2000 and 6000
constexpr int CHAIN_THREADS = 256;

template <int kOp>
__device__ __forceinline__ float link(float v) {
  if (kOp == 0) return fmaf(v, 1.0000001f, 1e-7f);
  if (kOp == 1) return v + 1e-7f;
  return v * 1.0000001f;
}

template <int kOp>
__global__ void chain_kernel(const float* __restrict__ in,
                             float* __restrict__ out, long long n, int reps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = in[i];
  int r = 0;
  for (; r + CHAIN_UNROLL <= reps; r += CHAIN_UNROLL) {
#pragma unroll
    for (int u = 0; u < CHAIN_UNROLL; ++u) v = link<kOp>(v);
  }
  for (; r < reps; ++r) v = link<kOp>(v);
  out[i] = v;
}

}  // namespace

// C interface (ctypes), float32 only: pointers and the stream are void*,
// the return value is the cudaError_t of the launch.

// P2: n_vec float4 vectors; scale 0 copies, 1 multiplies by 1.0000001f;
// blocks x threads threads stride over the vectors.
extern "C" int iblb_probe_copy_f32(const void* in, void* out, long long n_vec,
                                   int scale, int threads, int blocks,
                                   void* stream) {
  const dim3 grid(blocks), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (scale) {
    copy_kernel<true><<<grid, block, 0, st>>>((const float4*)in,
                                              (float4*)out, n_vec);
  } else {
    copy_kernel<false><<<grid, block, 0, st>>>((const float4*)in,
                                               (float4*)out, n_vec);
  }
  return (int)cudaGetLastError();
}

// P3: n_tiles tiles of tile_bytes (a multiple of 16) through a ring of
// depth stages, run tiles a block.
extern "C" int iblb_probe_ring_copy_f32(const void* in, void* out,
                                        long long n_tiles, int tile_bytes,
                                        int depth, int run, void* stream) {
  const int smem = RING_HEAD + depth * tile_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ring_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_tiles + run - 1) / run;
  ring_copy_kernel<<<(unsigned)blocks, RING_THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const char*)in, (char*)out, n_tiles, tile_bytes, depth, run);
  return (int)cudaGetLastError();
}

// P1: op 0 fma, 1 add, 2 mul; reps dependent links per element, one
// thread each.
extern "C" int iblb_probe_chain_f32(const void* in, void* out, long long n,
                                    int reps, int op, void* stream) {
  const dim3 grid((unsigned)((n + CHAIN_THREADS - 1) / CHAIN_THREADS)),
      block(CHAIN_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)in;
  float* y = (float*)out;
  if (op == 0) {
    chain_kernel<0><<<grid, block, 0, st>>>(x, y, n, reps);
  } else if (op == 1) {
    chain_kernel<1><<<grid, block, 0, st>>>(x, y, n, reps);
  } else {
    chain_kernel<2><<<grid, block, 0, st>>>(x, y, n, reps);
  }
  return (int)cudaGetLastError();
}

// The launch floor: `count` back-to-back launches of empty_kernel (one
// block of one warp), issued from here so the host's own cost per launch
// stays as small as it can be.
extern "C" int iblb_probe_empty_f32(int count, void* stream) {
  for (int i = 0; i < count; ++i) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  }
  return (int)cudaGetLastError();
}
