// pgather.cu — the five gather kernels of the gather microbenchmark, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of benchmarks/micro_pgather.py, one kernel
// each, computing what the Pallas body computes:
//   taa1_kernel    kern_taa1 (:284)       out[r, l] = tab[r, idx[r, l]]: per-row
//                                         128-entry tables, indexed along lanes
//   taa0_kernel    kern_taa0 (:310)       out[r, l] = tab[idx[r, l], l]: a column
//                                         gather over all R rows
//   vmem_kernel    pallas_vmem kern (:334)   out = tab[idx], table held whole
//   stream_kernel  pallas_stream kern (:354) out = tab[idx] through a walk over
//                                         the whole table, every lane masked
//   binned_kernel  pallas_binned kern (:390) out[s, k] = tab[idx[s, k]], where
//                                         idx[s, .] lies inside shard s
// ops/pgather.py holds each kernel's plain torch version and its wrapper.
//
// Indices are int32, as in JAX; every offset into a table and every size is
// 64-bit, since a 1024^3-class table holds 1.1 G floats (4.3 GB).  A kernel
// reads nothing outside its table: an index outside it gives NaN, as jnp.take's
// default fill does, except in stream_kernel, whose masked walk leaves 0 there,
// as the Pallas kernel's where(in shard, ...) does.
//
// What bounds each one on this card, and what the design does about it (kept
// simple on purpose: the point of the benchmark is the gather wall, and
// making these fast is later work):
//  * taa1: one block per four rows.  The block stages its rows' 128 floats
//    each in shared memory with one coalesced load, then every thread reads
//    smem[idx].  Bound by streaming tab, idx and out once (3 MB at R = 2048):
//    device-memory bytes, a few microseconds.
//  * taa0: the gather runs down a column, across all R rows, so a block
//    stages a strip of up to 16 columns for all R rows in dynamic shared
//    memory (R x 16 x 4 bytes = 128 KB at R = 2048, past the 48 KB default,
//    hence the opt-in in pgather_init) and writes the outputs of 128 rows of
//    the strip.  Every block of a strip re-reads the strip (16 reads of the
//    1 MB table at R = 2048, from L2): bound by those L2 reads and the
//    shared-memory reads, which conflict on banks for random rows.
//  * vmem: on the TPU the table (up to 8 MB) sat whole in VMEM.  This card's
//    counterpart is the 50 MB L2, which holds the 8 MB table; shared memory
//    (227 KB per block) cannot.  So it is a flat gather through the read-only
//    path (__ldg), one thread per index: bound by one 32-byte L2 sector per
//    4-byte value.
//  * stream: the Pallas kernel walked S shards of the table through VMEM, one
//    4.19 MB shard per grid step, and masked-took every lane in each.  A
//    shard does not fit shared memory, so a chunk of 12,288 floats (48 KB)
//    stands in for it: each block keeps its 4,096 lanes' indices in
//    registers, walks the whole table chunk by chunk, loading each chunk
//    coalesced, and a lane takes its value in the chunk that holds its index.
//    The output is written once.  Every block reads the whole table (64
//    blocks x 67 MB at the published size): bound by that traffic, mostly
//    from L2 since the blocks walk in step.  It is meant to lose, as it did
//    on the TPU.
//  * binned: grid over (shard, lane block), shard-major, so the blocks of one
//    shard are scheduled together and read one shard's part of the table
//    while it is in L2: a 4.19 MB shard (67 MB table) fits L2, a 269 MB shard
//    (4.3 GB table) does not.  Bound by one sector per value, from L2 or from
//    device memory accordingly.
// No kernel allocates or synchronises; each launches on the caller's stream,
// so the wrappers can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 128;               // lanes per row
constexpr int TAA1_ROWS = 4;         // rows per taa1 block
constexpr int TAA0_COLS = 16;        // widest taa0 column strip
constexpr int TAA0_ROWS = 128;       // output rows per taa0 block
constexpr int TAA0_THREADS = 1024;  // one block per SM: all the loads it can keep in flight
constexpr int MAX_SMEM = 232448;     // 227 KB: the most a block may opt in to
constexpr int FLAT_THREADS = 256;    // vmem and binned
constexpr int STREAM_THREADS = 512;
constexpr int STREAM_LANES = 8;      // lanes per stream thread
constexpr int STREAM_CHUNK = 12288;  // floats: 48 KB of static shared memory

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(W * TAA1_ROWS) taa1_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t R) {
  __shared__ float row[TAA1_ROWS][W];
  const int l = threadIdx.x, y = threadIdx.y;
  const int64_t r = (int64_t)blockIdx.x * TAA1_ROWS + y;
  const int64_t i = r * W + l;
  if (r < R) row[y][l] = tab[i];
  __syncthreads();
  if (r < R) {
    const int32_t q = idx[i];
    out[i] = (q >= 0 && q < W) ? row[y][q] : NAN;
  }
}

__global__ void __launch_bounds__(TAA0_THREADS) taa0_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t R, int cols) {
  extern __shared__ float strip[];  // (R, cols): columns c0 .. c0 + cols - 1
  const int c0 = blockIdx.x * cols;
  const int64_t r0 = (int64_t)blockIdx.y * TAA0_ROWS;
  for (int64_t e = threadIdx.x; e < R * cols; e += TAA0_THREADS) {
    const int64_t r = e / cols;
    strip[e] = tab[r * W + c0 + (e - r * cols)];
  }
  __syncthreads();
  const int64_t n_out = min64(TAA0_ROWS, R - r0) * cols;
  for (int64_t e = threadIdx.x; e < n_out; e += TAA0_THREADS) {
    const int64_t dr = e / cols;
    const int c = (int)(e - dr * cols);
    const int64_t i = (r0 + dr) * W + c0 + c;
    const int32_t q = idx[i];
    out[i] = (q >= 0 && q < R) ? strip[(int64_t)q * cols + c] : NAN;
  }
}

__global__ void __launch_bounds__(FLAT_THREADS) vmem_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t V, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (i < n) {
    const int32_t q = idx[i];
    out[i] = (q >= 0 && q < V) ? __ldg(tab + q) : NAN;
  }
}

__global__ void __launch_bounds__(STREAM_THREADS) stream_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t V, int64_t n, int vec4) {
  __shared__ __align__(16) float chunk[STREAM_CHUNK];
  const int64_t base =
      (int64_t)blockIdx.x * (STREAM_THREADS * STREAM_LANES) + threadIdx.x;
  int32_t q[STREAM_LANES];
  float v[STREAM_LANES];
#pragma unroll
  for (int j = 0; j < STREAM_LANES; ++j) {
    const int64_t i = base + (int64_t)j * STREAM_THREADS;
    q[j] = i < n ? idx[i] : -1;
    v[j] = 0.0f;
  }
  for (int64_t c0 = 0; c0 < V; c0 += STREAM_CHUNK) {
    const int len = (int)min64(STREAM_CHUNK, V - c0);
    int e = threadIdx.x;
    if (vec4) {  // tab is 16-byte aligned and c0 a multiple of 4
      const float4* __restrict__ src = reinterpret_cast<const float4*>(tab + c0);
      float4* dst = reinterpret_cast<float4*>(chunk);
#pragma unroll 6
      for (; e < len / 4; e += STREAM_THREADS) dst[e] = __ldg(src + e);
      e = (len / 4) * 4 + threadIdx.x;
    }
    for (; e < len; e += STREAM_THREADS) chunk[e] = tab[c0 + e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < STREAM_LANES; ++j) {
      const int64_t d = (int64_t)q[j] - c0;
      if (d >= 0 && d < len) v[j] = chunk[d];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < STREAM_LANES; ++j) {
    const int64_t i = base + (int64_t)j * STREAM_THREADS;
    if (i < n) out[i] = v[j];
  }
}

__global__ void __launch_bounds__(FLAT_THREADS) binned_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t C, int64_t K, int blocks_per_shard) {
  const int64_t s = blockIdx.x / blocks_per_shard;
  const int64_t k =
      (int64_t)(blockIdx.x - s * blocks_per_shard) * FLAT_THREADS + threadIdx.x;
  if (k < K) {
    const int64_t i = s * K + k;
    const int64_t loc = (int64_t)idx[i] - s * C;
    out[i] = (loc >= 0 && loc < C) ? __ldg(tab + s * C + loc) : NAN;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// Plain C entry points, loaded with ctypes (ops/pgather.py).  Every table is
// float32, every index array int32, every output float32 of the index
// array's shape; all are contiguous.  Each returns cudaGetLastError().

// Lets taa0_kernel take more than 48 KB of dynamic shared memory.  Called
// once, when the library is loaded, before any launch or graph capture.
extern "C" int pgather_init() {
  return (int)cudaFuncSetAttribute(
      taa0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

// tab, idx, out (R, 128).
extern "C" int taa1_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t R, void* stream) {
  if (R > 0) {
    taa1_kernel<<<(unsigned)ceil_div(R, TAA1_ROWS), dim3(W, TAA1_ROWS), 0,
                  (cudaStream_t)stream>>>(tab, idx, out, R);
  }
  return (int)cudaGetLastError();
}

// The widest strip of at most 16 columns whose R rows fit shared memory; 0
// when one column of R rows does not (R > 58,112).
extern "C" int taa0_cols(int64_t R) {
  int cols = TAA0_COLS;
  while (cols > 0 && R * cols * (int64_t)sizeof(float) > MAX_SMEM) cols /= 2;
  return cols;
}

// tab, idx, out (R, 128).
extern "C" int taa0_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t R, void* stream) {
  const int cols = taa0_cols(R);
  if (cols == 0) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const dim3 grid(W / cols, (unsigned)ceil_div(R, TAA0_ROWS));
    taa0_kernel<<<grid, TAA0_THREADS, R * cols * sizeof(float),
                  (cudaStream_t)stream>>>(tab, idx, out, R, cols);
  }
  return (int)cudaGetLastError();
}

// tab (V,); idx, out n elements.
extern "C" int vmem_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t V, int64_t n, void* stream) {
  if (n > 0) {
    vmem_kernel<<<(unsigned)ceil_div(n, FLAT_THREADS), FLAT_THREADS, 0,
                  (cudaStream_t)stream>>>(tab, idx, out, V, n);
  }
  return (int)cudaGetLastError();
}

// tab (V,), V = S * C; idx, out n elements.
extern "C" int stream_launch(const float* tab, const int32_t* idx, float* out,
                             int64_t V, int64_t n, void* stream) {
  if (n > 0) {
    const int vec4 = ((uintptr_t)tab % 16) == 0;
    stream_kernel<<<(unsigned)ceil_div(n, STREAM_THREADS * STREAM_LANES),
                    STREAM_THREADS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, V, n, vec4);
  }
  return (int)cudaGetLastError();
}

// tab (V,) with shards of C floats; idx, out (S, K) with K lanes per shard.
extern "C" int binned_launch(const float* tab, const int32_t* idx, float* out,
                             int64_t C, int64_t S, int64_t K, void* stream) {
  if (S > 0 && K > 0) {
    const int64_t per_shard = ceil_div(K, FLAT_THREADS);
    binned_kernel<<<(unsigned)(S * per_shard), FLAT_THREADS, 0,
                    (cudaStream_t)stream>>>(tab, idx, out, C, K,
                                            (int)per_shard);
  }
  return (int)cudaGetLastError();
}
