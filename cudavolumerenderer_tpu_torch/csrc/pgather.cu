// pgather.cu — the five gather kernels of the gather microbenchmark, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of benchmarks/micro_pgather.py, one kernel
// each, computing what the Pallas body computes:
//   taa1_kernel    kern_taa1 (:284)       out[r, l] = tab[r, idx[r, l]]: per-row
//                                         128-entry tables, indexed along lanes
//   taa0_kernel    kern_taa0 (:310)       out[r, l] = tab[idx[r, l], l]: a column
//                                         gather over all R rows
//   vmem_kernel    pallas_vmem kern (:334)   out = tab[idx], table held whole
//   stream_kernel  pallas_stream kern (:354) out = tab[idx], 0 outside the table
//                                         (the masked shard takes' fill)
//   binned_kernel  pallas_binned kern (:390) out[s, k] = tab[idx[s, k]], where
//                                         idx[s, .] lies inside shard s
// ops/pgather.py holds each kernel's plain torch version and its wrapper.
//
// Indices are int32, as in JAX; every offset into a table and every size is
// 64-bit, since a 1024^3-class table holds 1.1 G floats (4.3 GB).  A kernel
// reads nothing outside its table: an index outside it gives NaN, as jnp.take's
// default fill does, except in stream_kernel, which gives 0 there, as the
// Pallas kernel's where(in shard, ...) over every shard does.
//
// What bounds each one on this card, and what the design does about it.  The
// least any of them can move is each index read once, each needed value read
// once and each output written once: 12 bytes per lane, 3.1 MB at the
// benchmark's N = 262,144 (0.94 us at 3.35 TB/s).  A random 4-byte value costs
// a whole 32-byte sector, though, so from device memory the floor is 40 bytes
// per lane (about 3.1 us); from the 50 MB L2 the sectors are cheaper.
//  * taa1: one block per four rows.  The block stages its rows' 128 floats
//    each in shared memory with one coalesced load, then every thread reads
//    smem[idx].  It streams tab, idx and out once: bound by those bytes.
//  * taa0 and stream: one thread per 4 consecutive lanes, one 16-byte load of
//    idx, four independent read-only loads (__ldg) in flight, one 16-byte
//    store of out (a scalar path where idx or out is not 16-byte aligned or n
//    is not a multiple of 4).  Bound by one sector per value, from L2 while
//    the touched sectors fit it.  For taa0 every value of a row's 4 lanes is
//    tab[q * 128 + l], a distinct sector; the (R, 128) table is 1 MB at
//    R = 2,048 and sits in L2, which stands in for the TPU's VMEM, so nothing
//    is staged and R has no cap.  For stream, the TPU walked S shards through
//    VMEM because a TPU core cannot gather from HBM; Hopper can, so of the
//    shard walk only its range test is left, and each lane reads its one value.
//  * vmem: the Pallas kernel held its whole table in VMEM.  This card's
//    counterpart is the 50 MB L2, which holds the benchmark's table for it
//    (at most 8 MB, micro_pgather.VMEM_ENTRIES); shared memory (227 KB per
//    block) cannot.  So it is a flat gather through the read-only
//    path (__ldg), one thread per index: bound by one 32-byte L2 sector per
//    4-byte value.
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
constexpr int FLAT_THREADS = 256;    // every kernel but taa1
constexpr int LANES = 4;             // lanes per taa0 and stream thread

// Lanes i0 .. i0 + 3 of a gather whose lane i reads take(idx[i], i): one
// 16-byte load of idx, four independent loads, one 16-byte store when vec4
// (idx and out 16-byte aligned, n a multiple of 4), else lane by lane.
template <class Take>
__device__ __forceinline__ void gather4(const Take& take,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ out, int64_t n,
                                        int vec4) {
  const int64_t i0 = ((int64_t)blockIdx.x * FLAT_THREADS + threadIdx.x) * LANES;
  if (i0 >= n) return;
  if (vec4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx + i0));
    float4 v;
    v.x = take(q.x, i0);
    v.y = take(q.y, i0 + 1);
    v.z = take(q.z, i0 + 2);
    v.w = take(q.w, i0 + 3);
    *reinterpret_cast<float4*>(out + i0) = v;
  } else {
    for (int64_t i = i0; i < i0 + LANES && i < n; ++i) out[i] = take(__ldg(idx + i), i);
  }
}

// taa0's lane i = r * 128 + l reads column l at row q.
struct ColumnTake {
  const float* tab;
  int64_t R;
  __device__ __forceinline__ float operator()(int32_t q, int64_t i) const {
    return (q >= 0 && q < R) ? __ldg(tab + (int64_t)q * W + (i & (W - 1))) : NAN;
  }
};

// stream's lane reads tab[q], 0 outside the table.
struct MaskedTake {
  const float* tab;
  int64_t V;
  __device__ __forceinline__ float operator()(int32_t q, int64_t) const {
    return (q >= 0 && q < V) ? __ldg(tab + q) : 0.0f;
  }
};

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

__global__ void __launch_bounds__(FLAT_THREADS) taa0_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t R, int vec4) {
  gather4(ColumnTake{tab, R}, idx, out, R * W, vec4);
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

__global__ void __launch_bounds__(FLAT_THREADS) stream_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t V, int64_t n, int vec4) {
  gather4(MaskedTake{tab, V}, idx, out, n, vec4);
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

// gather4's grid over n lanes, and whether it may take the 16-byte path.
unsigned gather4_blocks(int64_t n) {
  return (unsigned)ceil_div(n, (int64_t)FLAT_THREADS * LANES);
}
int gather4_vec(const int32_t* idx, const float* out, int64_t n) {
  return ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0) && n % LANES == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/pgather.py).  Every table is
// float32, every index array int32, every output float32 of the index
// array's shape; all are contiguous.  Each returns cudaGetLastError().

// tab, idx, out (R, 128).
extern "C" int taa1_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t R, void* stream) {
  if (R > 0) {
    taa1_kernel<<<(unsigned)ceil_div(R, TAA1_ROWS), dim3(W, TAA1_ROWS), 0,
                  (cudaStream_t)stream>>>(tab, idx, out, R);
  }
  return (int)cudaGetLastError();
}

// tab, idx, out (R, 128).
extern "C" int taa0_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t R, void* stream) {
  if (R > 0) {
    taa0_kernel<<<gather4_blocks(R * W), FLAT_THREADS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, R, gather4_vec(idx, out, R * W));
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

// tab (V,); idx, out n elements.
extern "C" int stream_launch(const float* tab, const int32_t* idx, float* out,
                             int64_t V, int64_t n, void* stream) {
  if (n > 0) {
    stream_kernel<<<gather4_blocks(n), FLAT_THREADS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, V, n, gather4_vec(idx, out, n));
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
