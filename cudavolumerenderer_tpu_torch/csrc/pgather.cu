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
//  * taa1: it streams tab, idx and out once, but at N = 262,144 a call is a
//    launch and one round trip, so what counts is that nothing waits twice.
//    One warp per row and no block barrier: each lane issues its 16-byte
//    tab load and its 16-byte idx load together, puts its 4 values in the
//    warp's 512-byte slice of shared memory, and after __syncwarp reads its
//    4 outputs there and stores them in 16 bytes; a grid of one wave walks
//    the rows.  Measured on the H100 (PERF.md), the slice was 0.03-0.08 us
//    faster than taking the row from registers by __shfl_sync (16 shuffles
//    a lane), and 8 warps per block no slower than 2, 4 or 16.
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
//  * vmem and binned: one tile kernel, gather_tiles.  The Pallas kernel held
//    vmem's table in VMEM; this card's counterpart is the 50 MB L2, which
//    holds it (at most 8 MB, micro_pgather.VMEM_ENTRIES).  binned's 4.19 MB
//    shards of the 67 MB table fit L2, the 269 MB shards of the 4.3 GB table
//    do not.  A persistent grid walks flat tiles of the shard-major lanes.
//    Each thread holds 4 lanes of a tile.  It copies their indices with one
//    16-byte cp.async into a 2-stage shared-memory ring: the next tile's copy
//    is in flight while this tile is read.  While its copy is in flight it
//    finds the group's shard, then issues all 4 table reads, then one
//    16-byte store.  L2 policy per access: the table is read evict_last (its
//    sectors are what later calls reuse), idx and out evict_first; no
//    process-wide L2 persistence is set.  A scalar path with the same lanes
//    and no staging takes idx or out not 16-byte aligned, or K not a
//    multiple of 4.
//    What bounds them, as measured on the H100 (PERF.md, kernel table), at
//    the benchmark's N = 262,144: latency, not bytes.  In the graph protocol a
//    tiny torch op costs ~1.3 us and a copy_ of the 1 MB idx into a 1 MB
//    buffer ~2.65 us; vmem takes ~1 us more than that copy: an index round
//    trip, then a round trip of random 32-byte sectors from L2.  Warm, binned
//    rests on its touched sectors staying in L2, which the evict_last
//    policy protects (without it 67 MB and 4.3 GB run 0.4-0.7 us slower);
//    cold, on device memory's rate of random sectors.  Every step before the
//    first index copy lands on the critical path, so the copy address needs
//    no division (a tile's first lane is t * tile lanes).  Measured choices:
//    more lanes per thread helped warm at 4.3 GB and cost cold time; 4 lanes
//    was the best balance; a TMA bulk copy and a per-tile sort of the
//    offsets were slower.  At N = 262,144 every block has one tile, so the
//    ring overlaps copies only in larger calls.
// No kernel allocates or synchronises; each launches on the caller's stream,
// so the wrappers can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 128;               // lanes per row
constexpr int TAA1_WARPS = 8, TAA1_BLOCKS_PER_SM = 8;  // taa1: rows per block, one wave
constexpr int FLAT_THREADS = 256;    // taa0 and stream
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

// taa1: one warp per row, rows r = warp, warp + warps, ... (a grid of one
// wave).  Lane t issues its 16-byte load of tab (row elements 4t .. 4t + 3)
// and its 16-byte load of idx together, writes its 4 values into the warp's
// slice of shared memory, and after __syncwarp reads its 4 outputs from the
// slice and stores them in 16 bytes.  An index outside the row gives NaN.
// The scalar path (tab, idx or out not 16-byte aligned) has lane t hold
// elements t, t + 32, t + 64, t + 96 instead.
__global__ void __launch_bounds__(32 * TAA1_WARPS) taa1_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t R, int vec) {
  __shared__ __align__(16) float slice[TAA1_WARPS][W];
  const int lane = threadIdx.x & 31;
  float* row = slice[threadIdx.x >> 5];
  auto pick = [&](int32_t q) { return (unsigned)q < (unsigned)W ? row[q] : NAN; };
  const int64_t warps = (int64_t)gridDim.x * TAA1_WARPS;
  for (int64_t r = (int64_t)blockIdx.x * TAA1_WARPS + (threadIdx.x >> 5); r < R;
       r += warps) {
    const int64_t base = r * W;
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(tab + base) + lane);
      const int4 q = __ldg(reinterpret_cast<const int4*>(idx + base) + lane);
      reinterpret_cast<float4*>(row)[lane] = v;
      __syncwarp();
      const float4 o = make_float4(pick(q.x), pick(q.y), pick(q.z), pick(q.w));
      reinterpret_cast<float4*>(out + base)[lane] = o;
    } else {
      int32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        row[k * 32 + lane] = __ldg(tab + base + k * 32 + lane);
        q[k] = __ldg(idx + base + k * 32 + lane);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) out[base + k * 32 + lane] = pick(q[k]);
    }
    __syncwarp();  // every lane has read the slice before the next row lands
  }
}

__global__ void __launch_bounds__(FLAT_THREADS) taa0_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t R, int vec4) {
  gather4(ColumnTake{tab, R}, idx, out, R * W, vec4);
}

__global__ void __launch_bounds__(FLAT_THREADS) stream_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t V, int64_t n, int vec4) {
  gather4(MaskedTake{tab, V}, idx, out, n, vec4);
}

// -- vmem and binned: the tile kernel ---------------------------------------

// L2 cache policies (PTX createpolicy) and the accesses that carry them.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ float load_table(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int32_t load_index(const int32_t* p, uint64_t pol) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ void store_out(float* p, float v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(p), "f"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ void store_out4(float* p, const float* v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "l"(pol)
               : "memory");
}
// 16 bytes of global memory into shared memory, asynchronously (cp.async).
__device__ __forceinline__ void copy16(int32_t* smem, const int32_t* gmem,
                                       uint64_t pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "l"(pol) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// One lane's value: tab[q] where q lies in its shard's window [lo, lo + C)
// of the table, else NaN, and nothing read.
__device__ __forceinline__ float take_window(const float* __restrict__ tab,
                                             int32_t q, int64_t lo, int64_t C,
                                             uint64_t keep) {
  const int64_t loc = (int64_t)q - lo;
  return (loc >= 0 && loc < C) ? load_table(tab + lo + loc, keep) : NAN;
}

// The tile walk over n = S * K lanes, shard-major as idx lies in memory
// (lane i belongs to shard i / K; vmem is one shard, K = n), in tiles of
// THREADS * LPT lanes; block b takes tiles b, b + G, b + 2G, ...  Lane p of
// a tile belongs to thread (p / 4) % THREADS, group (p / 4) / THREADS, slot
// p % 4: a warp's 16-byte accesses of one group are 512 contiguous bytes,
// and with K a multiple of 4 a group never straddles two shards.  A tile's
// first lane is t * THREADS * LPT, so its index copy is issued with no
// division; each group's shard is found while that copy is in flight.
template <int THREADS, int LPT>
__device__ __forceinline__ void gather_tiles(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t C, int64_t S, int64_t K, int vec) {
  constexpr int GROUPS = LPT / 4;
  constexpr int TL = THREADS * LPT;
  const int64_t n = S * K;  // < 2^32 (the launcher checks)
  const unsigned tiles = (unsigned)((n + TL - 1) / TL), G = gridDim.x;
  const int tid = threadIdx.x;
  const uint64_t keep = evict_last_policy(), pass = evict_first_policy();
  auto window = [&](int64_t lane) {  // the first table entry of lane's shard
    return S == 1 ? (int64_t)0 : (int64_t)((unsigned)lane / (unsigned)K) * C;
  };

  if (!vec) {  // scalar path: the same lanes, no staging
    for (unsigned t = blockIdx.x; t < tiles; t += G) {
      const int64_t start = (int64_t)t * TL;
      int32_t q[LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int64_t i = start + ((l / 4) * THREADS + tid) * 4 + l % 4;
        q[l] = i < n ? load_index(idx + i, pass) : 0;
      }
      float v[LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int64_t i = start + ((l / 4) * THREADS + tid) * 4 + l % 4;
        v[l] = i < n ? take_window(tab, q[l], window(i), C, keep) : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int64_t i = start + ((l / 4) * THREADS + tid) * 4 + l % 4;
        if (i < n) store_out(out + i, v[l], pass);
      }
    }
    return;
  }

  // The ring: tile k of this block in stage k % 2.  Each thread copies its
  // own groups and reads back only those, so no block barrier is needed.
  __shared__ __align__(16) int32_t ring[2][TL];
  auto stage = [&](unsigned t, int st) {  // one commit group per tile
    if (t < tiles) {
      const int64_t start = (int64_t)t * TL;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int p = (g * THREADS + tid) * 4;
        if (start + p < n) copy16(&ring[st][p], idx + start + p, pass);
      }
    }
    copy_commit();
  };
  stage(blockIdx.x, 0);
  int k = 0;
  for (unsigned t = blockIdx.x; t < tiles; t += G, ++k) {
    stage(t + G, (k + 1) & 1);  // the next tile's copy, in flight from here
    const int64_t start = (int64_t)t * TL;
    int64_t lo[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) lo[g] = window(start + (g * THREADS + tid) * 4);
    copy_wait_all_but_one();  // this thread's copies of tile t have landed
    float v[LPT];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {  // every table read before any store
      const int p = (g * THREADS + tid) * 4;
      if (start + p < n) {
        const int4 q = *reinterpret_cast<const int4*>(&ring[k & 1][p]);
        v[g * 4] = take_window(tab, q.x, lo[g], C, keep);
        v[g * 4 + 1] = take_window(tab, q.y, lo[g], C, keep);
        v[g * 4 + 2] = take_window(tab, q.z, lo[g], C, keep);
        v[g * 4 + 3] = take_window(tab, q.w, lo[g], C, keep);
      }
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int p = (g * THREADS + tid) * 4;
      if (start + p < n) store_out4(out + start + p, v + g * 4, pass);
    }
  }
}

// Each kernel's tile shape: threads per block, lanes per thread, blocks per
// SM of the persistent grid (the shapes timed fastest, PERF.md).
constexpr int VMEM_THREADS = 256, VMEM_LPT = 4, VMEM_BLOCKS_PER_SM = 2;
constexpr int BINNED_THREADS = 512, BINNED_LPT = 4, BINNED_BLOCKS_PER_SM = 1;

__global__ void __launch_bounds__(VMEM_THREADS) vmem_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t V, int64_t n, int vec) {
  gather_tiles<VMEM_THREADS, VMEM_LPT>(tab, idx, out, V, 1, n, vec);
}

__global__ void __launch_bounds__(BINNED_THREADS) binned_kernel(
    const float* __restrict__ tab, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t C, int64_t S, int64_t K, int vec) {
  gather_tiles<BINNED_THREADS, BINNED_LPT>(tab, idx, out, C, S, K, vec);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// gather4's grid over n lanes, and whether it may take the 16-byte path.
unsigned gather4_blocks(int64_t n) {
  return (unsigned)ceil_div(n, (int64_t)FLAT_THREADS * LANES);
}
int gather4_vec(const int32_t* idx, const float* out, int64_t n) {
  return ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0) && n % LANES == 0;
}

// A persistent grid over n lanes in tiles of tile_lanes (for taa1, rows in
// blocks of warps): at most blocks_per_sm blocks per SM, and no more blocks
// than tiles.
unsigned tile_blocks(int64_t n, int tile_lanes, int blocks_per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = ceil_div(n, tile_lanes);
  const int64_t most = (int64_t)(sms > 0 ? sms : 1) * blocks_per_sm;
  return (unsigned)(tiles < most ? tiles : most);
}

int taa1_vec(const float* tab, const int32_t* idx, const float* out) {
  return ((uintptr_t)tab % 16 == 0) && ((uintptr_t)idx % 16 == 0) &&
         ((uintptr_t)out % 16 == 0);
}

}  // namespace


// Plain C entry points, loaded with ctypes (ops/pgather.py).  Every table is
// float32, every index array int32, every output float32 of the index
// array's shape; all are contiguous.  Each returns cudaGetLastError().

// tab, idx, out (R, 128).
extern "C" int taa1_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t R, void* stream) {
  if (R > 0) {
    taa1_kernel<<<tile_blocks(R, TAA1_WARPS, TAA1_BLOCKS_PER_SM),
                  32 * TAA1_WARPS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, R, taa1_vec(tab, idx, out));
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
// (the tile kernel takes fewer than 2^32 lanes)
extern "C" int vmem_launch(const float* tab, const int32_t* idx, float* out,
                           int64_t V, int64_t n, void* stream) {
  if (n >= (int64_t(1) << 32)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    vmem_kernel<<<tile_blocks(n, VMEM_THREADS * VMEM_LPT, VMEM_BLOCKS_PER_SM),
                  VMEM_THREADS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, V, n, gather4_vec(idx, out, n));
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
// The 16-byte path needs K a multiple of 4 too, so no group straddles two
// shards.
extern "C" int binned_launch(const float* tab, const int32_t* idx, float* out,
                             int64_t C, int64_t S, int64_t K, void* stream) {
  if (S * K >= (int64_t(1) << 32)) return (int)cudaErrorInvalidValue;
  if (S > 0 && K > 0) {
    binned_kernel<<<tile_blocks(S * K, BINNED_THREADS * BINNED_LPT,
                                BINNED_BLOCKS_PER_SM),
                    BINNED_THREADS, 0, (cudaStream_t)stream>>>(
        tab, idx, out, C, S, K, gather4_vec(idx, out, K));
  }
  return (int)cudaGetLastError();
}
