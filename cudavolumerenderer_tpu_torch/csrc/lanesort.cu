// lanesort.cu — a stable sort of a pool's lanes on the card, for Hopper
// (sm_90a): sortingSK's Morton reorder and brickSK's per-round sort by brick.
//
// Replaces two sorts that XLA compiled inside a lax.while_loop's one device
// program (no Pallas kernel):
//   * cudavolumerenderer_tpu/models/streaming.py:113 `_morton_reorder` (under
//     render_tile's loop, lax.cond :188): the Morton key of each lane's
//     position in the medium box (ops/morton.py), DEAD_KEY for dead lanes, a
//     stable argsort and a take of every pool field;
//   * cudavolumerenderer_tpu/models/brick.py:387 `jnp.argsort(keys)` (under
//     render_tile's loop, :464): the stable order of brickSK's lanes by
//     brick, the lanes that cannot track (the sentinel) last.
// Each computes what the port's plain version (ops/lanesort.py) computes on
// the card, bit for bit: morton.ray_sort_keys, torch.argsort(stable=True)
// and a take of every field copied back into the pool; torch.sort(keys,
// stable=True) into skeys and order.
//
// The sort is an LSD radix sort of 8-bit digits over keys of at most 32
// bits.  The Morton key of a live lane is a 30-bit code, and a dead lane's
// is 2^30 (DEAD_KEY's place: after every code, every dead lane tied), so 31
// bits and 4 passes give the 32-bit sort's order.  A brick key is its brick
// id, and the sentinel is mapped to n_bricks (`top`), so it takes
// ceil(bits(n_bricks) / 8) passes: one for up to 255 bricks, two up to
// 65,535.  The keys launch computes every key into a buffer and each tile's
// digit histogram for the first pass (a block of 1,024 threads a tile).  A
// pass is one launch of one block per tile of TILE keys: 8 warps of 32
// lanes load ITEMS keys each at once, then, in position order, rank each
// key among the equal digits of its warp
// (__match_any_sync: the peers before it, plus the warp's running count);
// the warps' counts are scanned in shared memory; the tiles before this
// one are summed from the pass's histograms in device memory, and the
// digits' totals scanned across the block.  A key's place is then
//   (keys of smaller digits) + (its digit in earlier tiles) + (in earlier
//   warps) + (its rank in its warp),
// which keeps equal digits in position order: each pass is stable, so the
// sort is.  Each pass also adds every key it places into the next pass's
// histogram of the tile it lands in (one atomic a key), so no launch waits
// on another block and no state outlives a sort: the keys launch writes the
// first pass's histograms and zeroes the later ones.  The last Morton pass
// writes the order; a gather launch takes every field of lane order[i] into
// a scratch pool (SoA, the pool's own layout), and a copy launch writes it
// back into the pool's tensors, whose addresses the prepared body launches
// hold.  The last brick pass writes skeys (the sentinel restored) and the
// order as int64, as torch.sort does.  A Morton sort point is 7 launches, a
// brick sort 1 + passes.
//
// Every launch reads the loop's control words when given (common.cuh
// stage_stopped: at a chain's start with the count at 0) and returns
// untouched once the loop has stopped, as the body launches around it do,
// so the host reads nothing.
//
// What bounds it on this card: bytes.  A Morton sort moves each lane's 107
// B of fields twice (read and written; FIELD_BYTES) plus 16 B a pass of
// keys and indices; a brick sort 16 B a lane plus the passes'.  At 2^17
// lanes the first is ~28 MB (8.4 us at 3.35 TB/s), the second ~2.6 MB at
// 160,000 lanes; what each launch pays besides (its ramp, the histogram
// sums of O(tiles^2) words, the passes' scattered writes) is measured in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

using namespace cvr;

namespace {

constexpr int THREADS = 256;      // threads a block, one digit each in the scans
constexpr int RADIX_BITS = 8;     // a pass's digit
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;          // keys a lane holds in a pass
constexpr int TILE = THREADS * ITEMS;  // keys a block ranks in a pass
constexpr int KEY_THREADS = 1024;  // the keys launch's threads a tile
constexpr int MAX_PASSES = 4;
static_assert(RADIX == THREADS, "one digit a thread");

// The lane fields of a pool (ops/familybody.py LANE_FIELDS, the RNG's two
// words split), in their order, and their bytes a lane.
constexpr int N_LANE = 14;
__host__ __device__ constexpr int field_bytes(int f) {
  constexpr int FIELD_BYTES[N_LANE] = {12, 12, 12, 12, 1, 8, 8, 8, 1, 4, 4, 12, 1, 12};
  return FIELD_BYTES[f];
}
constexpr int F_O = 0, F_ALIVE = 4;

// Pointer slots: the pool's fields, the scratch pool's, two key and two index
// buffers (uint32, int32; width each), the passes' histograms (uint32,
// passes x tiles x RADIX), the control words (or null), brickSK's keys in
// position order (int32) and the sort's outputs, skeys (int32) and order
// (int64).
enum {
  S_FIELD = 0,
  S_SCRATCH = S_FIELD + N_LANE,
  S_KA = S_SCRATCH + N_LANE, S_KB, S_IA, S_IB, S_COUNTS, S_CTRL, S_KEYS, S_SKEYS, S_ORDER,
  N_S,
};

enum { MODE_MORTON = 0, MODE_BRICK = 1 };

// brickSK's key of a lane that cannot track (ops/brickbody.py SENTINEL)
constexpr int SENTINEL = 0x7FFFFFFF;
// a dead lane's Morton key: after every 30-bit code
constexpr uint32_t DEAD = 1u << 30;

struct Sort {
  void* p[N_S];
  const long long* ctrl;  // the loop's control words, or null: ungated
  long long chain;
  float box[6];           // the medium box's min and extent (Morton)
  uint32_t top;           // the sentinel's key (brick)
  int width;
  int tiles;
  int passes;
};

__device__ __forceinline__ bool stopped(const Sort& A) {
  return A.ctrl != nullptr && stage_stopped(A.ctrl, A.chain, 0);
}

// ops/morton.py expand_bits on uint32 (its products wrap as the masked int64
// ones do)
__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// morton.ray_sort_keys of lane i, DEAD for a dead lane: p01 = (o - bmin) /
// (bmax - bmin) by IEEE division (torch's tensor division; a reciprocal's
// product would move a lane across a cell now and then), * 1024, clamped to
// [0, 1023] and truncated.
__device__ __forceinline__ uint32_t morton_key(const Sort& A, long long i) {
  if (!((const bool*)A.p[S_FIELD + F_ALIVE])[i]) return DEAD;
  const float* o = (const float*)A.p[S_FIELD + F_O] + 3 * i;
  uint32_t q[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p01 = __fdiv_rn(__fsub_rn(o[a], A.box[a]), A.box[3 + a]);
    q[a] = (uint32_t)fminf(fmaxf(__fmul_rn(p01, 1024.0f), 0.0f), 1023.0f);
  }
  return expand_bits(q[0]) * 4u + expand_bits(q[1]) * 2u + expand_bits(q[2]);
}

__device__ __forceinline__ uint32_t brick_key(const Sort& A, long long i) {
  const int k = ((const int*)A.p[S_KEYS])[i];
  return k == SENTINEL ? A.top : (uint32_t)k;
}

// The keys of every lane into KA, each tile's first-pass digit histogram,
// and the later passes' histograms zeroed.
template <int MODE>
__global__ void __launch_bounds__(KEY_THREADS) keys_kernel(Sort A) {
  if (stopped(A)) return;
  __shared__ uint32_t s_hist[RADIX];
  if (threadIdx.x < RADIX) s_hist[threadIdx.x] = 0u;
  __syncthreads();
  uint32_t* ka = (uint32_t*)A.p[S_KA];
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int j = 0; j < TILE / KEY_THREADS; ++j) {
    const long long i = base + j * KEY_THREADS + threadIdx.x;
    if (i < A.width) {
      const uint32_t k = MODE == MODE_MORTON ? morton_key(A, i) : brick_key(A, i);
      ka[i] = k;
      atomicAdd(&s_hist[k & (RADIX - 1)], 1u);
    }
  }
  __syncthreads();
  uint32_t* counts = (uint32_t*)A.p[S_COUNTS];
  if (threadIdx.x < RADIX) counts[(long long)blockIdx.x * RADIX + threadIdx.x] = s_hist[threadIdx.x];
  const long long later = (long long)(A.passes - 1) * A.tiles * RADIX;
  for (long long k = (long long)blockIdx.x * KEY_THREADS + threadIdx.x; k < later;
       k += (long long)gridDim.x * KEY_THREADS)
    counts[(long long)A.tiles * RADIX + k] = 0u;
}

// One radix pass over the tile of this block: keys (and the lanes they
// belong to) from the pass's input buffers to its output buffers, stably by
// the pass's digit; the last pass writes the order (Morton) or skeys and
// order (brick).
template <int MODE, bool LAST>
__global__ void __launch_bounds__(THREADS) pass_kernel(Sort A, int pass) {
  if (stopped(A)) return;
  __shared__ uint32_t s_warp[WARPS][RADIX];  // per warp and digit: counts, then prefixes
  __shared__ uint32_t s_base[RADIX];
  __shared__ uint32_t s_sum[WARPS];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) s_warp[v][t] = 0u;
  __syncthreads();
  const bool even = pass % 2 == 0;
  const uint32_t* kin = (const uint32_t*)A.p[even ? S_KA : S_KB];
  const int* iin = (const int*)A.p[even ? S_IA : S_IB];
  const int shift = pass * RADIX_BITS;
  const unsigned below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE + w * (32 * ITEMS);
  uint32_t key[ITEMS], rank[ITEMS];
  int lane_of[ITEMS];
  // the warp's keys, every load in flight at once
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + j * 32 + lane;
    const bool valid = i < A.width;
    key[j] = valid ? kin[i] : 0u;
    lane_of[j] = !valid ? 0 : pass == 0 ? (int)i : iin[i];
  }
  // each warp's keys in position order: its rank among equal digits
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool valid = base + j * 32 + lane < A.width;
    const uint32_t d = (key[j] >> shift) & (RADIX - 1);
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? d : RADIX + lane);
    const uint32_t before = valid ? s_warp[w][d] : 0u;
    __syncwarp();
    if (valid && (peers & below) == 0u) s_warp[w][d] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & below);
  }
  __syncthreads();
  // digit t: the earlier warps' counts, the earlier tiles', and the total
  uint32_t run = 0u;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const uint32_t c = s_warp[v][t];
    s_warp[v][t] = run;
    run += c;
  }
  const uint32_t* counts = (const uint32_t*)A.p[S_COUNTS] + (long long)pass * A.tiles * RADIX;
  uint32_t earlier = 0u, total = 0u;
#pragma unroll 16
  for (int u = 0; u < A.tiles; ++u) {  // 16 loads in flight
    const uint32_t c = counts[(long long)u * RADIX + t];
    earlier += u < (int)blockIdx.x ? c : 0u;
    total += c;
  }
  // the keys of smaller digits: an exclusive scan of the totals
  uint32_t incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_sum[w] = incl;
  __syncthreads();
  uint32_t smaller = incl - total;
  for (int v = 0; v < w; ++v) smaller += s_sum[v];
  s_base[t] = smaller + earlier;
  __syncthreads();
  uint32_t* kout = (uint32_t*)A.p[even ? S_KB : S_KA];
  int* iout = (int*)A.p[even ? S_IB : S_IA];
  uint32_t* next = (uint32_t*)A.p[S_COUNTS] + (long long)(pass + 1) * A.tiles * RADIX;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (base + j * 32 + lane >= A.width) continue;
    const uint32_t d = (key[j] >> shift) & (RADIX - 1);
    const uint32_t dest = s_base[d] + s_warp[w][d] + rank[j];
    if (!LAST) {
      kout[dest] = key[j];
      iout[dest] = lane_of[j];
      atomicAdd(next + (dest / TILE) * RADIX + ((key[j] >> (shift + RADIX_BITS)) & (RADIX - 1)),
                1u);
    } else if (MODE == MODE_MORTON) {
      iout[dest] = lane_of[j];
    } else {
      ((int*)A.p[S_SKEYS])[dest] = key[j] == A.top ? SENTINEL : (int)key[j];
      ((long long*)A.p[S_ORDER])[dest] = lane_of[j];
    }
  }
}

// One element of `bytes` bytes from element a of `from` to element b of `to`.
__device__ __forceinline__ void copy_element(const void* from, void* to, int bytes, long long a,
                                             long long b) {
  switch (bytes) {
    case 1:
      ((uint8_t*)to)[b] = ((const uint8_t*)from)[a];
      break;
    case 4:
      ((uint32_t*)to)[b] = ((const uint32_t*)from)[a];
      break;
    case 8:
      ((unsigned long long*)to)[b] = ((const unsigned long long*)from)[a];
      break;
    default:  // 12: a float3
      for (int c = 0; c < 3; ++c) ((uint32_t*)to)[3 * b + c] = ((const uint32_t*)from)[3 * a + c];
  }
}

// Every field of lane order[i] into the scratch pool's lane i.
__global__ void __launch_bounds__(THREADS) gather_kernel(Sort A, int order_slot) {
  if (stopped(A)) return;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= A.width) return;
  const long long src = ((const int*)A.p[order_slot])[i];
#pragma unroll
  for (int f = 0; f < N_LANE; ++f)
    copy_element(A.p[S_FIELD + f], A.p[S_SCRATCH + f], field_bytes(f), src, i);
}

// The scratch pool back into the pool's own tensors.
__global__ void __launch_bounds__(THREADS) copy_back_kernel(Sort A) {
  if (stopped(A)) return;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= A.width) return;
#pragma unroll
  for (int f = 0; f < N_LANE; ++f)
    copy_element(A.p[S_SCRATCH + f], A.p[S_FIELD + f], field_bytes(f), i, i);
}

template <int MODE>
int run(const Sort& A, cudaStream_t st) {
  keys_kernel<MODE><<<A.tiles, KEY_THREADS, 0, st>>>(A);
  int err = (int)cudaGetLastError();
  for (int p = 0; p < A.passes && err == 0; ++p) {
    if (p == A.passes - 1)
      pass_kernel<MODE, true><<<A.tiles, THREADS, 0, st>>>(A, p);
    else
      pass_kernel<MODE, false><<<A.tiles, THREADS, 0, st>>>(A, p);
    err = (int)cudaGetLastError();
  }
  if (MODE == MODE_MORTON && err == 0) {
    const int blocks = (A.width + THREADS - 1) / THREADS;
    // the last pass wrote the order into the index buffer it writes
    gather_kernel<<<blocks, THREADS, 0, st>>>(A, (A.passes - 1) % 2 == 0 ? S_IB : S_IA);
    err = (int)cudaGetLastError();
    if (err == 0) {
      copy_back_kernel<<<blocks, THREADS, 0, st>>>(A);
      err = (int)cudaGetLastError();
    }
  }
  return err;
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/lanesort.py).

// One sort (mode 0: Morton, the pool's fields permuted in place; mode 1:
// brick, skeys and order written) of `width` lanes in `passes` radix passes
// (1 .. 4, enough for every key up to `top`): box (6 float32, host) the
// medium box's min and extent (Morton), top the sentinel's key (brick), ptrs
// (N_S device addresses, host), gated on ptrs[S_CTRL] (chain `chain`) when
// set.  Returns the first cudaGetLastError() that is not 0, or -1 when an
// argument does not fit this build.
extern "C" int lanesort_run(int mode, const float* box, long long top, int passes,
                            void* const* ptrs, int n_s, long long chain, int width,
                            void* stream) {
  if (n_s != N_S || passes < 1 || passes > MAX_PASSES || chain < 1 || width < 0) return -1;
  if (mode != MODE_MORTON && mode != MODE_BRICK) return -1;
  if (top < 0 || (passes < MAX_PASSES && (top >> (RADIX_BITS * passes)) != 0)) return -1;
  if (width == 0) return 0;
  Sort A;
  for (int k = 0; k < N_S; ++k) A.p[k] = ptrs[k];
  A.ctrl = (const long long*)ptrs[S_CTRL];
  A.chain = chain;
  for (int k = 0; k < 6; ++k) A.box[k] = box[k];
  A.top = (uint32_t)top;
  A.width = width;
  A.tiles = (width + TILE - 1) / TILE;
  A.passes = passes;
  const cudaStream_t st = (cudaStream_t)stream;
  return mode == MODE_MORTON ? run<MODE_MORTON>(A, st) : run<MODE_BRICK>(A, st);
}

// The field bytes this build permutes (N_LANE ints), for the wrapper's check.
extern "C" void lanesort_fields(int* bytes) {
  for (int f = 0; f < N_LANE; ++f) bytes[f] = field_bytes(f);
}

// The layout sizes this build expects (N_LANE, N_S, TILE, N_CTRL), for the
// wrapper's check.
extern "C" void lanesort_layout(int* sizes) {
  sizes[0] = N_LANE;
  sizes[1] = N_S;
  sizes[2] = TILE;
  sizes[3] = N_CTRL;
}
