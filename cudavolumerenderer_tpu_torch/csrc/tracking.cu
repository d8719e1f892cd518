// tracking.cu — brick-binned Woodcock tracking kernel of brickSK, for Hopper (sm_90a).
//
// Replaces cudavolumerenderer_tpu/ops/pallas/tracking.py:make_track_kernel (the
// Pallas TPU kernel jitted by track_rows).  It computes what that kernel
// computes: lanes arrive binned so that each row of 128 tracks inside one
// 4x4x8 brick; each RUNNING lane runs up to K Woodcock steps — a flight draw
// under its reciprocal brick majorant, the exit test (EXIT_BRICK, or EXIT_BOX
// where the box exit comes first), a 30-bit stochastic-trilinear tap into the
// brick's dilated 5x5x9 table, and the acceptance test, which gives SCATTER
// and the tap's flat index.  The torch wavefront (models/brick.py) handles
// every event.
//
// Design, kept simple on purpose:
//  * One block per row of 128 lanes, one thread per lane.  The block stages
//    its row's 225-entry dilated table (256 floats, 1 KB) in shared memory
//    once, read from the shared (NB, 256) table at the row's brick index, so
//    every tap of every step is a shared-memory read.  The TPU kernel's
//    per-round gathered (R, 2, 128) table copy is gone.
//  * Per-lane state is (rows, R, 128) structure-of-arrays: neighbouring
//    threads read neighbouring words.
//  * Native uint32_t PCG, bit-equal to ops/rng.py; draws consume the lane's
//    own stream in the plain version's order (a masked draw of a lane that
//    has stopped changes nothing, so the loop stops there).
//  * float math follows the plain version op for op: built without
//    --use_fast_math and with -fmad=false, so logf stays IEEE-accurate and no
//    multiply-add is contracted.  min propagates NaN like torch.minimum.
//
// What bounds it on this card: at the brickSK slice's R = 1,250 rows the
// 1,250 blocks are all resident at once (about 10 per SM).  A call reads 76
// bytes and writes 20 bytes per lane, 8 per row, and the table words its
// taps touch (ops/tracking.track_bytes: 15.7 MB, 4.7 us at the memory rate,
// on random inputs at that size); each step is a short serial chain (three
// PCG draws, one logf, one shared-memory read).  A call comes within 2x of
// that bound (PERF.md).  In the slice its inputs are phase A's fresh
// outputs, which the 50 MB L2 can hold, so it can beat the device-memory
// bound there.  The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TABLE_W = 128;  // lanes per row
constexpr int ROW = 256;      // one brick's dilated table, zero-padded past 225
constexpr int DZ = 5, DY = 5, DX = 9;

// Lane status codes (ops/tracking.py).
constexpr int RUNNING = 0;
constexpr int SCATTER = 1;
constexpr int EXIT_BRICK = 2;
constexpr int EXIT_BOX = 3;

// Float input rows (ops/tracking.py F_*).
enum {
  F_OX = 0, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_T, F_MAXT, F_BEXIT,
  F_BASEX, F_BASEY, F_BASEZ, F_INVSIG, F_INVRHO, N_F,
};

constexpr uint32_t PCG_MULT = 747796405u;
constexpr float EPS = 1e-5f;  // constants.EPSILON

__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ int iclip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// One PCG-RXS-M-XS-32 draw (ops/rng.py semantics) that advances the state.
__device__ __forceinline__ uint32_t pcg(uint32_t& state, uint32_t inc) {
  const uint32_t s = state * PCG_MULT + inc;
  const uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  state = s;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Tap index along one axis: floor(local), plus one with probability
// frac(local) (u = 10 random bits / 1024), clipped to the dilated table.
// The float-to-int conversion saturates and maps NaN to 0; the pre-clip
// keeps the + 1 from overflowing and changes no clipped result.
__device__ __forceinline__ int tap_axis(float local, uint32_t bits10, int n) {
  const float fl = floorf(local);
  const float u = (float)bits10 * (1.0f / 1024.0f);
  const int i = iclip(__float2int_rz(fl), -1, n);
  return iclip(i + (u < local - fl ? 1 : 0), 0, n - 1);
}

__global__ void __launch_bounds__(TABLE_W) track_kernel(
    const float* __restrict__ tab, const int64_t* __restrict__ row_brick,
    const float* __restrict__ f, const int64_t* __restrict__ rng_in,
    const int32_t* __restrict__ status_in, float* __restrict__ t_out,
    int32_t* __restrict__ status_out, int32_t* __restrict__ tap_out,
    int64_t* __restrict__ rng_out, int R, int n_steps) {
  __shared__ float row_tab[ROW];
  const int lane = threadIdx.x;
  const int64_t n = (int64_t)R * TABLE_W;
  const int64_t i = (int64_t)blockIdx.x * TABLE_W + lane;

  const float* __restrict__ src = tab + row_brick[blockIdx.x] * (int64_t)ROW;
  row_tab[lane] = src[lane];
  row_tab[lane + TABLE_W] = src[lane + TABLE_W];
  __syncthreads();

  const float ox = f[F_OX * n + i], oy = f[F_OY * n + i], oz = f[F_OZ * n + i];
  const float dx = f[F_DX * n + i], dy = f[F_DY * n + i], dz = f[F_DZ * n + i];
  float t = f[F_T * n + i];
  const float max_t = f[F_MAXT * n + i];
  const float bexit = f[F_BEXIT * n + i];
  const float bx = f[F_BASEX * n + i], by = f[F_BASEY * n + i], bz = f[F_BASEZ * n + i];
  const float inv_sig = f[F_INVSIG * n + i];
  const float inv_rho = f[F_INVRHO * n + i];
  uint32_t state = (uint32_t)rng_in[i];
  const uint32_t inc = (uint32_t)rng_in[n + i];
  int status = status_in[i];
  int tap = 0;

  const float eff_exit = jmin(bexit, max_t);
  const int exit_code = max_t <= bexit ? EXIT_BOX : EXIT_BRICK;

  for (int k = 0; k < n_steps && status == RUNNING; ++k) {
    // ---- flight draw and exit test ----------------------------------------
    const float u1 = uniform(pcg(state, inc));
    const float step = -logf(jmax(u1, EPS)) * inv_sig;
    t = t + step;
    if (t >= eff_exit) {
      status = exit_code;
      break;
    }

    // ---- stochastic-trilinear tap into the dilated table -------------------
    const uint32_t bits2 = pcg(state, inc);
    const int ix = tap_axis(ox + t * dx - bx, bits2 & 0x3FFu, DX);
    const int iy = tap_axis(oy + t * dy - by, (bits2 >> 10) & 0x3FFu, DY);
    const int iz = tap_axis(oz + t * dz - bz, (bits2 >> 20) & 0x3FFu, DZ);
    const int flat = (iz * DY + iy) * DX + ix;
    const float rho = row_tab[flat];

    // ---- acceptance ---------------------------------------------------------
    const float u2 = uniform(pcg(state, inc));
    if (!(rho * inv_rho < u2)) {
      status = SCATTER;
      tap = flat;
      break;
    }
  }

  t_out[i] = t;
  status_out[i] = status;
  tap_out[i] = tap;
  rng_out[i] = (int64_t)state;
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/tracking.py).  Shapes: tab
// (NB, 256) f32; row_brick (R,) i64 in [0, NB); f (14, R, 128) f32; rng_in
// (2, R, 128) i64 holding uint32 (state, inc); status_in, status_out, tap_out
// (R, 128) i32; t_out (R, 128) f32; rng_out (R, 128) i64.  Returns
// cudaGetLastError().
extern "C" int track_launch(const float* tab, const int64_t* row_brick,
                            const float* f, const int64_t* rng_in,
                            const int32_t* status_in, float* t_out,
                            int32_t* status_out, int32_t* tap_out,
                            int64_t* rng_out, int R, int n_steps, void* stream) {
  if (R > 0) {
    track_kernel<<<R, TABLE_W, 0, (cudaStream_t)stream>>>(
        tab, row_brick, f, rng_in, status_in, t_out, status_out, tap_out,
        rng_out, R, n_steps);
  }
  return (int)cudaGetLastError();
}
