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
//    has stopped changes nothing, so the loop stops there).  The step loop
//    is common.cuh's brick_steps, which brickbody.cu's round kernel runs too.
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

#include "common.cuh"

namespace {

using namespace cvr;

constexpr int TABLE_W = 128;  // lanes per row

// Float input rows (ops/tracking.py F_*).
enum {
  F_OX = 0, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_T, F_MAXT, F_BEXIT,
  F_BASEX, F_BASEY, F_BASEZ, F_INVSIG, F_INVRHO, N_F,
};

__global__ void __launch_bounds__(TABLE_W) track_kernel(
    const float* __restrict__ tab, const int64_t* __restrict__ row_brick,
    const float* __restrict__ f, const int64_t* __restrict__ rng_in,
    const int32_t* __restrict__ status_in, float* __restrict__ t_out,
    int32_t* __restrict__ status_out, int32_t* __restrict__ tap_out,
    int64_t* __restrict__ rng_out, int R, int n_steps) {
  __shared__ float row_tab[TRK_ROW];
  const int lane = threadIdx.x;
  const int64_t n = (int64_t)R * TABLE_W;
  const int64_t i = (int64_t)blockIdx.x * TABLE_W + lane;

  const float* __restrict__ src = tab + row_brick[blockIdx.x] * (int64_t)TRK_ROW;
  row_tab[lane] = src[lane];
  row_tab[lane + TABLE_W] = src[lane + TABLE_W];
  __syncthreads();

  const float o[3] = {f[F_OX * n + i], f[F_OY * n + i], f[F_OZ * n + i]};
  const float d[3] = {f[F_DX * n + i], f[F_DY * n + i], f[F_DZ * n + i]};
  const float base[3] = {f[F_BASEX * n + i], f[F_BASEY * n + i], f[F_BASEZ * n + i]};
  float t = f[F_T * n + i];
  uint32_t state = (uint32_t)rng_in[i];
  int status = status_in[i];
  int tap = 0;
  // the step loop is shared with brickbody.cu's round kernel (common.cuh)
  brick_steps(row_tab, o, d, base, f[F_MAXT * n + i], f[F_BEXIT * n + i],
              f[F_INVSIG * n + i], f[F_INVRHO * n + i], n_steps, t, status, tap, state,
              (uint32_t)rng_in[n + i]);

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
