// tailpk.cu — persistent tail kernel of the fastSK cascade, for Hopper (sm_90a).
//
// Replaces cudavolumerenderer_tpu/ops/pallas/tailpk.py:make_tail_kernel (the
// Pallas TPU kernel jitted by run_tail_steps).  It computes what that kernel
// computes: for each deep path, K whole Woodcock steps inside the path's
// dilated 16^3 brick window (17^3 voxels) — a flight draw under the brick's
// dilated majorant, a 30-bit stochastic-trilinear tap, the acceptance test,
// and on a scatter the HG direction, albedo A*rho+B, bounce+1, the path cap
// and Russian roulette, then the re-derived box exit (aabb tie-break order)
// and DDA brick exit.  A path leaves with status RUN / NEED_WINDOW /
// EXIT_BOX / DEAD, and the torch service loop (models/fast.py
// _run_tailpk_stage) handles the rest.
//
// Design, kept simple on purpose:
//  * One thread per path; per-path state is (R,) structure-of-arrays rows.
//    The TPU kernel's (R, 128) lane broadcast is a TPU layout and is gone.
//  * No per-path copy of the window: the thread reads tab[brick, flat] of
//    the (NB, 4992) dilated-brick table through the read-only cache.
//    Staging windows in shared memory (19.6 KB per path) is later work.
//  * Native uint32_t PCG, bit-equal to ops/rng.py; draws consume the path's
//    own stream in the same order as the plain version.
//  * float math follows the plain version operation by operation: built
//    without --use_fast_math and with -fmad=false, so logf/sinf/cosf/sqrtf
//    and division stay IEEE-accurate and no multiply-add is contracted.
//    min/max propagate NaN like torch.minimum/maximum.
//
// What bounds it on this card: latency and occupancy, not bytes.  A call
// moves 196 bytes of state per path plus the table words its taps read
// (ops/tailpk.tail_bytes: about 25 KB at R = 128), nanoseconds at the
// memory rate.  The main path hands it R = 128 paths (tail_pk_width), which
// is one block on one of the 132 SMs; each step is a serial chain of a
// dependent read into an 82 MB table (medical 256^3) that L2 does not hold,
// and a few dozen flops.  The kernel allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TBRICK = 16;
constexpr int TDIL = TBRICK + 1;  // 17
constexpr int TROW = 4992;        // 39 * 128: one dilated brick, zero-padded

// Lane status codes (ops/tailpk.py).
constexpr int RUN = 0;
constexpr int NEED_WINDOW = 1;
constexpr int EXIT_BOX = 2;
constexpr int DEAD = 3;

// Parameter vector layout (ops/tailpk.py P_*).
enum {
  P_SCALE = 0, P_G,
  P_AR, P_AG, P_AB, P_BR, P_BG, P_BB,
  P_BMINX, P_BMINY, P_BMINZ, P_EXTX, P_EXTY, P_EXTZ,
  P_RM1X, P_RM1Y, P_RM1Z, P_MAXPATH, P_RR, P_NX, P_NY, P_NZ,
};

// Float state rows (ops/tailpk.py F_*), int rows (I_*).
enum {
  F_OX = 0, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_TR, F_TG, F_TB, F_T, F_MAXT,
  F_BEXIT, F_INVSIG, F_RHOMAX, F_NX, F_NY, F_NZ, N_F,
};
enum { I_WX = 0, I_WY, I_WZ, I_BOUNCE, I_STATUS, N_I };

constexpr uint32_t PCG_MULT = 747796405u;
constexpr float EPS = 1e-5f;                  // constants.EPSILON
constexpr float TWO_PI_F = 6.283185307179586f;  // constants.TWO_PI

__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ int iclip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// One masked PCG-RXS-M-XS-32 draw (ops/rng.py semantics).
__device__ __forceinline__ uint32_t pcg(uint32_t& state, uint32_t inc, bool active) {
  const uint32_t s = state * PCG_MULT + inc;
  const uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  if (active) state = s;
  return (word >> 22u) ^ word;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(128) tail_kernel(
    const float* __restrict__ tab, const int64_t* __restrict__ brick,
    const float* __restrict__ params, const float* __restrict__ fin,
    const int32_t* __restrict__ iin, const int64_t* __restrict__ rng_in,
    float* __restrict__ fout, int32_t* __restrict__ iout,
    int64_t* __restrict__ rng_out, int R, int n_steps) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= R) return;

  const float scale = params[P_SCALE];
  const float g = params[P_G];
  const float A[3] = {params[P_AR], params[P_AG], params[P_AB]};
  const float B[3] = {params[P_BR], params[P_BG], params[P_BB]};
  const float bmin[3] = {params[P_BMINX], params[P_BMINY], params[P_BMINZ]};
  const float ext[3] = {params[P_EXTX], params[P_EXTY], params[P_EXTZ]};
  const float rm1[3] = {params[P_RM1X], params[P_RM1Y], params[P_RM1Z]};
  const float max_path = params[P_MAXPATH];
  const float rr_on = params[P_RR];
  const int ngrid[3] = {(int)params[P_NX], (int)params[P_NY], (int)params[P_NZ]};
  const float epsw = jmax(jmax(ext[0], ext[1]), ext[2]) * 1e-6f;

  float o[3], d[3], tp[3], nrm[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = fin[(F_OX + a) * R + p];
    d[a] = fin[(F_DX + a) * R + p];
    tp[a] = fin[(F_TR + a) * R + p];
    nrm[a] = fin[(F_NX + a) * R + p];
  }
  float t = fin[F_T * R + p];
  float max_t = fin[F_MAXT * R + p];
  float bexit = fin[F_BEXIT * R + p];
  const float inv_sig = fin[F_INVSIG * R + p];
  const float rho_max = fin[F_RHOMAX * R + p];
  const int worg[3] = {iin[I_WX * R + p], iin[I_WY * R + p], iin[I_WZ * R + p]};
  int bounce = iin[I_BOUNCE * R + p];
  int status = iin[I_STATUS * R + p];
  uint32_t rs = (uint32_t)rng_in[p];
  const uint32_t inc = (uint32_t)rng_in[R + p];
  const float* __restrict__ win = tab + brick[p] * (int64_t)TROW;

  // A lane whose status is not RUN draws nothing and changes nothing in
  // the plain version's masked steps, so the loop may stop there.
  for (int k = 0; k < n_steps && status == RUN; ++k) {
    // ---- flight draw -----------------------------------------------------
    const float u1 = uniform(pcg(rs, inc, true));
    const float step = -logf(jmax(u1, EPS)) * inv_sig;
    const float t_cand = t + step;
    const float eff_exit = jmin(bexit, max_t);
    if (t_cand >= eff_exit) {
      // crossing lands on the exit plane; EXIT_BOX parks at max_t
      const bool box_closer = max_t <= bexit;
      status = box_closer ? EXIT_BOX : NEED_WINDOW;
      t = box_closer ? max_t : bexit;
      break;
    }
    t = t_cand;

    // ---- stochastic-trilinear tap ----------------------------------------
    const uint32_t bits2 = pcg(rs, inc, true);
    int local[3];
    for (int a = 0; a < 3; ++a) {
      const float pa = o[a] + t * d[a];
      const float c = jclip((pa - bmin[a]) / ext[a], 0.0f, 1.0f) * rm1[a];
      const float u = (float)((bits2 >> (10 * a)) & 0x3FFu) * (1.0f / 1024.0f);
      const float f = floorf(c);
      const int tap = iclip((int)f + (u < c - f ? 1 : 0), 0, ngrid[a] - 1);
      local[a] = iclip(tap - worg[a], 0, TDIL - 1);
    }
    const float rho = __ldg(win + (local[2] * TDIL + local[1]) * TDIL + local[0]);

    // ---- acceptance -------------------------------------------------------
    const float u2 = uniform(pcg(rs, inc, true));
    if (scale * rho * inv_sig < u2) continue;  // null collision

    // ---- scatter event ----------------------------------------------------
    const float e1 = uniform(pcg(rs, inc, true));
    const float e2 = uniform(pcg(rs, inc, true));
    // HG sampling (ops/phase.importance_sample_hg)
    const float sqr = (1.0f - g * g) / jmax(1.0f - g + 2.0f * g * e1, 1e-12f);
    const float g_safe = fabsf(g) > 1e-12f ? g : 1.0f;
    const float cos_a = (1.0f + g * g - sqr * sqr) / (2.0f * g_safe);
    const float cos_i = 1.0f - 2.0f * e1;
    const float cos_th = jclip(fabsf(g) > EPS ? cos_a : cos_i, -1.0f, 1.0f);
    const float sin_th = sqrtf(jmax(0.0f, 1.0f - cos_th * cos_th));
    const float phi = TWO_PI_F * e2;
    // local basis (ops/math3.local_basis)
    const float inv_n1 = 1.0f / sqrtf(jmax(d[0] * d[0] + d[2] * d[2], 1e-12f));
    const float v1x = d[2] * inv_n1, v1y = 0.0f, v1z = -d[0] * inv_n1;
    const float v2x = d[1] * v1z - d[2] * v1y;
    const float v2y = d[2] * v1x - d[0] * v1z;
    const float v2z = d[0] * v1y - d[1] * v1x;
    const float cp = cosf(phi), sp = sinf(phi);
    const float nd[3] = {
        sin_th * cp * v1x + sin_th * sp * v2x + cos_th * d[0],
        sin_th * cp * v1y + sin_th * sp * v2y + cos_th * d[1],
        sin_th * cp * v1z + sin_th * sp * v2z + cos_th * d[2],
    };
    for (int a = 0; a < 3; ++a) {
      o[a] = o[a] + d[a] * t - d[a] * EPS;
      tp[a] = tp[a] * (A[a] * rho + B[a]);
    }
    for (int a = 0; a < 3; ++a) d[a] = nd[a];
    bounce += 1;

    // path-length cap, then Russian roulette (body() order)
    if ((float)bounce >= max_path) {
      status = DEAD;
      break;
    }
    if (rr_on > 0.5f) {
      const float p_surv = jmin(1.0f, jmax(jmax(tp[0], tp[1]), tp[2]));
      const float u_rr = uniform(pcg(rs, inc, true));
      if (u_rr > p_surv) {
        status = DEAD;
        break;
      }
      const float inv_p = 1.0f / jmax(p_surv, 1e-20f);
      for (int a = 0; a < 3; ++a) tp[a] = tp[a] * inv_p;
    }

    // surviving scatter: restart the segment from the new pose.
    // Box exit and face normal (ops/aabb.aabb_intersect semantics; normal
    // picked in the order +x,+y,+z,-x,-y,-z among planes at t == dist).
    float ttop[3], tbot[3];
    for (int a = 0; a < 3; ++a) {
      const float inv = 1.0f / d[a];
      tbot[a] = (bmin[a] - o[a]) * inv;
      ttop[a] = (bmin[a] + ext[a] - o[a]) * inv;
    }
    const float largest_tmin = jmax(
        jmax(jmin(ttop[0], tbot[0]), jmin(ttop[1], tbot[1])), jmin(ttop[2], tbot[2]));
    const float smallest_tmax = jmin(
        jmin(jmax(ttop[0], tbot[0]), jmax(ttop[1], tbot[1])), jmax(ttop[2], tbot[2]));
    max_t = largest_tmin > EPS ? largest_tmin : smallest_tmax;
    nrm[0] = nrm[1] = nrm[2] = 0.0f;
    bool taken = false;
    for (int j = 0; j < 6; ++j) {
      const int a = j % 3;
      const float tpl = j < 3 ? ttop[a] : tbot[a];
      if (!taken && max_t == tpl) {
        nrm[a] = j < 3 ? 1.0f : -1.0f;
        taken = true;
      }
    }
    t = 0.0f;
    // DDA exit of the brick interior [worg, worg+16) (fast.py's fresh
    // brick-exit computation, floored at t + eps)
    float exit_t = INFINITY;
    for (int a = 0; a < 3; ++a) {
      const float up = d[a] > 0.0f ? 1.0f : 0.0f;
      const float bound_vox = (float)worg[a] + up * (float)TBRICK;
      const float bound_world = bmin[a] + ext[a] * bound_vox / rm1[a];
      const float t_axis =
          fabsf(d[a]) > 1e-12f ? (bound_world - o[a]) / d[a] : INFINITY;
      exit_t = jmin(exit_t, t_axis);
    }
    bexit = jmax(exit_t, t + epsw);
  }

  for (int a = 0; a < 3; ++a) {
    fout[(F_OX + a) * R + p] = o[a];
    fout[(F_DX + a) * R + p] = d[a];
    fout[(F_TR + a) * R + p] = tp[a];
    fout[(F_NX + a) * R + p] = nrm[a];
  }
  fout[F_T * R + p] = t;
  fout[F_MAXT * R + p] = max_t;
  fout[F_BEXIT * R + p] = bexit;
  fout[F_INVSIG * R + p] = inv_sig;
  fout[F_RHOMAX * R + p] = rho_max;
  iout[p] = bounce;
  iout[R + p] = status;
  rng_out[p] = (int64_t)rs;
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/tailpk.py).  Shapes: tab
// (NB, 4992) f32; brick (R,) i64; params (22,) f32; fin/fout (17, R) f32;
// iin (5, R) i32; iout (2, R) i32 (bounce, status); rng_in (2, R) i64
// holding uint32 (state, inc); rng_out (R,) i64.  Returns cudaGetLastError().
extern "C" int tailpk_launch(const float* tab, const int64_t* brick,
                             const float* params, const float* fin,
                             const int32_t* iin, const int64_t* rng_in,
                             float* fout, int32_t* iout, int64_t* rng_out,
                             int R, int n_steps, void* stream) {
  if (R > 0) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    tail_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        tab, brick, params, fin, iin, rng_in, fout, iout, rng_out, R, n_steps);
  }
  return (int)cudaGetLastError();
}
