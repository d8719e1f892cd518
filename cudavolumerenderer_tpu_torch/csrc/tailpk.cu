// tailpk.cu — persistent tail kernel of the fastSK cascade, for Hopper (sm_90a).
//
// Replaces cudavolumerenderer_tpu/ops/pallas/tailpk.py:make_tail_kernel (the
// Pallas TPU kernel jitted by run_tail_steps).  It computes what that kernel
// and the plain version ops/tailpk.tail_steps compute, bit for bit: for each
// deep path, K whole Woodcock steps inside the path's dilated 16^3 brick
// window (17^3 voxels) — a flight draw under the brick's dilated majorant, a
// 30-bit stochastic-trilinear tap, the acceptance test, and on a scatter the
// HG direction, albedo A*rho+B, bounce+1, the path cap and Russian roulette,
// then the re-derived box exit (aabb tie-break order) and DDA brick exit.  A
// path leaves with status RUN / NEED_WINDOW / EXIT_BOX / DEAD, and the torch
// service loop (models/fast.py _run_tailpk_stage) handles the rest.
//
// What bounds it on this card: the latency of each path's chain of steps,
// not bytes.  A call moves 196 bytes of state per path plus the table words
// its taps read (ops/tailpk.tail_bytes: 25 KB at R = 128, 0.008 us at 3.35
// TB/s), and it lasts as long as its longest path.  The first design (one
// thread per path, one step after another) took 3.3 us at K = 1 and 19.2 us
// at K = 16 on the H100 (R = 128, chip_smoke.py phase 3): about 1.1 us per
// step, most of it a scatter's long chain of dependent IEEE math (logf,
// sinf/cosf, square roots and a dozen and more divisions) run by one
// thread.  In the fastSK slice the longest path of a call scatters at
// nearly every one of its 16 steps.
//
// The design: one warp per path, and two kinds of round that each cover
// many steps, because a path's next draws are known before its steps are.
//  * Null run (lookahead).  Between events only t changes and each step
//    draws u1, tap bits, u2.  Lane j takes draws 3j.. by PCG jump-ahead
//    (state after m draws = A_m * s + G_m * inc, ops/rng.jump_constants)
//    and makes step j: flight, crossing test, tap, load, acceptance.  t_j is
//    the plain version's left-to-right sum t + step_0 + ... + step_j over
//    the steps shared by __shfl_sync (adding -0.0 leaves a sum unchanged);
//    no tree scan.  A ballot finds the first step that crosses or accepts;
//    the steps before it were null collisions.  A scatter is left to:
//  * Scatter run.  Lane k takes step k as if steps 0..k-1 all scattered and
//    survived: each such step draws u1, tap bits, u2, e1, e2 and, with RR
//    on, the RR uniform, so lane k starts at draw W*k (W = 6 or 5).  Each
//    lane computes its own flight length and HG angles; a chain over the
//    links, the same on every lane, carries the pose (a square root and a
//    division per link), then every lane computes its segment's box and DDA
//    exits, crossing test, tap, load and acceptance at once, and a second
//    chain carries the throughput through albedo, the cap and Russian
//    roulette.  A ballot finds the first link that did not scatter and
//    survive; the path takes that lane's state.  A run starts at 16 links
//    (the slice's K) and doubles while every link scatters.
//  A run of n nulls or of n scatters thus costs one round of mostly parallel
//  work instead of n serial steps.  Its times on the H100 beside the first
//  design's are in PERF.md (chip_smoke.py phases 3 and 5).
//  * Windows are not staged in shared memory: phase 3's taps read 76
//    distinct words, and 4,096 windows (82 MB) would take about the first
//    design's whole call to copy.
//  * A warp holds one path, not two of 16 lanes: runs reach 32 steps (null
//    runs, and scatter runs after doubling), and at the slice's R = 128 the
//    128 warps leave most of the card's schedulers free.  Two warps per
//    block spread them over 64 SMs; one or four per block time the same.
//
// Float math follows the plain version operation by operation: built without
// --use_fast_math and with -fmad=false, so logf/sinf/cosf/sqrtf and division
// stay IEEE-accurate and no multiply-add is contracted; min/max propagate NaN
// like torch.minimum/maximum.  The kernel allocates nothing and does not
// synchronise.

#include "common.cuh"

namespace {

using namespace cvr;

constexpr int TBRICK = 16;
constexpr int TDIL = TBRICK + 1;  // 17
constexpr int TROW = 4992;        // 39 * 128: one dilated brick, zero-padded
constexpr int LANES = 32;         // steps a round covers at most: a warp per path
constexpr int JUMPS = 6 * LANES + 1;  // jump-table entries, m = 0 .. 6 * LANES
constexpr int FIRST_RUN = 16;     // links of a scatter run after a null run
constexpr int WARPS = 2;          // paths (warps) per block
constexpr unsigned FULL = 0xffffffffu;

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

struct Consts {
  float scale, g, A[3], B[3], bmin[3], bmax[3], ext[3], rm1[3], max_path, epsw;
  float plane_lo[3], plane_hi[3];  // the brick interior's faces per axis
  bool rr_on;
  int ngrid[3], worg[3];
  const float* win;
};

// Stochastic-trilinear tap at o + t d (bits: the tap draw), clipped into
// the window, so every lane may load it.
__device__ __forceinline__ float tap(const Consts& c, const float o[3],
                                     const float d[3], float t, uint32_t bits) {
  int local[3];
  for (int a = 0; a < 3; ++a) {
    const float pa = o[a] + t * d[a];
    const float x = jclip((pa - c.bmin[a]) / c.ext[a], 0.0f, 1.0f) * c.rm1[a];
    const float u = (float)((bits >> (10 * a)) & 0x3FFu) * (1.0f / 1024.0f);
    const float f = floorf(x);
    const int vox = iclip((int)f + (u < x - f ? 1 : 0), 0, c.ngrid[a] - 1);
    local[a] = iclip(vox - c.worg[a], 0, TDIL - 1);
  }
  return __ldg(c.win + (local[2] * TDIL + local[1]) * TDIL + local[0]);
}

// A new segment from pose (o, d) at t = 0: the box exit and face normal
// (ops/aabb.aabb_intersect semantics; normal picked in the order
// +x,+y,+z,-x,-y,-z among planes at t == dist), and the DDA exit of the
// brick interior [worg, worg+16) floored at t + eps (fast.py's fresh
// brick-exit computation).
__device__ __forceinline__ void segment(const Consts& c, const float o[3],
                                        const float d[3], float& max_t,
                                        float nrm[3], float& bexit) {
  const BoxHit h = box_hit(c.bmin, c.bmax, o, d);
  max_t = h.dist;
  for (int a = 0; a < 3; ++a) nrm[a] = h.nrm[a];
  float bound[3];
  for (int a = 0; a < 3; ++a) bound[a] = d[a] > 0.0f ? c.plane_hi[a] : c.plane_lo[a];
  bexit = dda_exit(bound, o, d, 0.0f + c.epsw);
}

// A path's state between rounds; every lane of its warp holds a copy.
struct Path {
  float o[3], d[3], tp[3], nrm[3];
  float t, max_t, bexit;
  int bounce, status;
  uint32_t rs;  // PCG state
};

__device__ __forceinline__ Path from_lane(const Path& x, int src) {
  Path y;
  for (int a = 0; a < 3; ++a) {
    y.o[a] = __shfl_sync(FULL, x.o[a], src);
    y.d[a] = __shfl_sync(FULL, x.d[a], src);
    y.tp[a] = __shfl_sync(FULL, x.tp[a], src);
    y.nrm[a] = __shfl_sync(FULL, x.nrm[a], src);
  }
  y.t = __shfl_sync(FULL, x.t, src);
  y.max_t = __shfl_sync(FULL, x.max_t, src);
  y.bexit = __shfl_sync(FULL, x.bexit, src);
  y.bounce = __shfl_sync(FULL, x.bounce, src);
  y.status = __shfl_sync(FULL, x.status, src);
  y.rs = __shfl_sync(FULL, x.rs, src);
  return y;
}

__global__ void __launch_bounds__(32 * WARPS) tail_kernel(
    const float* __restrict__ tab, const int64_t* __restrict__ brick,
    const float* __restrict__ params, const int64_t* __restrict__ jump,
    const float* __restrict__ fin, const int32_t* __restrict__ iin,
    const int64_t* __restrict__ rng_in, float* __restrict__ fout,
    int32_t* __restrict__ iout, int64_t* __restrict__ rng_out, int R,
    int n_steps) {
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + threadIdx.x / 32;
  if (p >= R) return;  // the whole warp leaves together

  Consts c;
  c.scale = params[P_SCALE];
  c.g = params[P_G];
  for (int a = 0; a < 3; ++a) {
    c.A[a] = params[P_AR + a];
    c.B[a] = params[P_BR + a];
    c.bmin[a] = params[P_BMINX + a];
    c.ext[a] = params[P_EXTX + a];
    c.rm1[a] = params[P_RM1X + a];
    c.bmax[a] = c.bmin[a] + c.ext[a];
    c.ngrid[a] = (int)params[P_NX + a];
    c.worg[a] = iin[(I_WX + a) * R + p];
    // bmin + ext * bound_vox / rm1 with bound_vox = worg + up * 16
    const float lo = (float)c.worg[a] + 0.0f * (float)TBRICK;
    const float hi = (float)c.worg[a] + 1.0f * (float)TBRICK;
    c.plane_lo[a] = c.bmin[a] + c.ext[a] * lo / c.rm1[a];
    c.plane_hi[a] = c.bmin[a] + c.ext[a] * hi / c.rm1[a];
  }
  c.max_path = params[P_MAXPATH];
  c.rr_on = params[P_RR] > 0.5f;
  c.epsw = jmax(jmax(c.ext[0], c.ext[1]), c.ext[2]) * 1e-6f;
  c.win = tab + brick[p] * (int64_t)TROW;

  Path cur;
  for (int a = 0; a < 3; ++a) {
    cur.o[a] = fin[(F_OX + a) * R + p];
    cur.d[a] = fin[(F_DX + a) * R + p];
    cur.tp[a] = fin[(F_TR + a) * R + p];
    cur.nrm[a] = fin[(F_NX + a) * R + p];
  }
  cur.t = fin[F_T * R + p];
  cur.max_t = fin[F_MAXT * R + p];
  cur.bexit = fin[F_BEXIT * R + p];
  cur.bounce = iin[I_BOUNCE * R + p];
  cur.status = iin[I_STATUS * R + p];
  cur.rs = (uint32_t)rng_in[p];
  const uint32_t inc = (uint32_t)rng_in[R + p];
  const float inv_sig = fin[F_INVSIG * R + p];
  const float rho_max = fin[F_RHOMAX * R + p];
  // this lane's first draw in a null run (3 * lane + 1) and in a scatter
  // run (W * lane + 1)
  const int W = c.rr_on ? 6 : 5;
  const uint32_t null_a = (uint32_t)jump[3 * lane + 1];
  const uint32_t null_g = (uint32_t)jump[JUMPS + 3 * lane + 1];
  const uint32_t scat_a = (uint32_t)jump[W * lane + 1];
  const uint32_t scat_g = (uint32_t)jump[JUMPS + W * lane + 1];

  int run = 0;  // links of the next scatter run; 0: the next round is a null run
  int done = 0;
  while (done < n_steps && cur.status == RUN) {
    if (run == 0) {
      // ---- null run: step j on lane j, draws 3j, 3j+1, 3j+2 --------------
      const int D = min(LANES, n_steps - done);
      const uint32_t s1 = null_a * cur.rs + null_g * inc;
      const uint32_t s2 = pcg_next(s1, inc), s3 = pcg_next(s2, inc);
      const float step = flight(s1, inv_sig);
      float tj = cur.t;  // t + step_0 + ... + step_lane, left to right
      for (int i = 0; i < D; ++i) {
        const float si = __shfl_sync(FULL, step, i);
        tj = tj + (i <= lane ? si : -0.0f);
      }
      const bool crossed = tj >= jmin(cur.bexit, cur.max_t);
      const float rho = tap(c, cur.o, cur.d, tj, pcg_bits(s2));
      const bool accepted = !(c.scale * rho * inv_sig < uniform(s3));
      const unsigned events = __ballot_sync(FULL, lane < D && (crossed || accepted));
      if (events == 0) {  // D null collisions
        cur.t = __shfl_sync(FULL, tj, D - 1);
        cur.rs = __shfl_sync(FULL, s3, D - 1);
        done += D;
        continue;
      }
      const int src = __ffs(events) - 1;
      if (__shfl_sync(FULL, (int)crossed, src)) {
        // lands on the exit plane; EXIT_BOX parks at max_t
        const bool box_closer = cur.max_t <= cur.bexit;
        cur.status = box_closer ? EXIT_BOX : NEED_WINDOW;
        cur.t = box_closer ? cur.max_t : cur.bexit;
        cur.rs = __shfl_sync(FULL, s1, src);
        break;
      }
      // a scatter at step src: move past the nulls before it (to draw 3 src
      // and t_{src-1}) and take it in a scatter run
      const float t_before = __shfl_sync(FULL, tj, max(src - 1, 0));
      const uint32_t s_before = __shfl_sync(FULL, s3, max(src - 1, 0));
      if (src > 0) {
        cur.t = t_before;
        cur.rs = s_before;
      }
      done += src;
      run = FIRST_RUN;
      continue;
    }

    // ---- scatter run: link k on lane k assumes links 0..k-1 scattered ----
    const int C = min(run, n_steps - done);
    const uint32_t a1 = scat_a * cur.rs + scat_g * inc;  // u1
    const uint32_t a2 = pcg_next(a1, inc), a3 = pcg_next(a2, inc);  // tap, u2
    const uint32_t a4 = pcg_next(a3, inc), a5 = pcg_next(a4, inc);  // e1, e2
    const uint32_t a6 = pcg_next(a5, inc);                          // RR
    const float step = flight(a1, inv_sig);
    float cos_th, sin_th;
    hg(c.g, uniform(a4), cos_th, sin_th);
    const float phi = TWO_PI_F * uniform(a5);
    const float hx = sin_th * cosf(phi), hy = sin_th * sinf(phi);

    // the pose chain: my link's pose before and after its scatter
    float po[3], pd[3], mo[3], md[3], no[3], nd[3], mt = 0.0f;
    for (int a = 0; a < 3; ++a) {
      po[a] = cur.o[a];
      pd[a] = cur.d[a];
    }
    for (int j = 0; j < C; ++j) {
      const float sj = __shfl_sync(FULL, step, j);
      const float tl = j == 0 ? cur.t + sj : 0.0f + sj;
      float q[3];
      turn(pd, __shfl_sync(FULL, hx, j), __shfl_sync(FULL, hy, j),
           __shfl_sync(FULL, cos_th, j), q);
      float oq[3];
      for (int a = 0; a < 3; ++a) oq[a] = po[a] + pd[a] * tl - pd[a] * EPS;
      if (j == lane) {
        for (int a = 0; a < 3; ++a) {
          mo[a] = po[a];
          md[a] = pd[a];
          no[a] = oq[a];
          nd[a] = q[a];
        }
        mt = tl;
      }
      for (int a = 0; a < 3; ++a) {
        po[a] = oq[a];
        pd[a] = q[a];
      }
    }

    // the segment my link flies in: the current one for link 0, else the
    // one link k-1's scatter started (lane k-1's `post`)
    float post_max_t, post_nrm[3], post_bexit;
    segment(c, no, nd, post_max_t, post_nrm, post_bexit);
    // (every lane shuffles: a __shfl_sync skipped by one lane of FULL hangs)
    const float up_max_t = __shfl_up_sync(FULL, post_max_t, 1);
    const float up_bexit = __shfl_up_sync(FULL, post_bexit, 1);
    const float pre_max_t = lane == 0 ? cur.max_t : up_max_t;
    const float pre_bexit = lane == 0 ? cur.bexit : up_bexit;
    float pre_nrm[3];
    for (int a = 0; a < 3; ++a) {
      const float up = __shfl_up_sync(FULL, post_nrm[a], 1);
      pre_nrm[a] = lane == 0 ? cur.nrm[a] : up;
    }
    const bool crossed = mt >= jmin(pre_bexit, pre_max_t);
    const float rho = tap(c, mo, md, mt, pcg_bits(a2));
    const bool accepted = !(c.scale * rho * inv_sig < uniform(a3));

    // the throughput chain up to the first link that surely does not scatter
    const unsigned stops = __ballot_sync(FULL, lane < C && (crossed || !accepted));
    const int last = stops ? __ffs(stops) - 1 : C - 1;
    float tpc[3], pre_tp[3], tpa[3], tps[3];
    bool capped = false, killed = false;
    for (int a = 0; a < 3; ++a) tpc[a] = pre_tp[a] = tpa[a] = tps[a] = cur.tp[a];
    const float u_rr = uniform(a6);
    for (int j = 0; j <= last; ++j) {
      const float rj = __shfl_sync(FULL, rho, j);
      const float uj = __shfl_sync(FULL, u_rr, j);
      float ta[3], ts[3];
      for (int a = 0; a < 3; ++a) ts[a] = ta[a] = tpc[a] * (c.A[a] * rj + c.B[a]);
      const bool capj = (float)(cur.bounce + j + 1) >= c.max_path;
      bool killj = false;
      if (c.rr_on) {  // path-length cap, then Russian roulette (body() order)
        const float p_surv = jmin(1.0f, jmax(jmax(ta[0], ta[1]), ta[2]));
        killj = !capj && uj > p_surv;
        const float inv_p = 1.0f / jmax(p_surv, 1e-20f);
        for (int a = 0; a < 3; ++a) ts[a] = ta[a] * inv_p;
      }
      if (j == lane) {
        for (int a = 0; a < 3; ++a) {
          pre_tp[a] = tpc[a];
          tpa[a] = ta[a];
          tps[a] = ts[a];
        }
        capped = capj;
        killed = killj;
      }
      for (int a = 0; a < 3; ++a) tpc[a] = ts[a];
    }

    // the path's state if my link were the round's last
    const bool scattered = !crossed && accepted;
    const bool survived = scattered && !capped && !killed;
    Path nx = cur;
    nx.bounce = cur.bounce + lane + (scattered ? 1 : 0);
    for (int a = 0; a < 3; ++a) {
      nx.o[a] = scattered ? no[a] : mo[a];
      nx.d[a] = scattered ? nd[a] : md[a];
      nx.tp[a] = survived ? tps[a] : (scattered ? tpa[a] : pre_tp[a]);
      nx.nrm[a] = survived ? post_nrm[a] : pre_nrm[a];
    }
    nx.max_t = survived ? post_max_t : pre_max_t;
    nx.bexit = survived ? post_bexit : pre_bexit;
    if (survived) {  // a new segment starts
      nx.t = 0.0f;
      nx.rs = c.rr_on ? a6 : a5;
    } else if (scattered) {  // died at the cap or by Russian roulette
      nx.status = DEAD;
      nx.t = mt;
      nx.rs = capped ? a5 : a6;
    } else if (crossed) {  // lands on the exit plane; EXIT_BOX parks at max_t
      const bool box_closer = pre_max_t <= pre_bexit;
      nx.status = box_closer ? EXIT_BOX : NEED_WINDOW;
      nx.t = box_closer ? pre_max_t : pre_bexit;
      nx.rs = a1;
    } else {  // null collision
      nx.t = mt;
      nx.rs = a3;
    }
    const unsigned ends = __ballot_sync(FULL, lane < C && !survived);
    const int src = ends ? __ffs(ends) - 1 : C - 1;
    cur = from_lane(nx, src);
    done += src + 1;
    // keep running scatters (twice as far) while every link scattered
    run = ends ? 0 : min(2 * run, LANES);
  }

  if (lane == 0) {
    for (int a = 0; a < 3; ++a) {
      fout[(F_OX + a) * R + p] = cur.o[a];
      fout[(F_DX + a) * R + p] = cur.d[a];
      fout[(F_TR + a) * R + p] = cur.tp[a];
      fout[(F_NX + a) * R + p] = cur.nrm[a];
    }
    fout[F_T * R + p] = cur.t;
    fout[F_MAXT * R + p] = cur.max_t;
    fout[F_BEXIT * R + p] = cur.bexit;
    fout[F_INVSIG * R + p] = inv_sig;
    fout[F_RHOMAX * R + p] = rho_max;
    iout[p] = cur.bounce;
    iout[R + p] = cur.status;
    rng_out[p] = (int64_t)cur.rs;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/tailpk.py).  Shapes: tab
// (NB, 4992) f32; brick (R,) i64; params (22,) f32; jump (2, 193) i64
// holding uint32 (ops/rng.jump_constants(192)); fin/fout (17, R) f32; iin
// (5, R) i32; iout (2, R) i32 (bounce, status); rng_in (2, R) i64 holding
// uint32 (state, inc); rng_out (R,) i64.  Returns cudaGetLastError().
extern "C" int tailpk_launch(const float* tab, const int64_t* brick,
                             const float* params, const int64_t* jump,
                             const float* fin, const int32_t* iin,
                             const int64_t* rng_in, float* fout, int32_t* iout,
                             int64_t* rng_out, int R, int n_steps,
                             void* stream) {
  if (R > 0) {
    const int blocks = (R + WARPS - 1) / WARPS;
    tail_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        tab, brick, params, jump, fin, iin, rng_in, fout, iout, rng_out, R,
        n_steps);
  }
  return (int)cudaGetLastError();
}
