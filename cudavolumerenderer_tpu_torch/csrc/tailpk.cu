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
// path leaves with status RUN / NEED_WINDOW / EXIT_BOX / DEAD, and the
// stage's service round (below) handles the rest.
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
//  * Null run (lookahead; common.cuh's jumps, run_sum and first_stop, which
//    familybody.cu's Woodcock chains share).  Between events only t changes
//    and each step draws u1, tap bits, u2.  Lane j takes draws 3j.. by PCG
//    jump-ahead (state after m draws = A_m * s + G_m * inc,
//    ops/rng.jump_constants) and makes step j: flight, crossing test, tap,
//    load, acceptance.  t_j is the plain version's left-to-right sum t +
//    step_0 + ... + step_j over the steps shared by __shfl_sync (adding -0.0
//    leaves a sum unchanged); no tree scan.  A ballot finds the first step
//    that crosses or accepts; the steps before it were null collisions.  A
//    scatter is left to:
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
//
// The tail stage as one launch (drain_kernel; host side ops/taildrain.py).
// It replaces the service loop around this kernel,
// cudavolumerenderer_tpu/models/fast.py:1421 (_run_tailpk_stage's body under
// its lax.while_loop :1604, one XLA program on the TPU), which the port runs
// eagerly as its plain version (models/fast.py plain_round): per round a few
// hundred torch ops for the service, a tail_kernel launch and a host read of
// the pending count, ~300 rounds per fastSK image.  Per lane, a round
// regenerates a finished path, runs the box entry or miss, the boundary event
// (a run's EXIT_BOX or a fresh outside hit) with bounce + 1, the cap and
// Russian roulette, and for a tracking lane refreshes the brick window
// (tpk.brick_window's arithmetic) and runs the K steps above.
//  * A warp holds one lane across rounds.  A lane's round reads only its own
//    fields (its regeneration only its pixel, slot and sample count), and a
//    lane that is no longer pending is a fixed point of the round, so each
//    lane runs its rounds to its end without waiting for another; its runs
//    need the whole warp anyway.  The service is warp-uniform, and every
//    thread computes it on the same values: the warp issues each instruction
//    once either way, so this costs no time, where lane 0 alone would need a
//    divergent branch and some twenty shuffles to hand the pose on.
//  * Counts.  Per round, the warp's lane 0 adds its lane's segment start and
//    tracking bit by atomics to integer arrays indexed by the round (one lane
//    per warp: nothing to aggregate within it).  The last block folds them in
//    float32 one round after another through E, the longest lane's rounds:
//    n_rays + starts, n_rows + R, n_busy + tracking lanes, the eager loop's
//    sums in its order.  n_rows is far above 2^24 by the tail, where adding
//    R * E at once would round differently.
//  * At most DI_CAP rounds per launch; a lane at the cap is stored with its
//    exit_box flag, and the host launches again while lanes are left
//    (common.cuh's drain_end and drain_close, ops/stages.py's drain).

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
  P_RM1X, P_RM1Y, P_RM1Z, P_MAXPATH, P_RR, P_NX, P_NY, P_NZ, N_PARAMS,
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

// The parameter vector's constants (all but the window).
__device__ __forceinline__ void load_consts(Consts& c, const float* params) {
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
  }
  c.max_path = params[P_MAXPATH];
  c.rr_on = params[P_RR] > 0.5f;
  c.epsw = jmax(jmax(c.ext[0], c.ext[1]), c.ext[2]) * 1e-6f;
}

// A path's window: the brick at voxel origin worg, its interior's faces, and
// its dilated table row.
__device__ __forceinline__ void set_window(Consts& c, const int worg[3], const float* win) {
  for (int a = 0; a < 3; ++a) {
    c.worg[a] = worg[a];
    // bmin + ext * bound_vox / rm1 with bound_vox = worg + up * 16
    const float lo = (float)c.worg[a] + 0.0f * (float)TBRICK;
    const float hi = (float)c.worg[a] + 1.0f * (float)TBRICK;
    c.plane_lo[a] = c.bmin[a] + c.ext[a] * lo / c.rm1[a];
    c.plane_hi[a] = c.bmin[a] + c.ext[a] * hi / c.rm1[a];
  }
  c.win = win;
}

// A lane's first draws in a null run (3 * lane + 1: u1, tap bits, u2 a
// step) and in a scatter run (W * lane + 1): the jump table's (A_m, G_m).
struct Jumps {
  Jump null_run, scat;
};

__device__ __forceinline__ Jumps lane_jumps(const int64_t* jump, int lane, bool rr_on) {
  const int W = rr_on ? 6 : 5;
  return Jumps{null_jump<3>(jump, JUMPS, lane), jump_of(jump, JUMPS, W * lane + 1)};
}

// Up to n_steps tracking steps of the path `cur` (status RUN) in its window,
// by the whole warp; afterwards every lane holds the path's new state.
__device__ __forceinline__ void run_path(const Consts& c, const Jumps& J, int lane, Path& cur,
                                         uint32_t inc, float inv_sig, int n_steps) {
  int run = 0;  // links of the next scatter run; 0: the next round is a null run
  int done = 0;
  while (done < n_steps && cur.status == RUN) {
    if (run == 0) {
      // ---- null run: step j on lane j, draws 3j, 3j+1, 3j+2 --------------
      const int D = min(LANES, n_steps - done);
      const uint32_t s1 = jumped(J.null_run, cur.rs, inc);
      const uint32_t s2 = pcg_next(s1, inc), s3 = pcg_next(s2, inc);
      // t + step_0 + ... + step_lane, left to right (common.cuh)
      const float tj = run_sum<LANES>(FULL, cur.t, flight(s1, inv_sig), lane, D);
      const bool crossed = tj >= jmin(cur.bexit, cur.max_t);
      const float rho = tap(c, cur.o, cur.d, tj, pcg_bits(s2));
      const bool accepted = !(c.scale * rho * inv_sig < uniform(s3));
      const int src = first_stop<LANES>(FULL, lane, D, crossed || accepted);
      if (src < 0) {  // D null collisions
        cur.t = __shfl_sync(FULL, tj, D - 1);
        cur.rs = __shfl_sync(FULL, s3, D - 1);
        done += D;
        continue;
      }
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
    const uint32_t a1 = jumped(J.scat, cur.rs, inc);  // u1
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
  load_consts(c, params);
  const int worg[3] = {iin[I_WX * R + p], iin[I_WY * R + p], iin[I_WZ * R + p]};
  set_window(c, worg, tab + brick[p] * (int64_t)TROW);

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
  run_path(c, lane_jumps(jump, lane, c.rr_on), lane, cur, inc, inv_sig, n_steps);

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

// ---- the tail stage as one drain (ops/taildrain.py) -------------------------

// Float parameters (ops/taildrain.py DF_*): the tail kernel's vector (P_*),
// then the service's: the tile and camera, the box's far corner, Le, GGX, and
// the window's epsilon as the eager stage computes it on the card.
enum {
  DF_TILEX = N_PARAMS, DF_TILEY, DF_INV_TW, DF_INV_RESX, DF_INV_RESY,
  DF_CAM,  // the camera's (3, 4) inv_view, row-major: 12 values
  DF_R2VX = DF_CAM + 12, DF_R2VY, DF_BMAX, DF_LE = DF_BMAX + 3,
  DF_ROUGH = DF_LE + 3, DF_ETA = DF_ROUGH + 2, DF_INV_ETA, DF_EPSW, N_DF,
};

// Integer parameters (ops/taildrain.py DI_*).
enum {
  DI_SPP = 0, DI_M, DI_NPIX, DI_TW, DI_BASE, DI_SEEDH, DI_BSDF, DI_MITSUBA,
  DI_RR, DI_MAXPATH, DI_NBX, DI_NBY, DI_NBZ, DI_STEPS, DI_CAP, N_DI,
};

// Pointer slots (ops/taildrain.py S_*): the FastState fields a round updates,
// read and written in place, then the stage's exit_box flags (kept across
// launches), the pixel and slot, the counters, the tables, the control words
// and the per-round counts.
enum {
  S_O = 0, S_D, S_TP, S_ACC, S_NRM, S_T, S_MAXT, S_SD, S_BOUNCE, S_ALIVE,
  S_TRACKING, S_RS, S_RINC, N_LANE,
  S_EXIT = N_LANE, S_PIX, S_SLOT, S_COUNTS, S_TAB, S_MAJOR, S_JUMP, S_CTRL,
  S_EVALS, N_S,
};

struct DrainParams {
  float f[N_DF];
  long long i[N_DI];
};
struct DrainPtrs {
  void* p[N_S];
};

// A lane of the tail pool between rounds; every thread of its warp holds it.
struct Lane {
  float o[3], d[3], tp[3], acc[3], nrm[3];
  float t, max_t;
  long long sd, bounce;
  bool alive, tracking, exit_box;
  uint32_t rs, inc;
};

__device__ __forceinline__ void load_lane(const DrainPtrs& Q, int i, Lane& L) {
  for (int k = 0; k < 3; ++k) {
    L.o[k] = ((const float*)Q.p[S_O])[3 * i + k];
    L.d[k] = ((const float*)Q.p[S_D])[3 * i + k];
    L.tp[k] = ((const float*)Q.p[S_TP])[3 * i + k];
    L.acc[k] = ((const float*)Q.p[S_ACC])[3 * i + k];
    L.nrm[k] = ((const float*)Q.p[S_NRM])[3 * i + k];
  }
  L.t = ((const float*)Q.p[S_T])[i];
  L.max_t = ((const float*)Q.p[S_MAXT])[i];
  L.sd = ((const long long*)Q.p[S_SD])[i];
  L.bounce = ((const long long*)Q.p[S_BOUNCE])[i];
  L.alive = ((const bool*)Q.p[S_ALIVE])[i];
  L.tracking = ((const bool*)Q.p[S_TRACKING])[i];
  L.exit_box = ((const bool*)Q.p[S_EXIT])[i];
  L.rs = (uint32_t)((const long long*)Q.p[S_RS])[i];
  L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
}

__device__ __forceinline__ void store_lane(const DrainPtrs& Q, int i, const Lane& L) {
  for (int k = 0; k < 3; ++k) {
    ((float*)Q.p[S_O])[3 * i + k] = L.o[k];
    ((float*)Q.p[S_D])[3 * i + k] = L.d[k];
    ((float*)Q.p[S_TP])[3 * i + k] = L.tp[k];
    ((float*)Q.p[S_ACC])[3 * i + k] = L.acc[k];
    ((float*)Q.p[S_NRM])[3 * i + k] = L.nrm[k];
  }
  ((float*)Q.p[S_T])[i] = L.t;
  ((float*)Q.p[S_MAXT])[i] = L.max_t;
  ((long long*)Q.p[S_SD])[i] = L.sd;
  ((long long*)Q.p[S_BOUNCE])[i] = L.bounce;
  ((bool*)Q.p[S_ALIVE])[i] = L.alive;
  ((bool*)Q.p[S_TRACKING])[i] = L.tracking;
  ((bool*)Q.p[S_EXIT])[i] = L.exit_box;
  ((long long*)Q.p[S_RS])[i] = (long long)L.rs;
  ((long long*)Q.p[S_RINC])[i] = (long long)L.inc;
}

// The stage loop's test: a path in flight or samples left.
__device__ __forceinline__ bool pending(const DrainParams& P, const Lane& L) {
  return L.alive || L.sd < P.i[DI_SPP];
}

// One round of the tail stage for one lane, as models/fast.py plain_round
// computes it on the card: regenerate, the AABB entry or miss, the boundary
// event (a kernel EXIT_BOX or a fresh outside hit) with bounce + 1, the cap
// and Russian roulette, then for a tracking lane the brick window
// (tpk.brick_window's arithmetic) and the run of DI_STEPS steps.  Every
// thread of the warp computes the service on the same values; the run is the
// warp's.  Returns whether the lane started a segment (n_rays); `track`
// whether it tracked (n_busy).
__device__ __forceinline__ bool tail_round(const DrainParams& P, const DrainPtrs& Q,
                                           const Consts& c0, const Jumps& J, int lane,
                                           long long pix, long long slot, Lane& L,
                                           bool& track) {
  // --- regenerate: next sample of the lane's pixel ------------------------
  if (!L.alive && L.sd < P.i[DI_SPP]) {
    const uint32_t s = (uint32_t)(slot + P.i[DI_M] * L.sd);
    const uint32_t pid = s * (uint32_t)P.i[DI_NPIX] + (uint32_t)pix + (uint32_t)P.i[DI_BASE];
    float px, py;
    pixel_of(pix, P.i[DI_TW], P.f[DF_INV_TW], P.f[DF_TILEX], P.f[DF_TILEY], px, py);
    path_stream(pid, (uint32_t)P.i[DI_SEEDH], L.rs, L.inc);
    camera_ray(P.f + DF_CAM, P.f[DF_R2VX], P.f[DF_R2VY], P.f[DF_INV_RESX], P.f[DF_INV_RESY],
               px, py, L.rs, L.inc, L.o, L.d);
    for (int k = 0; k < 3; ++k) L.tp[k] = 1.0f;
    L.alive = true;
    L.tracking = false;
    L.exit_box = false;
    L.bounce = 0;
  }

  // --- AABB entry / miss ----------------------------------------------------
  const bool need_isect = L.alive && !L.tracking && !L.exit_box;
  bool boundary_now = false;
  float dist = 0.0f;
  if (need_isect) {
    const BoxHit h = box_hit(P.f + P_BMINX, P.f + DF_BMAX, L.o, L.d);
    dist = h.dist;
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.acc[k] = L.acc[k] + L.tp[k] * P.f[DF_LE + k];
      L.sd = L.sd + 1;
      L.alive = false;
    }
    if (hit && inside) {
      L.tracking = true;
      L.t = 0.0f;
      L.max_t = h.dist;
    }
    boundary_now = hit && !inside;
    for (int k = 0; k < 3; ++k) L.nrm[k] = h.nrm[k];
  }

  // --- boundary event, bounce + 1, the cap, Russian roulette ---------------
  if (L.exit_box || boundary_now) {
    const Ggx G = {P.f[DF_ROUGH], P.f[DF_ROUGH + 1], P.f[DF_ETA], P.f[DF_INV_ETA],
                   P.i[DI_MITSUBA] != 0};
    boundary_event(P.i[DI_BSDF] != 0, G, L.nrm, boundary_now ? dist : L.max_t, L.o, L.d, L.tp,
                   L.rs, L.inc);
    L.bounce = L.bounce + 1;
    const bool capped = L.bounce >= P.i[DI_MAXPATH];
    if (capped) {
      L.alive = false;
      L.sd = L.sd + 1;
    }
    if (P.i[DI_RR] && !capped && roulette_kills(L.tp, L.rs, L.inc)) {
      L.alive = false;
      L.sd = L.sd + 1;
    }
  }

  // --- the brick window and the run of a tracking lane --------------------
  track = L.tracking;
  L.exit_box = false;
  if (!track) return need_isect;
  const float epsw = P.f[DF_EPSW];
  const long long nb[3] = {P.i[DI_NBX], P.i[DI_NBY], P.i[DI_NBZ]};
  const float tt = L.t + epsw;
  long long bi[3];
  int worg[3];
  float bound[3];
  for (int a = 0; a < 3; ++a) {
    const float p = L.o[a] + tt * L.d[a];
    const float coord = jclip((p - c0.bmin[a]) / c0.ext[a], 0.0f, 1.0f) * c0.rm1[a];
    long long b = (long long)floorf(coord * (1.0f / (float)TBRICK));
    b = b < 0 ? 0 : b;
    bi[a] = b < nb[a] - 1 ? b : nb[a] - 1;
    worg[a] = (int)(bi[a] * TBRICK);
    const float up = L.d[a] > 0.0f ? 1.0f : 0.0f;
    const float bound_vox = (float)(bi[a] * TBRICK) + up * (float)TBRICK;
    bound[a] = c0.bmin[a] + c0.ext[a] * bound_vox / c0.rm1[a];
  }
  const long long bflat = (bi[2] * nb[1] + bi[1]) * nb[0] + bi[0];
  const float rho_b = ((const float*)Q.p[S_MAJOR])[bflat];
  const float inv_sig =
      rho_b > 0.0f ? (1.0f / (c0.scale * jmax(rho_b, 1e-30f))) * 1.0f : INFINITY;
  Consts c = c0;
  set_window(c, worg, (const float*)Q.p[S_TAB] + bflat * (long long)TROW);
  Path cur;
  for (int k = 0; k < 3; ++k) {
    cur.o[k] = L.o[k];
    cur.d[k] = L.d[k];
    cur.tp[k] = L.tp[k];
    cur.nrm[k] = L.nrm[k];
  }
  cur.t = L.t;
  cur.max_t = L.max_t;
  cur.bexit = dda_exit(bound, L.o, L.d, L.t + epsw);
  cur.bounce = (int)L.bounce;
  cur.status = RUN;
  cur.rs = L.rs;
  run_path(c, J, lane, cur, L.inc, inv_sig, (int)P.i[DI_STEPS]);
  for (int k = 0; k < 3; ++k) {
    L.o[k] = cur.o[k];
    L.d[k] = cur.d[k];
    L.tp[k] = cur.tp[k];
    L.nrm[k] = cur.nrm[k];
  }
  L.t = cur.t;
  L.max_t = cur.max_t;
  L.bounce = cur.bounce;
  L.rs = cur.rs;
  if (cur.status == DEAD) {
    L.alive = false;
    L.sd = L.sd + 1;
  }
  L.exit_box = cur.status == EXIT_BOX;
  L.tracking = cur.status == RUN || cur.status == NEED_WINDOW;
  return need_isect;
}

// The tail stage: one warp per lane of the pool runs the lane's rounds until
// it is no longer pending (a fixed point of the round) or DI_CAP rounds.
// Per round the warp's lane 0 adds the lane's segment start and tracking bit
// to arrays indexed by the round; the last block folds them into n_rays,
// n_rows (+ R a round) and n_busy in float32, one round after another, as the
// eager loop adds its sums.
__global__ void __launch_bounds__(32 * WARPS) drain_kernel(DrainParams P, DrainPtrs Q, int R) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned* per_round = (unsigned*)Q.p[S_EVALS];  // [isect: cap][busy: cap]
  const long long cap = P.i[DI_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + threadIdx.x / 32;
  int j = 0;  // this lane's rounds in this launch
  bool left = false, finished = false;
  if (p < R) {
    Lane L;
    load_lane(Q, p, L);
    if (pending(P, L)) {
      Consts c;
      load_consts(c, P.f);
      const Jumps J = lane_jumps((const int64_t*)Q.p[S_JUMP], lane, c.rr_on);
      const long long pix = ((const long long*)Q.p[S_PIX])[p];
      const long long slot = ((const long long*)Q.p[S_SLOT])[p];
      do {
        bool track;
        const bool isect = tail_round(P, Q, c, J, lane, pix, slot, L, track);
        if (lane == 0 && isect) atomicAdd(per_round + j, 1u);
        if (lane == 0 && track) atomicAdd(per_round + cap + j, 1u);
        ++j;
      } while (j < cap && pending(P, L));
      if (lane == 0) store_lane(Q, p, L);
      // a lane counts once, by its warp's lane 0
      left = lane == 0 && pending(P, L);
      finished = lane == 0 && !pending(P, L);
    }
  }
  DrainEnd end;
  if (!drain_end(ctrl, e0, 1, j, left, finished, end)) return;
  // the last block: every lane's counts are in.  The rounds of this launch
  // that the loop makes: all of them while a lane is left, else up to E
  const long long n_fold = end.left == 0 ? end.total - e0 : cap;
  float* counts = (float*)Q.p[S_COUNTS];
  float rays = counts[0], rows = counts[1], busy = counts[2];
  const float w = (float)R;
  for (long long e = 0; e < n_fold; ++e) {
    rays = rays + (float)__ldcg(per_round + e);
    rows = rows + w;
    busy = busy + (float)__ldcg(per_round + cap + e);
  }
  counts[0] = rays;
  counts[1] = rows;
  counts[2] = busy;
  for (long long e = 0; e < end.jmax; ++e) per_round[e] = per_round[cap + e] = 0u;
  drain_close(ctrl, e0, cap, end.left);
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

// drain_kernel, one warp per lane (taildrain_drain): fparams (N_DF,) float32,
// iparams (N_DI,) int64 and ptrs (N_S,) device addresses in host memory, R
// lanes; the control words zero at the stage's start, the per-round counts
// (2 * DI_CAP uint32) zero before each launch (each launch leaves them zero).
// Returns cudaGetLastError(), or -1 when a size does not match this build's.
extern "C" int taildrain_drain(const float* fparams, int n_fp, const long long* iparams,
                               int n_ip, void* const* ptrs, int n_s, int R, void* stream) {
  if (n_fp != N_DF || n_ip != N_DI || n_s != N_S) return -1;
  if (R <= 0) return 0;
  DrainParams P;
  for (int k = 0; k < N_DF; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < N_DI; ++k) P.i[k] = iparams[k];
  DrainPtrs Q;
  for (int k = 0; k < N_S; ++k) Q.p[k] = ptrs[k];
  const int blocks = (R + WARPS - 1) / WARPS;
  drain_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(P, Q, R);
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_DF, N_DI, N_S, N_CTRL), for the
// wrapper's check.
extern "C" void taildrain_layout(int* sizes) {
  sizes[0] = N_DF;
  sizes[1] = N_DI;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
