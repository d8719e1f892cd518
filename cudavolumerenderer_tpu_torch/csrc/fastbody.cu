// fastbody.cu — one evaluation of fastSK's wavefront body for every lane of a
// pool, for Hopper (sm_90a).
//
// Replaces the body of cudavolumerenderer_tpu/models/fast.py:744 (render_tile's
// `body`, which XLA compiled into one device program under the cascade's
// lax.while_loop; it is no Pallas kernel).  It computes what the port's eager
// body (models/fast.py, render_tile's `body`, the plain version) computes on
// the card, bit for bit, in each of its modes: per lane,
//   0. under defer_ggx = G > 0, at an evaluation whose round(n_rows / width)
//      % G == 0 (n_rows before it, the float32 division and the round half
//      to even of render_tile's step), the deferred boundary event of a
//      pending lane (flush_boundary): the event at o + d * max_t, bounce + 1,
//      the path cap, Russian roulette, and pend_b cleared;
//   1. regenerate a finished lane: a fresh PCG stream from (seed, path id of
//      pixel, slot, samples done), a jittered camera ray (2 draws);
//   2. the AABB slab test of a lane that starts a segment (under defer_ggx
//      not while its event waits): a miss adds throughput * Le to the lane's
//      accumulator and ends the sample; an inside hit starts tracking; an
//      outside hit is a boundary event now;
//   3. one tracking step: two-level (brick probe with the Chebyshev leap, a
//      flight under the brick's majorant, the crossing test, a 30-bit
//      stochastic-trilinear tap and the acceptance test) or single-level
//      (under the global majorant); or, at spec_k = K > 1, K speculative
//      steps from the same point (speculate): K flight draws, then the tap
//      draws and then the acceptance draws of the valid candidates, the
//      prefix kept up to the first acceptance or invalid candidate;
//   4. the tap's density from the flat f32 table, the 'full' rows, or the
//      packed 8/4-bit words, row-major or brick-major, and on a scatter its
//      albedo (constant, affine in density, the row's, or under 'split' the
//      scene's albedo grid at the tap);
//   5. a boundary event: GGX (both visible-normal samplers) or the null BSDF,
//      or under defer_ggx its distance kept in max_t and pend_b set;
//   6. an HG scatter with the tap's albedo;
//   7. the path-length cap, then Russian roulette;
//   8. the pool's counts: segment starts and tracking lanes, added in float32
//      to n_rays and n_busy as the eager body adds its sums, n_rows + width,
//      and the pending count (alive or samples left) for the host's loop.
// Every draw is taken only under the eager body's mask, so each path's stream
// is the plain version's.
//
// Three launches run the body (ops/fastbody.py):
//   * body_kernel, one evaluation of every lane (run_body): one thread per
//     lane, the state read and written in place in the FastState tensors as
//     they are (SoA, int64 words holding the u32 RNG).  The counts reduce per
//     block with __syncthreads_count and across blocks with atomics; the last
//     block to finish writes them and clears the scratch, so one launch is one
//     evaluation.  What bounds it: bytes, ~236 B of state per lane plus a 32 B
//     sector of the density table and an 8 B brick row, ~71 MB per
//     evaluation of a 262,144-lane pool, 21 us at 3.35 TB/s.
//   * body_kernel gated (a stage whose loop exits at a pending count > 0):
//     the host enqueues a stage's evaluations in batches without reading
//     back; each launch first reads the stage's control words (the
//     evaluation index and the last pending count) and returns untouched
//     when the loop would have stopped there: at an index that starts a
//     chain, with the pending count at or under the threshold.  The last
//     block advances the index and leaves the new pending count.
//   * drain_kernel (the last stage with no tail kernel: the loop exits at a
//     pending count of 0, so no lane waits for another): each thread loads
//     its lane once, runs evaluations in registers until the lane is no
//     longer pending (a non-pending lane is a fixed point of the body, and
//     adds nothing to the counts) or a cap is reached, and stores it once.
//     Per evaluation, segment starts and tracking lanes go by warp-
//     aggregated integer atomics into arrays indexed by the evaluation, and
//     the last block folds them into n_rays, n_rows and n_busy in float32,
//     one evaluation after another, through E = k_chain * ceil(L / k_chain)
//     evaluations (L: the longest lane's), the same sums in the same order
//     as the loop's.  It is bound by the longest lane's chain of dependent
//     evaluations, not by bytes; small blocks spread a narrow pool over the
//     SMs.
// Every mode is a uniform runtime branch; a state layout of its own is
// later work.  The speculative steps keep no per-candidate array (any K up
// to IP_SPEC's limit): a first pass over the flight draws finds the valid
// prefix, a second re-derives each candidate from the saved stream while the
// tap and acceptance draws come from two streams n_v draws apart, and issues
// the table loads of SPEC_BATCH candidates before their acceptance tests
// (they do not depend on each other; that is the point of the mode).  The
// deferred flush keeps lanes independent: the flag is a function of the
// evaluation's n_rows alone, which a drain thread carries in registers.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;

// Float parameters (ops/fastbody.py FP_*).
enum {
  FP_TILEX = 0, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY,
  FP_CAM,  // the camera's (3, 4) inv_view, row-major: 12 values
  FP_R2VX = FP_CAM + 12, FP_R2VY,
  FP_BMIN, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3, FP_RM1 = FP_EXT + 3,
  FP_SCALE = FP_RM1 + 3, FP_INV_SIGMAT, FP_G, FP_LE,
  FP_ALB_A = FP_LE + 3, FP_ALB_B = FP_ALB_A + 3,
  FP_QSCALE = FP_ALB_B + 3, FP_EPSW, FP_BSIZE,
  FP_ROUGH = FP_BSIZE + 3, FP_ETA = FP_ROUGH + 2, FP_INV_ETA, N_FP,
};

// Integer parameters (ops/fastbody.py IP_*).
enum {
  IP_SPP = 0, IP_M, IP_NPIX, IP_TW, IP_MULTI, IP_BASE, IP_SEEDH,
  IP_NX, IP_NY, IP_NZ, IP_TWO_LEVEL, IP_TABLE, IP_BITS, IP_BRICK_MAJOR,
  IP_ALBEDO, IP_ALB_STRIDE, IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH,
  IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ,
  IP_THRESH, IP_CHAIN, IP_CAP,  // a stage's exit threshold, chain, drain cap
  IP_SPEC,    // Woodcock steps per evaluation (spec_k)
  IP_DEFER,   // defer_ggx: the flush's period, 0 for inline boundary events
  N_IP,
};

// Pointer slots (ops/fastbody.py S_*): the 16 per-lane fields the body
// updates (pend_b read and written only under defer_ggx), then the read-only
// ones, the outputs (the 16 fields again, the counts, the pending count, the
// scratch), the tables, and a stage's control words and per-evaluation
// counts (null for one evaluation).
enum {
  S_O = 0, S_D, S_TP, S_ACC, S_NRM, S_T, S_MAXT, S_BEXIT, S_ISL, S_SD,
  S_BOUNCE, S_ALIVE, S_TRACKING, S_RS, S_RINC, S_PEND,
  N_LANE,
  S_PIX = N_LANE, S_SLOT, S_NRAYS, S_NROWS, S_NBUSY,
  S_OUT, S_COUNTS = S_OUT + N_LANE, S_PENDING, S_SCRATCH,
  S_TABLE, S_ALB_ROWS, S_BTAB, S_TILE_OFF, S_BASES, S_CTRL, S_EVALS, N_S,
};

// Table modes (IP_TABLE), albedo modes (IP_ALBEDO).
enum { TAB_F32 = 0, TAB_ROWS = 1, TAB_PACKED = 2 };
enum { ALB_CONST = 0, ALB_AFFINE = 1, ALB_ROW = 2, ALB_SPLIT = 3 };
static_assert(TAB_F32 == FUSED_F32 && TAB_ROWS == FUSED_ROWS && TAB_PACKED == FUSED_PACKED,
              "common.cuh's fused layouts");
static_assert(ALB_CONST == ALBEDO_CONST && ALB_AFFINE == ALBEDO_AFFINE &&
                  ALB_ROW == ALBEDO_ROW && ALB_SPLIT == ALBEDO_SPLIT,
              "common.cuh's albedo modes");

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// ---- tables -------------------------------------------------------------

// The flat table index of the stochastic tap at o + t d (bits: the tap draw).
__device__ __forceinline__ long long tap_index(const Params& P, const float o[3],
                                               const float d[3], float t, uint32_t bits) {
  return tap_flat(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RM1, P.i + IP_NX,
                  P.i[IP_BRICK_MAJOR] != 0, o, d, t, bits);
}

// The tap's density (the fused table's rho).
__device__ __forceinline__ float tap_rho(const Params& P, const Ptrs& Q, long long j) {
  return fused_rho(Q.p[S_TABLE], (int)P.i[IP_TABLE], (int)P.i[IP_BITS], P.f[FP_QSCALE], j);
}

// The scatter albedo of an accepted tap (tap_albedo / fused_row_decode).
__device__ __forceinline__ void tap_albedo(const Params& P, const Ptrs& Q, long long j,
                                           float rho, float alb[3]) {
  fused_albedo((int)P.i[IP_ALBEDO], P.f + FP_ALB_A, P.f + FP_ALB_B, Q.p[S_TABLE],
               (const float*)Q.p[S_ALB_ROWS], P.i[IP_ALB_STRIDE], j, rho, alb);
}

// ---- the body -------------------------------------------------------------

// One lane's state, in registers.
struct Lane {
  float o[3], d[3], tp[3], acc[3], nrm[3];
  float t, max_t, bexit, isl;
  long long sd, bounce, pix, slot;
  bool alive, tracking, pend;
  uint32_t rs, inc;
};

__device__ __forceinline__ void load_lane(const Params& P, const Ptrs& Q, int i, Lane& L) {
  const float* fo = (const float*)Q.p[S_O];
  const float* fd = (const float*)Q.p[S_D];
  const float* ftp = (const float*)Q.p[S_TP];
  const float* facc = (const float*)Q.p[S_ACC];
  const float* fnrm = (const float*)Q.p[S_NRM];
  for (int k = 0; k < 3; ++k) {
    L.o[k] = fo[3 * i + k];
    L.d[k] = fd[3 * i + k];
    L.tp[k] = ftp[3 * i + k];
    L.acc[k] = facc[3 * i + k];
    L.nrm[k] = fnrm[3 * i + k];
  }
  L.t = ((const float*)Q.p[S_T])[i];
  L.max_t = ((const float*)Q.p[S_MAXT])[i];
  L.bexit = ((const float*)Q.p[S_BEXIT])[i];
  L.isl = ((const float*)Q.p[S_ISL])[i];
  L.sd = ((const long long*)Q.p[S_SD])[i];
  L.bounce = ((const long long*)Q.p[S_BOUNCE])[i];
  L.alive = ((const bool*)Q.p[S_ALIVE])[i];
  L.tracking = ((const bool*)Q.p[S_TRACKING])[i];
  L.rs = (uint32_t)((const long long*)Q.p[S_RS])[i];
  L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
  L.pix = ((const long long*)Q.p[S_PIX])[i];
  L.slot = ((const long long*)Q.p[S_SLOT])[i];
  L.pend = P.i[IP_DEFER] > 0 && ((const bool*)Q.p[S_PEND])[i];
}

__device__ __forceinline__ void store_lane(const Params& P, const Ptrs& Q, int i,
                                           const Lane& L) {
  float* go = (float*)Q.p[S_OUT + S_O];
  float* gd = (float*)Q.p[S_OUT + S_D];
  float* gtp = (float*)Q.p[S_OUT + S_TP];
  float* gacc = (float*)Q.p[S_OUT + S_ACC];
  float* gnrm = (float*)Q.p[S_OUT + S_NRM];
  for (int k = 0; k < 3; ++k) {
    go[3 * i + k] = L.o[k];
    gd[3 * i + k] = L.d[k];
    gtp[3 * i + k] = L.tp[k];
    gacc[3 * i + k] = L.acc[k];
    gnrm[3 * i + k] = L.nrm[k];
  }
  ((float*)Q.p[S_OUT + S_T])[i] = L.t;
  ((float*)Q.p[S_OUT + S_MAXT])[i] = L.max_t;
  ((float*)Q.p[S_OUT + S_BEXIT])[i] = L.bexit;
  ((float*)Q.p[S_OUT + S_ISL])[i] = L.isl;
  ((long long*)Q.p[S_OUT + S_SD])[i] = L.sd;
  ((long long*)Q.p[S_OUT + S_BOUNCE])[i] = L.bounce;
  ((bool*)Q.p[S_OUT + S_ALIVE])[i] = L.alive;
  ((bool*)Q.p[S_OUT + S_TRACKING])[i] = L.tracking;
  ((long long*)Q.p[S_OUT + S_RS])[i] = (long long)L.rs;
  ((long long*)Q.p[S_OUT + S_RINC])[i] = (long long)L.inc;
  if (P.i[IP_DEFER] > 0) ((bool*)Q.p[S_OUT + S_PEND])[i] = L.pend;
}

// fast.py's pending_of: a path in flight or samples left.
__device__ __forceinline__ bool pending_of(const Params& P, const Lane& L) {
  return L.alive || L.sd < P.i[IP_SPP];
}

// The GGX boundary's parameters.
__device__ __forceinline__ Ggx ggx_of(const Params& P) {
  return {P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
          P.i[IP_MITSUBA] != 0};
}

// ops/fastbody.flush_due: whether an evaluation of a width-lane pool that
// starts at the float32 row count n_rows flushes the deferred events.
__device__ __forceinline__ bool flush_due(float n_rows, int width, long long g) {
  return (long long)rintf(n_rows / (float)width) % g == 0;
}

// render_tile's flush_boundary for one lane whose event waits (pend_b): the
// boundary event at o + d * max_t with the cached face normal, bounce + 1,
// the path cap, then Russian roulette if it was not capped.
__device__ __forceinline__ void flush_lane(const Params& P, Lane& L) {
  boundary_event(P.i[IP_BSDF] != 0, ggx_of(P), L.nrm, L.max_t, L.o, L.d, L.tp, L.rs, L.inc);
  L.bounce = L.bounce + 1;
  const bool capped = L.bounce >= P.i[IP_MAXPATH];
  if (capped) {
    L.alive = false;
    L.sd = L.sd + 1;
  }
  if (P.i[IP_RR] && !capped && roulette_kills(L.tp, L.rs, L.inc)) {
    L.alive = false;
    L.sd = L.sd + 1;
  }
  L.pend = false;
}

// What speculate finds among its K candidates.
struct SpecStop {
  bool any_stop;   // a candidate stopped the prefix (accepted, or invalid)
  bool accepted;   // ... by its acceptance
  float t_stop;    // t of the stopping candidate, else of the last one
  long long flat;  // the accepted tap's flat index and density
  float rho;
};

// candidates whose table loads are issued together, before their tests
constexpr int SPEC_BATCH = 4;

// render_tile's speculate for one stepping lane: K = IP_SPEC flight draws
// from t under inv_sig; a candidate is valid while it stays before t_end
// (strictly for a brick exit, two-level; up to the box's max_t
// single-level).  The candidates' t only grows, so the valid ones are a
// prefix of n_v; their tap draws follow the K flight draws and
// their acceptance draws follow those, so the stream moves by K + 2 n_v.
// Returns the first acceptance among the valid candidates, or the first
// invalid one, or neither (t of the last candidate).
__device__ __forceinline__ SpecStop speculate(const Params& P, const Ptrs& Q,
                                              const float o[3], const float d[3], float t,
                                              float inv_sig, float t_end, bool strict,
                                              uint32_t& rs, uint32_t inc) {
  const long long K = P.i[IP_SPEC];
  const float scale = P.f[FP_SCALE];
  // pass 1: the flight draws; the valid prefix and the stop's t
  const uint32_t s0 = rs;
  float t_run = t, t_invalid = 0.0f;
  long long n_v = K;
  for (long long j = 0; j < K; ++j) {
    t_run = t_run + -logf(jmax(draw_float(rs, inc), EPS)) * inv_sig;
    const bool before = strict ? t_run < t_end : t_run <= t_end;
    if (!before && n_v == K) {
      n_v = j;
      t_invalid = t_run;
    }
  }
  SpecStop r;
  r.any_stop = n_v < K;
  r.accepted = false;
  r.t_stop = n_v < K ? t_invalid : t_run;
  r.flat = 0;
  r.rho = 0.0f;
  // pass 2: the tap draws from rs on, the acceptance draws n_v further on,
  // each candidate's t again from s0; the lane's stream ends 2 n_v past rs
  uint32_t s_u1 = s0, s_tap = rs, s_u2 = rs;
  for (long long j = 0; j < n_v; ++j) s_u2 = pcg_next(s_u2, inc);
  uint32_t s_end = s_u2;
  for (long long j = 0; j < n_v; ++j) s_end = pcg_next(s_end, inc);
  float tj = t;
  for (long long j0 = 0; j0 < n_v && !r.accepted; j0 += SPEC_BATCH) {
    float tc[SPEC_BATCH], rho[SPEC_BATCH];
    long long flat[SPEC_BATCH];
#pragma unroll
    for (int k = 0; k < SPEC_BATCH; ++k) {
      tc[k] = 0.0f;
      flat[k] = 0;
      if (j0 + k < n_v) {
        tj = tj + -logf(jmax(draw_float(s_u1, inc), EPS)) * inv_sig;
        tc[k] = tj;
        flat[k] = tap_index(P, o, d, tj, draw_bits(s_tap, inc));
      }
    }
#pragma unroll
    for (int k = 0; k < SPEC_BATCH; ++k) rho[k] = j0 + k < n_v ? tap_rho(P, Q, flat[k]) : 0.0f;
#pragma unroll
    for (int k = 0; k < SPEC_BATCH; ++k) {
      if (j0 + k < n_v && !r.accepted) {
        const float u2 = draw_float(s_u2, inc);
        if (!(scale * rho[k] * inv_sig < u2)) {
          r.any_stop = r.accepted = true;
          r.t_stop = tc[k];
          r.flat = flat[k];
          r.rho = rho[k];
        }
      }
    }
  }
  rs = s_end;
  return r;
}

// One evaluation of the body for one lane; returns whether the lane started a
// segment (counted in n_rays).  Afterwards L.tracking is the lane's count in
// n_busy.
__device__ __forceinline__ bool evaluate(const Params& P, const Ptrs& Q, Lane& L) {
  float* o = L.o;
  float* d = L.d;
  float* tp = L.tp;
  float* acc = L.acc;
  float* nrm = L.nrm;
  float& t = L.t;
  float& max_t = L.max_t;
  float& bexit = L.bexit;
  float& isl = L.isl;
  long long& sd = L.sd;
  long long& bounce = L.bounce;
  bool& alive = L.alive;
  bool& tracking = L.tracking;
  uint32_t& rs = L.rs;
  uint32_t& inc = L.inc;
  const long long pix = L.pix, slot = L.slot, spp = P.i[IP_SPP];

  // --- regenerate: next sample of the lane's pixel ----------------------
  const bool needs = !alive && sd < spp;
  if (needs) {
    const long long npix = P.i[IP_NPIX], tw = P.i[IP_TW];
    const uint32_t s = (uint32_t)(slot + P.i[IP_M] * sd);
    uint32_t pid;
    float px, py;
    if (P.i[IP_MULTI]) {
      const long long local = pix % npix, tile = pix / npix;
      const float* off = (const float*)Q.p[S_TILE_OFF] + 2 * tile;
      const uint32_t base = (uint32_t)((const long long*)Q.p[S_BASES])[tile];
      pid = s * (uint32_t)npix + (uint32_t)local + base;
      pixel_of(local, tw, P.f[FP_INV_TW], off[0], off[1], px, py);
    } else {
      pid = s * (uint32_t)npix + (uint32_t)pix + (uint32_t)P.i[IP_BASE];
      pixel_of(pix, tw, P.f[FP_INV_TW], P.f[FP_TILEX], P.f[FP_TILEY], px, py);
    }
    path_stream(pid, (uint32_t)P.i[IP_SEEDH], rs, inc);
    camera_ray(P.f + FP_CAM, P.f[FP_R2VX], P.f[FP_R2VY], P.f[FP_INV_RESX], P.f[FP_INV_RESY],
               px, py, rs, inc, o, d);
    for (int k = 0; k < 3; ++k) tp[k] = 1.0f;
    alive = true;
    tracking = false;
    bounce = 0;
  }

  // --- segment start: AABB + classification (a lane whose deferred event
  // waits starts none) ----------------------------------------------------
  const bool defer = P.i[IP_DEFER] > 0;
  const bool need_isect = alive && !tracking && !L.pend;
  bool boundary_now = false;
  float dist = 0.0f;
  if (need_isect) {
    const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, o, d);
    dist = h.dist;
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * d[0], h.nrm[1] * d[1], h.nrm[2] * d[2]) > 0.0f;
    if (!hit) {
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + tp[k] * P.f[FP_LE + k];
      sd = sd + 1;
      alive = false;
    }
    if (hit && inside) {
      tracking = true;
      t = 0.0f;
      max_t = h.dist;
      bexit = -1.0f;
    }
    boundary_now = hit && !inside;
    for (int k = 0; k < 3; ++k) nrm[k] = h.nrm[k];
  }

  // --- tracking ----------------------------------------------------------
  const float scale = P.f[FP_SCALE];
  bool scattered = false, overran = false, terminated = false;
  float alb_hat[3] = {0.0f, 0.0f, 0.0f};
  if (P.i[IP_TWO_LEVEL]) {
    const float epsw = P.f[FP_EPSW];
    const bool need_brick = tracking && t >= bexit;
    bool probe_empty = false, overran_empty = false;
    float t_leap = 0.0f;
    if (need_brick) {
      const float tt = t + epsw;
      long long bi[3];
      const long long hi[3] = {P.i[IP_HIX], P.i[IP_HIY], P.i[IP_HIZ]};
      float bound[3];
      for (int a = 0; a < 3; ++a) {
        const float p = o[a] + tt * d[a];
        const float coord =
            jclip((p - P.f[FP_BMIN + a]) / P.f[FP_EXT + a], 0.0f, 1.0f) * P.f[FP_RM1 + a];
        long long b = (long long)floorf(coord / P.f[FP_BSIZE + a]);
        b = b < 0 ? 0 : b;
        bi[a] = b < hi[a] ? b : hi[a];
      }
      const long long bflat = (bi[2] * P.i[IP_NBY] + bi[1]) * P.i[IP_NBX] + bi[0];
      const float* brow = (const float*)Q.p[S_BTAB] + 2 * bflat;
      const float rho_b = brow[0], leap_b = brow[1];
      for (int a = 0; a < 3; ++a) {
        const float up = d[a] > 0.0f ? 1.0f : 0.0f;
        const float bound_coord = ((float)bi[a] + up) * P.f[FP_BSIZE + a];
        bound[a] = P.f[FP_BMIN + a] + P.f[FP_EXT + a] * bound_coord / P.f[FP_RM1 + a];
      }
      const float exit_new = dda_exit(bound, o, d, t + epsw);
      bexit = exit_new;
      isl = rho_b > 0.0f ? (1.0f / (scale * jmax(rho_b, 1e-30f))) * 1.0f : INFINITY;
      probe_empty = rho_b <= 0.0f;
      t_leap = jmax(exit_new, t + leap_b);
      overran_empty = probe_empty && t_leap >= max_t;
    }
    const bool stepping = tracking && !probe_empty;
    const float eff_exit = jmin(bexit, max_t);
    bool crossed_step = false, advance = false, accepted = false;
    float t_adv = t;  // where an advancing lane moves
    if (stepping && P.i[IP_SPEC] > 1) {
      // speculative steps: the prefix up to the first acceptance or brick
      // crossing; no stop within K valid steps advances and keeps tracking
      const SpecStop r = speculate(P, Q, o, d, t, isl, eff_exit, true, rs, inc);
      accepted = r.accepted;
      crossed_step = r.any_stop && !r.accepted;
      advance = accepted || !r.any_stop;
      t_adv = r.t_stop;
      if (accepted) tap_albedo(P, Q, r.flat, r.rho, alb_hat);
    } else if (stepping) {
      const float u1 = draw_float(rs, inc);
      const float step = -logf(jmax(u1, EPS)) * isl;
      t_adv = t + step;
      crossed_step = t_adv >= eff_exit;
      advance = !crossed_step;
      if (advance) {
        const uint32_t bits = draw_bits(rs, inc);
        const long long flat = tap_index(P, o, d, t_adv, bits);
        const float rho = tap_rho(P, Q, flat);
        const float u2 = draw_float(rs, inc);
        accepted = !(scale * rho * isl < u2);
        if (accepted) tap_albedo(P, Q, flat, rho, alb_hat);
      }
    }
    const bool overran_step = crossed_step && max_t <= bexit;
    const bool transit = crossed_step && !overran_step;
    if (probe_empty) {
      t = jmin(t_leap, max_t);
    } else if (transit) {
      t = bexit;
    } else if (overran_step) {
      t = jmax(t, max_t);
    } else if (advance) {
      t = t_adv;
    }
    if (probe_empty) bexit = -1.0f;
    overran = overran_step || overran_empty;
    terminated = overran || accepted;
    scattered = accepted;
    tracking = tracking && !terminated;
  } else {
    // single-level Woodcock tracking under the global majorant
    if (tracking && P.i[IP_SPEC] > 1) {
      // speculative steps: no brick crossings, so every candidate up to the
      // box's exit is a valid Woodcock step
      const SpecStop r = speculate(P, Q, o, d, t, P.f[FP_INV_SIGMAT], max_t, false, rs, inc);
      overran = r.any_stop && !r.accepted;
      terminated = r.any_stop;
      scattered = r.accepted;
      if (scattered) tap_albedo(P, Q, r.flat, r.rho, alb_hat);
      t = r.t_stop;
      tracking = !terminated;
    } else if (tracking) {
      const float inv_sigmat = P.f[FP_INV_SIGMAT];
      const float u1 = draw_float(rs, inc);
      const float t_new = t + -logf(jmax(u1, EPS)) * inv_sigmat;
      const uint32_t bits = draw_bits(rs, inc);
      const long long flat = tap_index(P, o, d, t_new, bits);
      const float rho = tap_rho(P, Q, flat);
      const float u2 = draw_float(rs, inc);
      overran = t_new > max_t;
      const bool accepted = !(scale * rho * inv_sigmat < u2);
      terminated = overran || accepted;
      scattered = terminated && !overran;
      if (scattered) tap_albedo(P, Q, flat, rho, alb_hat);
      t = t_new;
      tracking = !terminated;
    }
  }

  // --- boundary event (under defer_ggx: its distance kept, the lane
  // stalled for the flush) ------------------------------------------------
  const bool boundary = boundary_now || (terminated && overran);
  if (defer) {
    if (boundary_now) max_t = dist;
    if (boundary) L.pend = true;
  } else if (boundary) {
    boundary_event(P.i[IP_BSDF] != 0, ggx_of(P), nrm, boundary_now ? dist : max_t, o, d, tp,
                   rs, inc);
  }

  // --- scatter event: the accepted tap's albedo ---------------------------
  if (scattered) {
    float os[3], nd[3];
    for (int k = 0; k < 3; ++k) os[k] = o[k] + d[k] * t - d[k] * EPS;
    const float e1 = draw_float(rs, inc);
    const float e2 = draw_float(rs, inc);
    float cos_th, sin_th;
    hg(P.f[FP_G], e1, cos_th, sin_th);
    const float phi = TWO_PI_F * e2;
    turn(d, sin_th * cosf(phi), sin_th * sinf(phi), cos_th, nd);
    for (int k = 0; k < 3; ++k) {
      o[k] = os[k];
      d[k] = nd[k];
      tp[k] = tp[k] * alb_hat[k];
    }
  }

  // --- path-length cap + Russian roulette after events ---------------------
  const bool had_event = alive && (scattered || (boundary && !defer));
  if (had_event) bounce = bounce + 1;
  const bool capped = alive && bounce >= P.i[IP_MAXPATH];
  alive = alive && !capped;
  if (capped) sd = sd + 1;
  if (P.i[IP_RR] && had_event && !capped && roulette_kills(tp, rs, inc)) {
    alive = false;
    sd = sd + 1;
  }
  tracking = tracking && !capped;

  return need_isect;
}

// The pool's counts of one evaluation, summed over the grid: per block with
// __syncthreads_count, across blocks with atomics into the scratch; the last
// block writes n_rays, n_rows and n_busy (each added once in float32) and the
// pending count, and clears the scratch.  Returns whether this block was last.
__device__ __forceinline__ bool reduce_counts(const Ptrs& Q, int width, bool isect,
                                              bool busy, bool pend) {
  const int n_isect = __syncthreads_count(isect);
  const int n_busy = __syncthreads_count(busy);
  const int n_pend = __syncthreads_count(pend);
  if (threadIdx.x != 0) return false;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  atomicAdd(scratch + 0, (unsigned long long)n_isect);
  atomicAdd(scratch + 1, (unsigned long long)n_busy);
  atomicAdd(scratch + 2, (unsigned long long)n_pend);
  if (!last_block(scratch + 3)) return false;  // the last block: every count is in
  const unsigned long long rays = atomicAdd(scratch + 0, 0ull);
  const unsigned long long busy_all = atomicAdd(scratch + 1, 0ull);
  const unsigned long long pend_all = atomicAdd(scratch + 2, 0ull);
  float* counts = (float*)Q.p[S_COUNTS];
  counts[0] = *(const float*)Q.p[S_NRAYS] + (float)rays;
  counts[1] = *(const float*)Q.p[S_NROWS] + (float)width;
  counts[2] = *(const float*)Q.p[S_NBUSY] + (float)busy_all;
  *(long long*)Q.p[S_PENDING] = (long long)pend_all;
  for (int k = 0; k < 4; ++k) scratch[k] = 0ull;
  return true;
}

// One evaluation of every lane; gated when S_CTRL is set.
__global__ void __launch_bounds__(THREADS) body_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  long long e = 0;
  if (ctrl != nullptr) {
    if (stage_stopped(ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])) return;
    e = ctrl[C_EVAL];
  }
  const int i = blockIdx.x * THREADS + threadIdx.x;
  // the evaluation's n_rows as it stood before the last block adds width
  const bool flush = P.i[IP_DEFER] > 0 &&
                     flush_due(*(const float*)Q.p[S_NROWS], width, P.i[IP_DEFER]);
  bool isect = false, busy = false, pend = false;
  if (i < width) {
    Lane L;
    load_lane(P, Q, i, L);
    if (flush && L.pend) flush_lane(P, L);
    isect = evaluate(P, Q, L);
    busy = L.tracking;
    pend = pending_of(P, L);
    store_lane(P, Q, i, L);
  }
  // S_PENDING is &ctrl[C_COUNT] when gated
  if (reduce_counts(Q, width, isect, busy, pend) && ctrl != nullptr) ctrl[C_EVAL] = e + 1;
}

// Adds each lane's flag to counts[j], j its evaluation in this launch: one
// atomic per group of a warp's lanes at the same j.
__device__ __forceinline__ void warp_count(unsigned* counts, int j, bool flag) {
  const unsigned active = __activemask();
  const unsigned same = __match_any_sync(active, j);
  const unsigned votes = __ballot_sync(active, flag) & same;
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1 && votes != 0u)
    atomicAdd(counts + j, (unsigned)__popc(votes));
}

// The last stage's lanes each run to their end (or to the cap), in registers.
template <int T>
__global__ void __launch_bounds__(T) drain_kernel(Params P, Ptrs Q, int width) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned* per_eval = (unsigned*)Q.p[S_EVALS];  // [isect: cap][busy: cap]
  const long long cap = P.i[IP_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const int i = blockIdx.x * T + threadIdx.x;
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false;
  if (i < width) {
    Lane L;
    load_lane(P, Q, i, L);
    if (pending_of(P, L)) {
      // n_rows before each evaluation, folded as the last block folds it
      float rows = *(const float*)Q.p[S_NROWS];
      const float w = (float)width;
      do {
        if (L.pend && flush_due(rows, width, P.i[IP_DEFER])) flush_lane(P, L);
        rows = rows + w;
        const bool isect = evaluate(P, Q, L);
        warp_count(per_eval, j, isect);
        warp_count(per_eval + cap, j, L.tracking);
        ++j;
      } while (j < cap && pending_of(P, L));
      store_lane(P, Q, i, L);
      left = pending_of(P, L);
      finished = !left;
    }
  }
  DrainEnd end;
  if (!drain_end(ctrl, e0, P.i[IP_CHAIN], j, left, finished, end)) return;
  // the last block: every lane's counts are in.  The evaluations of this
  // launch that the loop makes: all of them while a lane is left, else up to
  // E (those past the cap count nothing)
  const long long n_fold = end.left == 0 ? end.total - e0 : cap;
  float* counts = (float*)Q.p[S_COUNTS];
  float rays = counts[0], rows = counts[1], busy = counts[2];
  const float w = (float)width;
#pragma unroll 8
  for (long long e = 0; e < n_fold; ++e) {
    const unsigned ci = e < cap ? __ldcg(per_eval + e) : 0u;
    const unsigned cb = e < cap ? __ldcg(per_eval + cap + e) : 0u;
    rays = rays + (float)ci;
    rows = rows + w;
    busy = busy + (float)cb;
  }
  counts[0] = rays;
  counts[1] = rows;
  counts[2] = busy;
  for (long long e = 0; e < end.jmax; ++e) per_eval[e] = per_eval[cap + e] = 0u;
  drain_close(ctrl, e0, cap, end.left);
}

Params params_of(const float* fparams, const long long* iparams) {
  Params P;
  for (int k = 0; k < N_FP; ++k) P.f[k] = fparams[k];
  for (int k = 0; k < N_IP; ++k) P.i[k] = iparams[k];
  return P;
}

Ptrs ptrs_of(void* const* ptrs) {
  Ptrs Q;
  for (int k = 0; k < N_S; ++k) Q.p[k] = ptrs[k];
  return Q;
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/fastbody.py).  fparams (N_FP,)
// float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses, all in
// host memory and copied into the launch; width lanes.  Each returns
// cudaGetLastError(), or -1 when a size does not match this build's.

// body_kernel: the scratch (4 uint64) must be zero before the first launch and
// is zero after each; with ptrs[S_CTRL] set, a gated evaluation of a stage
// (IP_THRESH, IP_CHAIN) whose control words the host set at its start.
extern "C" int fastbody_launch(const float* fparams, int n_fp, const long long* iparams,
                               int n_ip, void* const* ptrs, int n_s, int width,
                               void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    const int blocks = (width + THREADS - 1) / THREADS;
    body_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// drain_kernel with `threads` (32, 64, 128 or 256) per block: the control
// words zero at the stage's start, the per-evaluation counts (2 * IP_CAP
// uint32) zero before each launch (each launch leaves them zero).
extern "C" int fastbody_drain(const float* fparams, int n_fp, const long long* iparams,
                              int n_ip, void* const* ptrs, int n_s, int width, int threads,
                              void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width <= 0) return 0;
  const Params P = params_of(fparams, iparams);
  const Ptrs Q = ptrs_of(ptrs);
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (width + threads - 1) / threads;
  switch (threads) {
    case 32: drain_kernel<32><<<blocks, 32, 0, st>>>(P, Q, width); break;
    case 64: drain_kernel<64><<<blocks, 64, 0, st>>>(P, Q, width); break;
    case 128: drain_kernel<128><<<blocks, 128, 0, st>>>(P, Q, width); break;
    case 256: drain_kernel<256><<<blocks, 256, 0, st>>>(P, Q, width); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_FP, N_IP, N_S, N_CTRL), for the
// wrapper's check.
extern "C" void fastbody_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
