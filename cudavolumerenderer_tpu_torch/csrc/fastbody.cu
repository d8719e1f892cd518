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
// Four launches run the body (ops/fastbody.py):
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
//   * thread_drain_kernel (the last stage with no tail kernel: the loop
//     exits at a pending count of 0, so no lane waits for another): each
//     thread loads its lane once, runs evaluations in registers until the
//     lane is no longer pending (a non-pending lane is a fixed point of the
//     body, and adds nothing to the counts) or a cap is reached, and stores
//     it once.  Per evaluation, segment starts and tracking lanes go by
//     warp-aggregated integer atomics into arrays indexed by the evaluation,
//     and the last block folds them into n_rays, n_rows and n_busy in
//     float32, one evaluation after another, through E = k_chain * ceil(L /
//     k_chain) evaluations (L: the longest lane's), the same sums in the same
//     order as the loop's.  It is bound by the longest lane's chain of
//     dependent evaluations (~3 us each on the H100), not by bytes.  The
//     speculative steps and the deferred flush drain here; the other modes
//     run their first DRAIN_SPLIT evaluations here, which most lanes end in;
//   * drain_kernel, the rest of those lanes (relaunched at the cap, the same
//     control words): a lane in rounds of up to 32 evaluations by a group of
//     threads (below), which a long chain of scatters and transits repays.
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
#include <cmath>

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
  IP_LOOK,    // the drain's rounds: DRAIN_GROUP threads a lane (0: a thread a lane)
  N_IP,
};

// Pointer slots (ops/fastbody.py S_*): the 16 per-lane fields the body
// updates (pend_b read and written only under defer_ggx), then the read-only
// ones, the outputs (the 16 fields again, the counts, the pending count, the
// scratch), the tables, a stage's control words and per-evaluation counts
// (null for one evaluation), and the drain rounds' PCG jump table.
enum {
  S_O = 0, S_D, S_TP, S_ACC, S_NRM, S_T, S_MAXT, S_BEXIT, S_ISL, S_SD,
  S_BOUNCE, S_ALIVE, S_TRACKING, S_RS, S_RINC, S_PEND,
  N_LANE,
  S_PIX = N_LANE, S_SLOT, S_NRAYS, S_NROWS, S_NBUSY,
  S_OUT, S_COUNTS = S_OUT + N_LANE, S_PENDING, S_SCRATCH,
  S_TABLE, S_ALB_ROWS, S_BTAB, S_TILE_OFF, S_BASES, S_CTRL, S_EVALS, S_JUMP,
  S_STATS,  // the drain rounds' per-lane counts (ST_*), or null
  S_RISL,    // the drain rounds' tables: each brick's inverse majorant,
  S_PLANES,  // and each axis's brick planes (x, then y, then z)
  N_S,
};

// The drain rounds' counts per lane (S_STATS, N_ST uint32 a lane, added to
// by each launch): rounds and evaluations of each kind, and how chains end.
enum {
  ST_NULL_ROUNDS = 0, ST_NULL_EVALS, ST_CHAIN_ROUNDS, ST_CHAIN_EVALS, ST_ONE,
  ST_CHAIN_STOPS, ST_CHAIN_REJECTS, ST_CHAIN_DIED, ST_CHAIN_STEPS,
  ST_CYCLES, ST_CHAIN_CYCLES,  // clock64 cycles of the lane's rounds, of its chains' steps
  ST_BANK_CYCLES, ST_TAP_CYCLES, ST_TP_CYCLES,  // ... of its banks, taps, throughput chains
  N_ST,
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

// The two-level geometry a probe and a segment start read, held in
// registers (a parameter read through a pointer into Params would go
// through a local copy of it).
struct Geo {
  float bmin[3], bmax[3], ext[3], rm1[3], bsize[3];
  float epsw, scale, hg_g;
  long long n[3], hi[3], nbx, nby;
  bool brick_major;
  const float2* btab;
  const float* risl;    // the probe's isl of each brick (S_RISL), the rounds'
  const float* planes;  // the brick planes of each axis (S_PLANES), the rounds'
};

__device__ __forceinline__ Geo geo_of(const Params& P, const Ptrs& Q) {
  Geo g;
  for (int a = 0; a < 3; ++a) {
    g.bmin[a] = P.f[FP_BMIN + a];
    g.bmax[a] = P.f[FP_BMAX + a];
    g.ext[a] = P.f[FP_EXT + a];
    g.rm1[a] = P.f[FP_RM1 + a];
    g.bsize[a] = P.f[FP_BSIZE + a];
  }
  g.epsw = P.f[FP_EPSW];
  g.scale = P.f[FP_SCALE];
  g.hg_g = P.f[FP_G];
  g.hi[0] = P.i[IP_HIX];
  g.hi[1] = P.i[IP_HIY];
  g.hi[2] = P.i[IP_HIZ];
  g.nbx = P.i[IP_NBX];
  g.nby = P.i[IP_NBY];
  for (int a = 0; a < 3; ++a) g.n[a] = P.i[IP_NX + a];
  g.brick_major = P.i[IP_BRICK_MAJOR] != 0;
  g.btab = (const float2*)Q.p[S_BTAB];
  g.risl = (const float*)Q.p[S_RISL];
  g.planes = (const float*)Q.p[S_PLANES];
  return g;
}

// tap_index from the registers' geometry.
__device__ __forceinline__ long long tap_at(const Geo& g, const float o[3], const float d[3],
                                            float t, uint32_t bits) {
  return tap_flat(g.bmin, g.ext, g.rm1, g.n, g.brick_major, o, d, t, bits);
}

// v[a] for an index known only at run time, from registers.
__device__ __forceinline__ float pick3(const float v[3], int a) {
  return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

// jmax and jmin in one instruction each (max.NaN: NaN when either side is,
// else fmaxf's value), for the rounds' serial paths.
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// box_hit's slab test (common.cuh) from each axis's slab t's, with nmin
// and nmax.
__device__ __forceinline__ BoxHit slabs_hit(const float ttop[3], const float tbot[3]) {
  BoxHit h;
  h.largest_tmin = nmax(nmax(nmin(ttop[0], tbot[0]), nmin(ttop[1], tbot[1])),
                        nmin(ttop[2], tbot[2]));
  h.smallest_tmax = nmin(nmin(nmax(ttop[0], tbot[0]), nmax(ttop[1], tbot[1])),
                         nmax(ttop[2], tbot[2]));
  h.dist = h.largest_tmin > EPS ? h.largest_tmin : h.smallest_tmax;
  h.nrm[0] = h.nrm[1] = h.nrm[2] = 0.0f;
  bool taken = false;
  for (int j = 0; j < 6; ++j) {
    const int a = j % 3;
    const float tpl = j < 3 ? ttop[a] : tbot[a];
    if (!taken && h.dist == tpl) {
      h.nrm[a] = j < 3 ? 1.0f : -1.0f;
      taken = true;
    }
  }
  return h;
}

// One axis of the geometry: a chain member takes axis m % 3 of the box
// test and the probe, whose three axes each divide alike, so a step runs
// one division of each kind in place of three (a division is the chain's
// longest instruction sequence, and those of one thread run in turn).
struct Axis {
  int a;
  float bmin, bmax, ext, rm1, bsize, inv_ext, inv_bsize;
  int hi;
  const float* planes;  // bmin + ext * (i * bsize) / rm1, i = 0 .. hi + 1
};

__device__ __forceinline__ Axis axis_of(const Geo& g, int a) {
  const float ext = pick3(g.ext, a), bsize = pick3(g.bsize, a);
  const int off = a == 0 ? 0 : (a == 1 ? (int)g.hi[0] + 2 : (int)(g.hi[0] + g.hi[1]) + 4);
  return Axis{a, pick3(g.bmin, a), pick3(g.bmax, a), ext, pick3(g.rm1, a), bsize,
              1.0f / ext, 1.0f / bsize,
              (int)(a == 0 ? g.hi[0] : (a == 1 ? g.hi[1] : g.hi[2])), g.planes + off};
}

// Axis x's share of box_hit (its slab t's) and of evaluate's probe at t0
// (its brick index and its DDA plane's t), each as those compute it.
// With POW2 (every extent and brick size a power of two) the divisions by
// them are multiplications by their reciprocals, which give the same
// float: both round the same real number.  A brick index is at most the
// grid's, so an int holds it.
struct AxisStep {
  float tbot, ttop, t_axis;
  int b;
};

template <bool POW2>
__device__ __forceinline__ AxisStep axis_step(const Axis& x, float epsw, const float o[3],
                                              const float d[3], float t0, bool seg) {
  const float oa = pick3(o, x.a), da = pick3(d, x.a);
  AxisStep r;
  r.tbot = r.ttop = 0.0f;
  if (seg) {  // the slab, for a segment start
    const float inv = 1.0f / da;
    r.tbot = (x.bmin - oa) * inv;
    r.ttop = (x.bmax - oa) * inv;
  }
  const float tt = t0 + epsw;
  const float p = oa + tt * da;
  const float rel = POW2 ? (p - x.bmin) * x.inv_ext : (p - x.bmin) / x.ext;
  const float coord = nmin(nmax(rel, 0.0f), 1.0f) * x.rm1;
  int b = (int)floorf(POW2 ? coord * x.inv_bsize : coord / x.bsize);
  b = b < 0 ? 0 : b;
  b = b < x.hi ? b : x.hi;
  const float bound = __ldg(x.planes + b + (da > 0.0f ? 1 : 0));
  r.t_axis = fabsf(da) > 1e-12f ? (bound - oa) / da : INFINITY;
  r.b = b;
  return r;
}

// One evaluation of the body for one lane; returns whether the lane started a
// segment (counted in n_rays).  Afterwards L.tracking is the lane's count in
// n_busy.  Without MODES the speculative steps and the deferred flush are
// compiled out (the drain's rounds run neither).
template <bool MODES>
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
  const bool defer = MODES && P.i[IP_DEFER] > 0;
  const bool spec = MODES && P.i[IP_SPEC] > 1;
  const bool need_isect = alive && !tracking && !(MODES && L.pend);
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
    if (stepping && spec) {
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
    if (tracking && spec) {
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
    isect = evaluate<true>(P, Q, L);
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

// The last stage's lanes each run to their end (or to the cap), in registers,
// a thread a lane, one evaluation after another: the speculative steps and
// the deferred flush drain here.
template <int T>
__global__ void __launch_bounds__(T) thread_drain_kernel(Params P, Ptrs Q, int width) {
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
        const bool isect = evaluate<true>(P, Q, L);
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

// ---- the drain's rounds -------------------------------------------------------
//
// drain_kernel: a lane of the last stage (spec_k 1, no deferred flush) is
// taken by a warp, G = DRAIN_GROUP threads (every member holds the lane's
// state alike; the device helpers take any power-of-two G), in rounds that
// each take up to min(G, cap - j) of its evaluations, j those it ran in the
// launch:
//  * null run (a tracking lane with no probe due): between events an
//    evaluation changes only t and draws u1, the tap bits and u2.  Member m
//    jumps to draw 3 m + 1 (common.cuh null_jump), forms t_m as the eager
//    loop's left-to-right sum (run_sum), tests its crossing, taps and tests
//    its acceptance; first_stop finds the first member that crossed or
//    accepted, and the evaluations before it are null steps.  A crossing
//    that is a transit (t to the brick's exit, one draw) is taken too; an
//    acceptance leaves its evaluation to a chain;
//  * chain (two-level, a live lane): the evaluations of a path between its
//    events are a segment start inside the box, a brick probe, a step, and
//    transits to the next brick until a tap accepts, and all but the tap's
//    density follow from the pose and the draws (config 2's longest lane is
//    such evaluations alone, chip_smoke.py's drain_chain).  So every member
//    runs the chain of evaluations k = 0, 1, ... alike, each from the state
//    the one before left and every tap assumed to accept (the scatter's HG
//    direction, bounce + 1, the path cap, Russian roulette's draw).  The
//    serial part is the pose, a brick row and a few divisions an
//    evaluation; the draws' logs, HG angles and sines come from a bank the
//    members fill at once, a brick's inverse majorant and planes from
//    tables (round_tables in ops/fastbody.py), and the three axes of the
//    box test and the probe from three members.  Member k keeps evaluation
//    k, and then the members tap and test their evaluations at once (the
//    density loads in parallel); a ballot finds the first rejected tap,
//    which is taken as a null step, and a throughput chain carries tp
//    through the albedos, the cap and Russian roulette up to there, a kill
//    or the cap ending the round at its evaluation.  The chain stops before
//    an evaluation it cannot follow: a miss or a hit from outside, an empty
//    brick, an overrun;
//  * any other evaluation (a regeneration, a boundary event, an empty
//    brick's leap, what a chain stopped before, single-level's events) is
//    taken by the group alike, one a round, as evaluate runs it.
// Each round's evaluations add their segment starts and tracking flags to
// the per-evaluation counts by member k's atomics at j + k (no
// aggregation), which the last block folds as the thread drain does.  The
// rounds run every table layout and albedo mode, one- and two-level.

// the threads a lane of the rounds (ops/fastbody.py DRAIN_GROUP): a warp,
// which beat groups of 8 and 16 on every stage it was timed on
constexpr int DRAIN_GROUP = 32;
// the most draws an evaluation of a chain takes (u1, the tap bits, u2, e1,
// e2, RR's), so a round of at most G evaluations takes at most BANK_W G
constexpr int BANK_W = 6;
constexpr int JUMP_N1 = BANK_W * DRAIN_GROUP + 1;  // jumps of m = 0 .. 6 * 32 draws
constexpr int BANK_THREADS = 256;  // the most threads a block
// what a round leaves the next: a chain, a null run, one evaluation
constexpr int NEXT_CHAIN = 0, NEXT_NULL = 1, NEXT_ONE = 2;

// A lane's round counts and clock64 cycles (ST_*), kept only by the launch
// that asks for them (S_STATS set): Tally<false> adds nothing and reads no
// clock, so the drain's own launches carry no bookkeeping.
template <bool ON>
struct Tally {
  unsigned st[N_ST] = {};
  __device__ __forceinline__ void add(int k, unsigned v) { st[k] += v; }
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void store(unsigned* stats, int i, long long c0) {
    st[ST_CYCLES] = (unsigned)(clock64() - c0);
    for (int k = 0; k < N_ST; ++k) stats[N_ST * i + k] += st[k];
  }
};
template <>
struct Tally<false> {
  __device__ __forceinline__ void add(int, unsigned) {}
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void store(unsigned*, int, long long) {}
};

// Adds one evaluation's flags to the launch's per-evaluation counts.
__device__ __forceinline__ void count_eval(unsigned* per_eval, long long cap, int e, bool isect,
                                           bool busy) {
  if (isect) atomicAdd(per_eval + e, 1u);
  if (busy) atomicAdd(per_eval + cap + e, 1u);
}

// A null run of a tracking lane (two-level: no probe due) over up to D
// evaluations; returns those taken (member m < n counts a tracking lane at
// j + m) and what the next round is.  Every member calls it.
template <int G>
__device__ __forceinline__ int null_run(const Params& P, const Ptrs& Q, const Geo& g,
                                        unsigned mask, int m, const Jump& J, Lane& L, int D,
                                        int& next) {
  const bool two = P.i[IP_TWO_LEVEL] != 0;
  const float isig = two ? L.isl : P.f[FP_INV_SIGMAT];
  const uint32_t s1 = jumped(J, L.rs, L.inc);  // u1
  const uint32_t s2 = pcg_next(s1, L.inc);     // the tap bits
  const uint32_t s3 = pcg_next(s2, L.inc);     // u2
  const float tj = run_sum<G>(mask, L.t, flight(s1, isig), m, D);
  const bool crossed = two ? tj >= jmin(L.bexit, L.max_t) : tj > L.max_t;
  const float rho = tap_rho(P, Q, tap_at(g, L.o, L.d, tj, pcg_bits(s2)));
  const bool accepted = !(g.scale * rho * isig < uniform(s3));
  const int src = first_stop<G>(mask, m, D, crossed || accepted);
  const int last = src < 0 ? D - 1 : src - 1;  // the last null step
  if (last >= 0) {
    L.t = group_shfl<G>(mask, tj, last);
    L.rs = group_shfl<G>(mask, s3, last);
  }
  if (src < 0) {
    next = NEXT_NULL;
    return D;
  }
  const uint32_t s1_src = group_shfl<G>(mask, s1, src);
  const bool crossed_src = group_shfl<G>(mask, (int)crossed, src) != 0;
  if (two && crossed_src && !(L.max_t <= L.bexit)) {  // a transit
    L.t = L.bexit;
    L.rs = s1_src;
    next = NEXT_CHAIN;
    return src + 1;
  }
  // two-level: an acceptance goes to a chain, an overrun's boundary event to
  // one evaluation; single-level: either to one evaluation
  next = two && !crossed_src ? NEXT_CHAIN : NEXT_ONE;
  return src;
}

// A chain round's draws, made by the members at once before the chain
// reads them in order: at draw q of the round (q = 1 .. BANK_W G from the
// lane's PCG state), the flight's -log(max(u, eps)) and, were it a
// scatter's e1, HG's cos and sin of the angle, were it e2, cos and sin of
// phi = 2 pi u.
struct Draw {
  float nl, cos_th, sin_th, cos_phi, sin_phi;
};

// Member m fills draws q = m + 1 + G r, r < BANK_W (at bank[q - 1]).
template <int G>
__device__ __forceinline__ void fill_bank(const Geo& g, unsigned mask, int m,
                                          const Jump (&J)[BANK_W], uint32_t rs, uint32_t inc,
                                          Draw* bank) {
  __syncwarp(mask);  // the last round's reads are done
#pragma unroll
  for (int r = 0; r < BANK_W; ++r) {
    const float u = uniform(jumped(J[r], rs, inc));
    Draw x;
    x.nl = -logf(jmax(u, EPS));
    hg(g.hg_g, u, x.cos_th, x.sin_th);
    const float phi = TWO_PI_F * u;
    x.cos_phi = cosf(phi);
    x.sin_phi = sinf(phi);
    bank[m + G * r] = x;
  }
  __syncwarp(mask);
}

// What a chain's member keeps of its evaluation: the pose and flight it taps
// from, and the lane's state after it (as if its tap accepted, where it
// taps).
struct Link {
  float o[3], d[3];     // the pose before the evaluation
  float os[3], nd[3];   // after its scatter
  float nrm[3];
  float t, max_t, bexit, isl;  // t: after the flight (t_adv), or the transit's exit
  long long bounce;     // before the evaluation
  uint32_t s_u1, s_end; // the PCG state at u1, and after the evaluation's draws
  bool isect, transit, capped;
};

// A chain round of a live two-level lane over up to D evaluations (see
// above); returns those taken and what the next round is.  Member m < n
// counts its evaluation at j + m.  Every member calls it.
template <int G, bool POW2, bool STATS>
__device__ __forceinline__ int chain_run(const Params& P, const Ptrs& Q, const Geo& g,
                                         unsigned mask, int m, const Jump (&JB)[BANK_W],
                                         Draw* bank, Lane& L, int D, int& next,
                                         unsigned* per_eval, long long cap, int j,
                                         Tally<STATS>& st) {
  const uint32_t inc = L.inc;
  const long long cb0 = st.now();
  fill_bank<G>(g, mask, m, JB, L.rs, inc, bank);
  st.add(ST_BANK_CYCLES, (unsigned)(st.now() - cb0));
  const Axis ax = axis_of(g, m % 3);
  const long long maxpath = P.i[IP_MAXPATH];
  const bool rr_on = P.i[IP_RR] != 0;
  int cq = 0;  // the draws the chain took so far
  float co[3], cd[3], cn[3];
  for (int a = 0; a < 3; ++a) {
    co[a] = L.o[a];
    cd[a] = L.d[a];
    cn[a] = L.nrm[a];
  }
  float ct = L.t, cmax = L.max_t, cbx = L.bexit, cisl = L.isl;
  bool ctrk = L.tracking;
  long long cb = L.bounce;
  uint32_t crs = L.rs;
  Link my = {};
  int n = 0;
  bool stopped = false;
  const long long c0 = st.now();
  for (int k = 0; k < D; ++k) {
    // all that evaluation k may need, from the chain's state alone and with
    // no branch before its one test, so the box test, the probe's divisions
    // and brick row, the flight's logf and the scatter's HG direction
    // overlap: a segment start (from inside the box), the probe (not into
    // an empty brick), the step (an overrun is a boundary event), and past
    // the tap (assumed to accept) the scatter, the cap and RR's draw
    const bool seg = !ctrk;
    const float t0 = seg ? 0.0f : ct;
    const AxisStep xs = axis_step<POW2>(ax, g.epsw, co, cd, t0, seg);
    float t_axis[3];
    long long bi[3];
    for (int a = 0; a < 3; ++a) {
      t_axis[a] = group_shfl<G>(mask, xs.t_axis, a);
      bi[a] = group_shfl<G>(mask, xs.b, a);
    }
    bool entered = true;  // a segment start from inside the box
    float max0 = cmax, hnrm[3] = {cn[0], cn[1], cn[2]};
    if (seg) {
      float ttop[3], tbot[3];
      for (int a = 0; a < 3; ++a) {
        ttop[a] = group_shfl<G>(mask, xs.ttop, a);
        tbot[a] = group_shfl<G>(mask, xs.tbot, a);
      }
      const BoxHit h = slabs_hit(ttop, tbot);
      const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
      entered = hit && sum3(h.nrm[0] * cd[0], h.nrm[1] * cd[1], h.nrm[2] * cd[2]) > 0.0f;
      max0 = h.dist;
      for (int a = 0; a < 3; ++a) hnrm[a] = h.nrm[a];
    }
    const float bx0 = seg ? -1.0f : cbx;
    const bool probe = t0 >= bx0;
    // the probe from the axes: the brick row, the exit, the majorant
    const long long bflat = (bi[2] * g.nby + bi[1]) * g.nbx + bi[0];
    const float2 row = __ldg(g.btab + bflat);
    float exit_t = INFINITY;
    for (int a = 0; a < 3; ++a) exit_t = nmin(exit_t, t_axis[a]);
    const float exit_new = nmax(exit_t, t0 + g.epsw);
    const float isl_new = __ldg(g.risl + bflat);
    const float bx = probe ? exit_new : bx0;
    const float isl = probe ? isl_new : cisl;
    const uint32_t s_u1 = pcg_next(crs, inc);
    const float t_adv = t0 + bank[cq].nl * isl;
    const bool transit = t_adv >= nmin(bx, max0);
    const uint32_t s_u2 = pcg_next(pcg_next(s_u1, inc), inc);
    const uint32_t s_e2 = pcg_next(pcg_next(s_u2, inc), inc);
    const Draw e1 = bank[cq + 3], e2 = bank[cq + 4];
    float os[3], nd[3];
    for (int a = 0; a < 3; ++a) os[a] = co[a] + cd[a] * t_adv - cd[a] * EPS;
    turn(cd, e1.sin_th * e2.cos_phi, e1.sin_th * e2.sin_phi, e1.cos_th, nd);
    const bool capped = !transit && cb + 1 >= maxpath;
    const bool rr = rr_on && !capped;
    const uint32_t s_end = transit ? s_u1 : (rr ? pcg_next(s_e2, inc) : s_e2);
    if (!entered || (probe && row.x <= 0.0f) ||
        (transit && max0 <= bx)) {
      stopped = true;
      break;
    }
    const bool me = k == m;
    for (int a = 0; a < 3; ++a) {
      my.o[a] = me ? co[a] : my.o[a];
      my.d[a] = me ? cd[a] : my.d[a];
      my.os[a] = me ? os[a] : my.os[a];
      my.nd[a] = me ? nd[a] : my.nd[a];
      cn[a] = hnrm[a];
      my.nrm[a] = me ? cn[a] : my.nrm[a];
    }
    my.t = me ? (transit ? bx : t_adv) : my.t;
    my.max_t = me ? max0 : my.max_t;
    my.bexit = me ? bx : my.bexit;
    my.isl = me ? isl : my.isl;
    my.bounce = me ? cb : my.bounce;
    my.s_u1 = me ? s_u1 : my.s_u1;
    my.s_end = me ? s_end : my.s_end;
    my.isect = me ? seg : my.isect;
    my.transit = me ? transit : my.transit;
    my.capped = me ? capped : my.capped;
    n = k + 1;
    // the state evaluation k leaves: on at the brick's exit after a
    // transit, else a new segment from the scatter
    for (int a = 0; a < 3; ++a) {
      co[a] = transit ? co[a] : os[a];
      cd[a] = transit ? cd[a] : nd[a];
    }
    ct = transit ? bx : t_adv;
    cmax = max0;
    cbx = bx;
    cisl = isl;
    ctrk = transit;
    cb = transit ? cb : cb + 1;
    crs = s_end;
    cq += transit ? 1 : (rr ? BANK_W : BANK_W - 1);
    if (capped) break;
  }
  st.add(ST_CHAIN_STEPS, n + (stopped ? 1 : 0));
  st.add(ST_CHAIN_CYCLES, (unsigned)(st.now() - c0));
  if (n == 0) {
    next = NEXT_ONE;
    st.add(ST_CHAIN_STOPS, 1);
    return 0;
  }

  const long long c1 = st.now();
  // every member taps and tests its evaluation at once
  const bool mine = m < n && !my.transit;
  bool rejected = false;
  float alb[3] = {0.0f, 0.0f, 0.0f}, u_rr = 0.0f;
  uint32_t s_u2 = 0u;
  if (mine) {
    const uint32_t s_bits = pcg_next(my.s_u1, inc);
    s_u2 = pcg_next(s_bits, inc);
    const long long flat = tap_at(g, my.o, my.d, my.t, pcg_bits(s_bits));
    const float rho = tap_rho(P, Q, flat);
    rejected = g.scale * rho * my.isl < uniform(s_u2);
    if (!rejected) tap_albedo(P, Q, flat, rho, alb);
    u_rr = uniform(my.s_end);  // RR's draw where it is taken
  }
  const int rej = first_stop<G>(mask, m, n, rejected);
  const int limit = rej < 0 ? n : rej;
  const long long c2 = st.now();
  st.add(ST_TAP_CYCLES, (unsigned)(c2 - c1));

  // the throughput chain over the scatters before the first rejection, a
  // member holding component m % 3 (one division a link where three would
  // run in turn)
  const int ca = m % 3;
  const unsigned scats = group_ballot<G>(mask, mine);
  const unsigned caps = group_ballot<G>(mask, m < n && my.capped);
  float* links = (float*)bank;  // the bank is read: each member's albedo and RR uniform
  __syncwarp(mask);
  links[4 * m + 0] = alb[0];
  links[4 * m + 1] = alb[1];
  links[4 * m + 2] = alb[2];
  links[4 * m + 3] = u_rr;
  __syncwarp(mask);
  float tpa = pick3(L.tp, ca);
  int died = -1;
  float ak = links[ca], uk = links[3];  // link k's, read a link ahead
  for (int k = 0; k < limit; ++k) {
    const float a_k = ak, u_k = uk;
    ak = links[4 * (k + 1) + ca];
    uk = links[4 * (k + 1) + 3];
    if (!((scats >> k) & 1u)) continue;
    tpa = tpa * a_k;
    if ((caps >> k) & 1u) {
      died = k;
      break;
    }
    if (rr_on) {
      float tk[3];
      for (int a = 0; a < 3; ++a) tk[a] = group_shfl<G>(mask, tpa, a);
      const float p = nmin(nmax(nmax(tk[0], tk[1]), tk[2]), 1.0f);
      if (u_k > p) {
        died = k;
        break;
      }
      const float q = nmax(p, 1e-20f);
      tpa = tpa / q;
    }
  }
  float tp[3];
  for (int a = 0; a < 3; ++a) tp[a] = group_shfl<G>(mask, tpa, a);
  st.add(ST_TP_CYCLES, (unsigned)(st.now() - c2));
  const int taken = died >= 0 ? died + 1 : (rej >= 0 ? rej + 1 : n);

  // the lane's state after the round: member taken - 1's evaluation
  const bool scattered = mine && !rejected;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = scattered ? my.os[a] : my.o[a];
    d[a] = scattered ? my.nd[a] : my.d[a];
  }
  const uint32_t rs = scattered ? my.s_end : (mine ? s_u2 : my.s_u1);
  const int src = taken - 1;
  for (int a = 0; a < 3; ++a) {
    L.o[a] = group_shfl<G>(mask, o[a], src);
    L.d[a] = group_shfl<G>(mask, d[a], src);
    L.nrm[a] = group_shfl<G>(mask, my.nrm[a], src);
    L.tp[a] = tp[a];
  }
  L.t = group_shfl<G>(mask, my.t, src);
  L.max_t = group_shfl<G>(mask, my.max_t, src);
  L.bexit = group_shfl<G>(mask, my.bexit, src);
  L.isl = group_shfl<G>(mask, my.isl, src);
  L.bounce = group_shfl<G>(mask, my.bounce + (scattered ? 1 : 0), src);
  L.rs = group_shfl<G>(mask, rs, src);
  L.tracking = group_shfl<G>(mask, (int)!scattered, src) != 0;
  if (died >= 0) {
    L.alive = false;
    L.sd = L.sd + 1;
  }
  if (m < taken) count_eval(per_eval, cap, j + m, my.isect, !scattered);
  next = died >= 0 ? NEXT_CHAIN : (rej >= 0 ? NEXT_NULL : (stopped ? NEXT_ONE : NEXT_CHAIN));
  st.add(ST_CHAIN_DIED, died >= 0 ? 1 : 0);
  st.add(ST_CHAIN_REJECTS, died < 0 && rej >= 0 ? 1 : 0);
  st.add(ST_CHAIN_STOPS, died < 0 && rej < 0 && stopped ? 1 : 0);
  return taken;
}

// One round of the lane this thread's group of G holds, every member alike
// (a null run, a chain, or one evaluation, as the last round left `next`):
// j, the lane's evaluations in this launch, advances by those it took.
template <int G, bool POW2, bool STATS>
__device__ __forceinline__ void one_round(const Params& P, const Ptrs& Q, const Geo& g, int m,
                                          Draw* bank, Lane& L, int& j, int& next,
                                          unsigned* per_eval, long long cap,
                                          Tally<STATS>& st) {
  const unsigned mask = group_mask<G>();
  const int64_t* table = (const int64_t*)Q.p[S_JUMP];
  const bool two = P.i[IP_TWO_LEVEL] != 0;
  const int D = (int)(cap - j < G ? cap - j : G);
  const bool live = L.alive && L.bounce < P.i[IP_MAXPATH];
  const bool can_null = live && L.tracking && !(two && L.t >= L.bexit);
  int n;
  if (next != NEXT_ONE && can_null && (next == NEXT_NULL || !two)) {
    n = null_run<G>(P, Q, g, mask, m, null_jump<3>(table, JUMP_N1, m), L, D, next);
    if (m < n) count_eval(per_eval, cap, j + m, false, true);
    st.add(ST_NULL_ROUNDS, 1);
    st.add(ST_NULL_EVALS, n);
  } else if (next != NEXT_ONE && two && live) {
    Jump JB[BANK_W];  // this member's draws of the round's bank
    for (int r = 0; r < BANK_W; ++r) JB[r] = jump_of(table, JUMP_N1, m + 1 + G * r);
    n = chain_run<G, POW2, STATS>(P, Q, g, mask, m, JB, bank, L, D, next, per_eval, cap, j, st);
    st.add(ST_CHAIN_ROUNDS, 1);
    st.add(ST_CHAIN_EVALS, n);
  } else {
    const bool isect = evaluate<false>(P, Q, L);
    if (m == 0) count_eval(per_eval, cap, j, isect, L.tracking);
    n = 1;
    next = two ? NEXT_CHAIN : NEXT_NULL;
    st.add(ST_ONE, 1);
  }
  j += n;
}

// The last stage's lanes each run to their end (or to the cap) in rounds, a
// group of DRAIN_GROUP threads a lane (IP_LOOK); a lane's member 0 stores it
// and reports it to the drain's end, and with STATS its counts.
template <bool POW2, bool STATS>
__global__ void __maxnreg__(168) drain_kernel(Params P, Ptrs Q, int width) {
  constexpr int G = DRAIN_GROUP;
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned* per_eval = (unsigned*)Q.p[S_EVALS];  // [isect: cap][busy: cap]
  unsigned* stats = (unsigned*)Q.p[S_STATS];
  const long long cap = P.i[IP_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = tid / G, m = tid % G;
  __shared__ Draw banks[BANK_THREADS * BANK_W];
  Draw* bank = banks + (threadIdx.x - m) * BANK_W;  // this group's
  const Geo g = geo_of(P, Q);
  Tally<STATS> st;
  const long long c0 = st.now();
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false;
  if (i < width) {  // the whole group alike
    Lane L;
    load_lane(P, Q, i, L);
    if (pending_of(P, L)) {
      int next = P.i[IP_TWO_LEVEL] ? NEXT_CHAIN : NEXT_NULL;
      do {
        one_round<G, POW2, STATS>(P, Q, g, m, bank, L, j, next, per_eval, cap, st);
      } while (j < cap && pending_of(P, L));
      left = pending_of(P, L);
      finished = !left;
      if (m == 0) {
        store_lane(P, Q, i, L);
        st.store(stats, i, c0);
      }
    }
  }
  if (m != 0) {  // a lane reports once
    j = 0;
    left = finished = false;
  }
  DrainEnd end;
  if (!drain_end(ctrl, e0, P.i[IP_CHAIN], j, left, finished, end)) return;
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

template <bool POW2>
void launch_rounds(const Params& P, const Ptrs& Q, int width, int threads, cudaStream_t st) {
  const int blocks = (int)(((long long)width * DRAIN_GROUP + threads - 1) / threads);
  if (Q.p[S_STATS] != nullptr) {
    drain_kernel<POW2, true><<<blocks, threads, 0, st>>>(P, Q, width);
  } else {
    drain_kernel<POW2, false><<<blocks, threads, 0, st>>>(P, Q, width);
  }
}

// Whether every extent and brick size is a power of two (drain_kernel's
// POW2).
bool pow2_geometry(const float* f) {
  for (int k = 0; k < 6; ++k) {
    const float x = f[k < 3 ? FP_EXT + k : FP_BSIZE + k - 3];
    int e = 0;
    if (!(x > 0.0f) || !std::isfinite(x) || std::frexp(x, &e) != 0.5f) return false;
  }
  return true;
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

// The last stage's drain with `threads` (32, 64, 128 or 256) per block: with
// IP_LOOK = DRAIN_GROUP in rounds (drain_kernel), ptrs[S_JUMP] the (2,
// JUMP_N1) jump table, ptrs[S_STATS] null or the per-lane counts; with
// IP_LOOK 0 a thread a lane (thread_drain_kernel).  The control words zero
// at the stage's start, the per-evaluation counts (2 * IP_CAP uint32) zero
// before each launch (each launch leaves them zero).
extern "C" int fastbody_drain(const float* fparams, int n_fp, const long long* iparams,
                              int n_ip, void* const* ptrs, int n_s, int width, int threads,
                              void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width <= 0) return 0;
  const Params P = params_of(fparams, iparams);
  const Ptrs Q = ptrs_of(ptrs);
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads != 32 && threads != 64 && threads != 128 && threads != 256) return -1;
  const long long look = P.i[IP_LOOK];
  if (look != 0) {
    if (look != DRAIN_GROUP || P.i[IP_SPEC] != 1 || P.i[IP_DEFER] != 0 ||
        Q.p[S_JUMP] == nullptr)
      return -1;
    if (P.i[IP_TWO_LEVEL] && (Q.p[S_RISL] == nullptr || Q.p[S_PLANES] == nullptr)) return -1;
    if (P.i[IP_TWO_LEVEL] != 0 && pow2_geometry(fparams)) {
      launch_rounds<true>(P, Q, width, threads, st);
    } else {
      launch_rounds<false>(P, Q, width, threads, st);
    }
    return (int)cudaGetLastError();
  }
  const int blocks = (width + threads - 1) / threads;
  switch (threads) {
    case 32: thread_drain_kernel<32><<<blocks, 32, 0, st>>>(P, Q, width); break;
    case 64: thread_drain_kernel<64><<<blocks, 64, 0, st>>>(P, Q, width); break;
    case 128: thread_drain_kernel<128><<<blocks, 128, 0, st>>>(P, Q, width); break;
    case 256: thread_drain_kernel<256><<<blocks, 256, 0, st>>>(P, Q, width); break;
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
