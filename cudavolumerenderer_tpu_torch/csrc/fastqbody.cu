// fastqbody.cu — one evaluation of fastQ's queue-fed wavefront body for every
// lane of a pool, and its drain, for Hopper (sm_90a).
//
// Replaces the body of cudavolumerenderer_tpu/models/fastq.py:148 (render_tile's
// `body`, which XLA compiled into one device program under its lax.while_loop,
// :402; it is no Pallas kernel).  It computes what the port's eager body
// (models/fastq.py `plain_body`, the plain version) computes on the card, bit
// for bit, in the same order; per lane, at loop iteration e:
//   1. the flush (:159-182): at e % 8 == 7, and on every iteration once the
//      queue is empty, a parked (pixel, radiance) is added into the image and
//      the lane's pending slot freed;
//   2. the queue refill (:185-238), at e % 4 == 0: the k-th refillable lane
//      (dead, no pending result) of the pool in lane order takes path id
//      paths_issued + k while ids last, a fresh (seed, path id) PCG stream
//      and its jittered camera ray (2 draws);
//   3. the segment start: the AABB slab test of a live lane not tracking (a
//      miss adds throughput * Le and ends the path; an inside hit starts
//      tracking; an outside hit is a boundary event now);
//   4. one tracking step (:262-316): two-level (the brick majorant and the
//      brick's DDA exit when the lane leaves its brick, a flight under the
//      brick's majorant or, in an empty brick, a leap to its exit, the
//      crossing test) or single-level (under the global majorant);
//   5. the stochastic tap into make_fused_grid's table (flat density, or the
//      'full' rows) and the acceptance test (:317-340), the tap's albedo;
//   6. a boundary event (GGX or the null BSDF), or an HG scatter;
//   7. Russian roulette after an event;
//   8. finish_path's parking (:136): a path that ended moves its (pixel,
//      radiance) to the lane's pending slot.
// Every draw is taken only under the eager body's mask, so each path's stream
// is the plain version's.
//
// Two launches run the body (ops/fastqbody.py):
//   * body_kernel, one evaluation of every lane: one thread per lane, the
//     QState tensors read and written in place (SoA; int64 words holding the
//     u32 RNG) or into another pool.  The refill's ranks are a block scan and
//     a decoupled look-back over the blocks in start-ticket order
//     (common.cuh queue_rank), so the flush, the refill and the rest of the
//     evaluation are one launch.  The counts (segment starts, tracking lanes,
//     whether the loop ran, paths taken) reduce per block and across blocks
//     with atomics; the last block adds n_rays, n_iters and n_busy once each
//     in float32 and advances paths_issued.  Gated (a stage's control words
//     given): the evaluation index is the words' C_EVAL, and a launch returns
//     untouched once the queue is empty (C_COUNT, paths not yet issued, at
//     0); the host enqueues evaluations in batches (ops/stages.py).
//   * drain_kernel, once the queue is empty: a refill takes nothing and the
//     flush runs on every iteration, so a lane depends on no other lane.
//     Each lane loads once, runs evaluations in registers until it is dead
//     with no pending result (a fixed point of the body), and stores once;
//     per evaluation its segment start and tracking flag go by warp-
//     aggregated atomics into arrays indexed by the evaluation, and the last
//     block folds them into n_rays, n_iters and n_busy in float32, one
//     evaluation after another, as the loop adds them.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;
constexpr int DRAIN_THREADS = 64;
constexpr long long FLUSH_EVERY = 8;   // models/fastq.py FLUSH_EVERY
constexpr long long REFILL_EVERY = 4;  // models/fastq.py REFILL_EVERY

// Float parameters (ops/fastqbody.py FP_*).
enum {
  FP_TILEX = 0, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY,
  FP_CAM,  // the camera's (3, 4) inv_view, row-major: 12 values
  FP_R2VX = FP_CAM + 12, FP_R2VY,
  FP_BMIN, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3, FP_RM1 = FP_EXT + 3,
  FP_SCALE = FP_RM1 + 3, FP_INV_SIGMAT, FP_G, FP_LE,
  FP_ALB_A = FP_LE + 3, FP_ALB_B = FP_ALB_A + 3,
  FP_EPSW = FP_ALB_B + 3, FP_BSIZE,
  FP_ROUGH = FP_BSIZE + 3, FP_ETA = FP_ROUGH + 2, FP_INV_ETA, N_FP,
};

// Integer parameters (ops/fastqbody.py IP_*).
enum {
  IP_NPATHS = 0, IP_NPIX, IP_TW, IP_BASE, IP_SEEDH, IP_NX, IP_NY, IP_NZ,
  IP_TWO_LEVEL, IP_TABLE, IP_ALBEDO, IP_BSDF, IP_MITSUBA, IP_RR,
  IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ,
  IP_IT,   // the evaluation index of a launch that is not gated
  IP_CAP,  // the drain's evaluations per lane and launch
  N_IP,
};

// Pointer slots (ops/fastqbody.py S_*): the per-lane fields in QState's
// order (the RNG's two words split), the outputs (the same again), then
// paths_issued in and out, the counters (n_rays, n_iters, n_busy) in and
// out, the image, the fused table, the brick majorants, the scratch, the
// look-back words, a stage's control words and the drain's per-evaluation
// counts (null where a launch uses none).
enum {
  S_O = 0, S_D, S_TP, S_RAD, S_PRAD, S_NRM, S_T, S_MAXT, S_ISL, S_BEXIT,
  S_IMG, S_PEND, S_ALIVE, S_TRACK, S_RS, S_RINC,
  N_LANE,
  S_OUT = N_LANE, S_ISSUED = S_OUT + N_LANE, S_ISSUED_OUT, S_COUNTS,
  S_COUNTS_OUT, S_ACCUM, S_TABLE, S_BMAJ, S_SCRATCH, S_STATUS, S_CTRL,
  S_EVALS, N_S,
};

// The scratch's uint64 words: the counts, whether any lane was busy at the
// start, the last-block ticket, the start ticket and the paths taken.  Zero
// before and after a launch.
enum { SC_RAYS = 0, SC_BUSY, SC_MORE, SC_TICKET, SC_START, SC_TAKES, N_SCRATCH };

// Table layouts (IP_TABLE) and albedo modes (IP_ALBEDO): common.cuh's.
static_assert(FUSED_F32 == 0 && FUSED_ROWS == 1, "common.cuh's fused layouts");
static_assert(ALBEDO_CONST == 0 && ALBEDO_AFFINE == 1 && ALBEDO_ROW == 2,
              "common.cuh's albedo modes");

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// One lane, in registers.
struct Lane {
  float o[3], d[3], tp[3], rad[3], prad[3], nrm[3];
  float t, maxt, isl, bexit;
  long long img, pend;
  bool alive, trk;
  uint32_t rs, inc;
};

__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, Lane& L) {
  float* v3[6] = {L.o, L.d, L.tp, L.rad, L.prad, L.nrm};
  for (int f = 0; f < 6; ++f) {
    const float* src = (const float*)Q.p[S_O + f];
    for (int k = 0; k < 3; ++k) v3[f][k] = src[3 * i + k];
  }
  L.t = ((const float*)Q.p[S_T])[i];
  L.maxt = ((const float*)Q.p[S_MAXT])[i];
  L.isl = ((const float*)Q.p[S_ISL])[i];
  L.bexit = ((const float*)Q.p[S_BEXIT])[i];
  L.img = ((const long long*)Q.p[S_IMG])[i];
  L.pend = ((const long long*)Q.p[S_PEND])[i];
  L.alive = ((const bool*)Q.p[S_ALIVE])[i];
  L.trk = ((const bool*)Q.p[S_TRACK])[i];
  L.rs = (uint32_t)((const long long*)Q.p[S_RS])[i];
  L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
}

__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, const Lane& L) {
  const float* v3[6] = {L.o, L.d, L.tp, L.rad, L.prad, L.nrm};
  for (int f = 0; f < 6; ++f) {
    float* dst = (float*)Q.p[S_OUT + S_O + f];
    for (int k = 0; k < 3; ++k) dst[3 * i + k] = v3[f][k];
  }
  ((float*)Q.p[S_OUT + S_T])[i] = L.t;
  ((float*)Q.p[S_OUT + S_MAXT])[i] = L.maxt;
  ((float*)Q.p[S_OUT + S_ISL])[i] = L.isl;
  ((float*)Q.p[S_OUT + S_BEXIT])[i] = L.bexit;
  ((long long*)Q.p[S_OUT + S_IMG])[i] = L.img;
  ((long long*)Q.p[S_OUT + S_PEND])[i] = L.pend;
  ((bool*)Q.p[S_OUT + S_ALIVE])[i] = L.alive;
  ((bool*)Q.p[S_OUT + S_TRACK])[i] = L.trk;
  ((long long*)Q.p[S_OUT + S_RS])[i] = (long long)L.rs;
  ((long long*)Q.p[S_OUT + S_RINC])[i] = (long long)L.inc;
}

// The loop's condition for one lane: a path in flight or a pending result.
__device__ __forceinline__ bool pending_of(const Lane& L) { return L.alive || L.pend >= 0; }

// fastq._flush of one lane: its parked radiance into its pixel, the slot
// freed.
__device__ __forceinline__ void flush(const Ptrs& Q, Lane& L) {
  if (L.pend >= 0) {
    float* acc = (float*)Q.p[S_ACCUM] + 3 * L.pend;
    for (int k = 0; k < 3; ++k) atomicAdd(acc + k, L.prad[k]);
  }
  for (int k = 0; k < 3; ++k) L.prad[k] = 0.0f;
  L.pend = -1;
}

// regeneration.queue_refill for a lane that takes path id pid: its pixel, its
// (seed, path id) stream and camera ray, a fresh throughput and radiance.
__device__ __forceinline__ void start_path(const Params& P, Lane& L, long long pid) {
  L.img = pid % P.i[IP_NPIX];
  float px, py;
  pixel_of(L.img, P.i[IP_TW], P.f[FP_INV_TW], P.f[FP_TILEX], P.f[FP_TILEY], px, py);
  path_stream((uint32_t)(pid + P.i[IP_BASE]), (uint32_t)P.i[IP_SEEDH], L.rs, L.inc);
  camera_ray(P.f + FP_CAM, P.f[FP_R2VX], P.f[FP_R2VY], P.f[FP_INV_RESX], P.f[FP_INV_RESY], px,
             py, L.rs, L.inc, L.o, L.d);
  for (int k = 0; k < 3; ++k) {
    L.tp[k] = 1.0f;
    L.rad[k] = 0.0f;
  }
  L.alive = true;
  L.trk = false;
}

// The brick probe of a tracking lane that left its brick (t >= brick_exit):
// the brick's exit along the ray and its reciprocal majorant (inf for an
// empty brick).
__device__ __forceinline__ void brick_probe(const Params& P, const Ptrs& Q, Lane& L) {
  const float tt = L.t + P.f[FP_EPSW];
  const long long hi[3] = {P.i[IP_HIX], P.i[IP_HIY], P.i[IP_HIZ]};
  long long bi[3];
  float bound[3];
  for (int a = 0; a < 3; ++a) {
    const float p = L.o[a] + tt * L.d[a];
    const float coord =
        jclip((p - P.f[FP_BMIN + a]) / P.f[FP_EXT + a], 0.0f, 1.0f) * P.f[FP_RM1 + a];
    long long b = (long long)floorf(coord / P.f[FP_BSIZE + a]);
    b = b < 0 ? 0 : b;
    bi[a] = b < hi[a] ? b : hi[a];
    const float up = L.d[a] > 0.0f ? 1.0f : 0.0f;
    const float bound_coord = ((float)bi[a] + up) * P.f[FP_BSIZE + a];
    bound[a] = P.f[FP_BMIN + a] + P.f[FP_EXT + a] * bound_coord / P.f[FP_RM1 + a];
  }
  const long long bflat = (bi[2] * P.i[IP_NBY] + bi[1]) * P.i[IP_NBX] + bi[0];
  const float rho_b = ((const float*)Q.p[S_BMAJ])[bflat];
  L.bexit = dda_exit(bound, L.o, L.d, tt);
  L.isl = rho_b > 0.0f ? (1.0f / (P.f[FP_SCALE] * jmax(rho_b, 1e-30f))) * 1.0f : INFINITY;
}

// The evaluation of one lane after the flush and the refill (alive is the
// lane's state after the refill); returns whether it started a segment
// (counted in n_rays).  Afterwards L.trk is the lane's count in n_busy.
__device__ __forceinline__ bool evaluate(const Params& P, const Ptrs& Q, Lane& L) {
  const bool alive0 = L.alive;

  // --- segment start ----------------------------------------------------
  const bool need_isect = L.alive && !L.trk;
  bool boundary_now = false;
  float dist = 0.0f;
  if (need_isect) {
    const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, L.o, L.d);
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    dist = h.dist;
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.rad[k] = L.rad[k] + L.tp[k] * P.f[FP_LE + k];
      L.alive = false;
    }
    if (hit && inside) {
      L.trk = true;
      L.t = 0.0f;
      L.maxt = h.dist;
      L.bexit = -1.0f;
    }
    boundary_now = hit && !inside;
    for (int k = 0; k < 3; ++k) L.nrm[k] = h.nrm[k];
  }

  // --- one tracking step --------------------------------------------------
  const float scale = P.f[FP_SCALE];
  bool overran = false, inside = false;
  float t_new = L.t, isig;
  if (P.i[IP_TWO_LEVEL]) {
    if (L.trk) {
      if (L.t >= L.bexit) brick_probe(P, Q, L);
      const bool empty = !isfinite(L.isl);
      float t_cand = L.bexit;
      if (!empty) {
        const float u1 = draw_float(L.rs, L.inc);
        t_cand = L.t + -logf(jmax(u1, EPS)) * L.isl;
      }
      const bool crossed = t_cand >= jmin(L.bexit, L.maxt);
      overran = crossed && L.maxt <= L.bexit;
      inside = !empty && !crossed;
      t_new = crossed && !overran ? L.bexit : t_cand;
    }
    isig = L.isl;
  } else {
    isig = P.f[FP_INV_SIGMAT];
    if (L.trk) {
      const float u1 = draw_float(L.rs, L.inc);
      t_new = L.t + -logf(jmax(u1, EPS)) * isig;
      overran = t_new > L.maxt;
      inside = !overran;
    }
  }

  // --- the stochastic tap and the acceptance test -------------------------
  bool scattered = false;
  float alb[3] = {0.0f, 0.0f, 0.0f};
  if (inside) {
    const uint32_t bits = draw_bits(L.rs, L.inc);
    const long long flat = tap_flat(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RM1, P.i + IP_NX,
                                    false, L.o, L.d, t_new, bits);
    const void* table = Q.p[S_TABLE];
    const float rho = fused_rho(table, (int)P.i[IP_TABLE], 0, 0.0f, flat);
    const float u2 = draw_float(L.rs, L.inc);
    scattered = !(scale * rho * isig < u2);
    if (scattered) {
      fused_albedo((int)P.i[IP_ALBEDO], P.f + FP_ALB_A, P.f + FP_ALB_B, table, nullptr, 0, flat,
                   rho, alb);
    }
  }
  L.t = t_new;
  L.trk = L.trk && !(overran || scattered);

  // --- boundary event, or the scatter with the tap's albedo ----------------
  const bool boundary = boundary_now || overran;
  if (boundary) {
    const Ggx G = {P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
                   P.i[IP_MITSUBA] != 0};
    boundary_event(P.i[IP_BSDF] != 0, G, L.nrm, boundary_now ? dist : L.maxt, L.o, L.d, L.tp,
                   L.rs, L.inc);
  }
  if (scattered) {
    float os[3], nd[3];
    for (int k = 0; k < 3; ++k) os[k] = L.o[k] + L.d[k] * L.t - L.d[k] * EPS;
    const float e1 = draw_float(L.rs, L.inc);
    const float e2 = draw_float(L.rs, L.inc);
    float cos_th, sin_th;
    hg(P.f[FP_G], e1, cos_th, sin_th);
    const float phi = TWO_PI_F * e2;
    turn(L.d, sin_th * cosf(phi), sin_th * sinf(phi), cos_th, nd);
    for (int k = 0; k < 3; ++k) {
      L.o[k] = os[k];
      L.d[k] = nd[k];
      L.tp[k] = L.tp[k] * alb[k];
    }
  }

  // --- Russian roulette after an event, then finish_path's parking --------
  if (P.i[IP_RR] && L.alive && (scattered || boundary) && roulette_kills(L.tp, L.rs, L.inc))
    L.alive = false;
  if (alive0 && !L.alive && L.pend < 0) {
    for (int k = 0; k < 3; ++k) {
      L.prad[k] = L.rad[k];
      L.rad[k] = 0.0f;
    }
    L.pend = L.img;
    L.img = -1;
  }
  return need_isect;
}

// One evaluation of every lane at iteration e (IP_IT, or C_EVAL when gated).
__global__ void __launch_bounds__(THREADS) body_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  long long e = P.i[IP_IT];
  if (ctrl != nullptr) {
    if (stage_stopped(ctrl, 1, 0)) return;  // the queue is empty: the drain's
    e = ctrl[C_EVAL];
  }
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  const int b = start_ticket(scratch + SC_START);  // the look-back's order
  const int i = b * THREADS + threadIdx.x;
  const long long n_paths = P.i[IP_NPATHS];
  const long long issued = *(const long long*)Q.p[S_ISSUED];
  const bool refill = e % REFILL_EVERY == 0;
  Lane L;
  bool busy0 = false, refillable = false, takes = false, isect = false, busy = false;
  if (i < width) {
    load_lane(Q, i, L);
    busy0 = pending_of(L);
    if (e % FLUSH_EVERY == FLUSH_EVERY - 1 || issued >= n_paths) flush(Q, L);
    refillable = !L.alive && L.pend < 0;
  }
  if (refill) {  // uniform over the grid
    const long long pid =
        issued + queue_rank<THREADS>(refillable, b, (unsigned long long*)Q.p[S_STATUS]);
    takes = refillable && pid < n_paths;
    if (takes) start_path(P, L, pid);
  }
  if (i < width) {
    isect = evaluate(P, Q, L);
    busy = L.trk;
    store_lane(Q, i, L);
  }
  const int n_isect = __syncthreads_count(isect);
  const int n_busy = __syncthreads_count(busy);
  const int n_more = __syncthreads_count(busy0);
  const int n_takes = __syncthreads_count(takes);
  if (threadIdx.x != 0) return;
  atomicAdd(scratch + SC_RAYS, (unsigned long long)n_isect);
  atomicAdd(scratch + SC_BUSY, (unsigned long long)n_busy);
  atomicAdd(scratch + SC_MORE, (unsigned long long)n_more);
  atomicAdd(scratch + SC_TAKES, (unsigned long long)n_takes);
  if (!last_block(scratch + SC_TICKET)) return;  // the last block: every count is in
  const unsigned long long rays = atomicAdd(scratch + SC_RAYS, 0ull);
  const unsigned long long busy_all = atomicAdd(scratch + SC_BUSY, 0ull);
  const bool more = atomicAdd(scratch + SC_MORE, 0ull) > 0 || issued < n_paths;
  const long long issued_new = issued + (long long)atomicAdd(scratch + SC_TAKES, 0ull);
  const float* ci = (const float*)Q.p[S_COUNTS];
  float* co = (float*)Q.p[S_COUNTS_OUT];
  co[0] = ci[0] + (float)rays;
  co[1] = ci[1] + (more ? 1.0f : 0.0f);
  co[2] = ci[2] + (float)busy_all;
  *(long long*)Q.p[S_ISSUED_OUT] = issued_new;
  for (int k = 0; k < N_SCRATCH; ++k) scratch[k] = 0ull;
  if (refill) {
    unsigned long long* status = (unsigned long long*)Q.p[S_STATUS];
    for (unsigned k = 0; k < gridDim.x; ++k) status[k] = 0ull;
  }
  if (ctrl != nullptr) {
    ctrl[C_COUNT] = n_paths - issued_new;
    ctrl[C_EVAL] = e + 1;
  }
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

// Once the queue is empty: each lane runs to its end (or to the cap), in
// registers, flushing on every evaluation.
__global__ void __launch_bounds__(DRAIN_THREADS) drain_kernel(Params P, Ptrs Q, int width) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned* per_eval = (unsigned*)Q.p[S_EVALS];  // [isect: cap][busy: cap]
  const long long cap = P.i[IP_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const int i = blockIdx.x * DRAIN_THREADS + threadIdx.x;
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false;
  if (i < width) {
    Lane L;
    load_lane(Q, i, L);
    if (pending_of(L)) {
      do {
        flush(Q, L);
        const bool isect = evaluate(P, Q, L);
        warp_count(per_eval, j, isect);
        warp_count(per_eval + cap, j, L.trk);
        ++j;
      } while (j < cap && pending_of(L));
      store_lane(Q, i, L);
      left = pending_of(L);
      finished = !left;
    }
  }
  DrainEnd end;
  if (!drain_end(ctrl, e0, 1, j, left, finished, end)) return;
  // the last block: every lane's counts are in.  The loop's evaluations in
  // this launch: all of them while a lane is left, else up to the longest
  // lane's end
  const long long n_fold = end.left == 0 ? end.total - e0 : cap;
  float* counts = (float*)Q.p[S_COUNTS];
  float rays = counts[0], iters = counts[1], busy = counts[2];
  for (long long e = 0; e < n_fold; ++e) {
    rays = rays + (float)__ldcg(per_eval + e);
    iters = iters + 1.0f;
    busy = busy + (float)__ldcg(per_eval + cap + e);
  }
  counts[0] = rays;
  counts[1] = iters;
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

// Plain C entry points, loaded with ctypes (ops/fastqbody.py).  fparams
// (N_FP,) float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses,
// all in host memory and copied into the launch; width lanes.  Each returns
// cudaGetLastError(), or -1 when a size does not match this build's.

// body_kernel: the scratch (N_SCRATCH uint64) and the look-back words (one
// uint64 per block of 256 lanes) zero before the launch, and zero after it;
// with ptrs[S_CTRL] set, a gated evaluation of the queue's stage whose
// control words the host set at its start.
extern "C" int fastqbody_launch(const float* fparams, int n_fp, const long long* iparams,
                                int n_ip, void* const* ptrs, int n_s, int width,
                                void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    body_kernel<<<(width + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// drain_kernel: the control words zero at the drain's start but C_EVAL and
// C_LMAX (the evaluation it starts at), the per-evaluation counts (2 *
// IP_CAP uint32) zero before each launch (each launch leaves them zero).
extern "C" int fastqbody_drain(const float* fparams, int n_fp, const long long* iparams,
                               int n_ip, void* const* ptrs, int n_s, int width,
                               void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    drain_kernel<<<(width + DRAIN_THREADS - 1) / DRAIN_THREADS, DRAIN_THREADS, 0,
                   (cudaStream_t)stream>>>(params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_FP, N_IP, N_S, N_CTRL), for the
// wrapper's check.
extern "C" void fastqbody_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
