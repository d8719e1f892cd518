// familybody.cu — the bodies of the integrator-family schedulers (naiveSK,
// naiveMK, regenerationSK, streamingSK, sortingSK, streamingMK) for every
// lane of a pool, for Hopper (sm_90a).
//
// Replaces the loop bodies that XLA compiled into one device program under
// each scheduler's lax.while_loop (no Pallas kernel):
//   * cudavolumerenderer_tpu/models/integrator.py:237 `bounce_step` (under
//     `trace`'s loop, :350; Woodcock's own loop, ops/woodcock.py:87), the
//     body of naiveSK, naiveMK and regenerationSK;
//   * models/regeneration.py:30 `_regenerate` (its `queue_refill`) and
//     models/streaming.py:64 `_refill`, the deterministic work queue;
//   * models/streaming.py:217 `extend_step` and :363 `flush_pending`, the
//     body of streamingSK, sortingSK and streamingMK.
// Each computes what the port's eager torch function (the plain version)
// computes on the card, bit for bit, in the same order:
//   bounce  (integrator.bounce_step) per live lane: the AABB slab test, and
//           under the variable boundary the isosurface march from its hit
//           (integrator.py:92 `variable_boundary_adjust`: up to 4,096 steps
//           in registers, each a draw and a central-difference gradient of
//           six density lookups); a miss adds throughput * Le and ends the
//           path; inside the box the whole Woodcock chain in registers, in
//           lookahead rounds (below: flight, the density at o + t d, the
//           acceptance test, until an event or the exit); a boundary
//           event (GGX or the null BSDF) or an HG scatter with the albedo
//           at o + d t - d eps; Russian roulette.  With the splat on
//           (regenerationSK) a lane that died adds its radiance into
//           accum[image_id] and zeroes it.
//   refill  (queue_refill with _regenerate's group rule and _refill's field
//           resets): the k-th dead lane (a whole group of G lanes once all
//           are dead; lanes past the last whole group one by one) takes path
//           id paths_issued + k while ids last, a fresh (seed, path id) PCG
//           stream and its jittered camera ray; paths_issued stays on the
//           card.
//   extend  (streaming.extend_step): the segment start, one Woodcock step,
//           the boundary or scatter event, Russian roulette after an event,
//           the splat; with defer (sortingSK) a scatter records its fetch
//           point and stalls; flush (flush_pending) fetches the deferred
//           albedos and runs their Russian roulette.
// Grids are sampled as ops/grid.py does (common.cuh sample_grid, which
// nestedreplay.cu shares): 8 clamped taps lerped in its order ('trilinear')
// or the truncated point ('nearest'), over a dense float32 density and an
// albedo of 1 or >= 3 channels (the first 3 read).  Every draw
// is taken only under the eager function's mask, so each path's stream is
// the plain version's; a dead lane is a fixed point of bounce and extend.
//
// What bounds the bounce on this card: each lane's chain of dependent Woodcock
// steps (a flight draw and logf, eight taps at o + t d that cannot start before
// t is known, the acceptance draw and test), not bytes. One thread per lane
// running the whole chain took, on the H100, 35.4 / 36.5 / 61.0 / 143.7 us at
// 4,096 / 16,384 / 65,536 / 131,072 lanes of phase 25's smoke pools against
// byte bounds of 0.16 / 0.64 / 2.57 / 5.06 us, and 81-96 us per bounce of the
// naiveSK drain's longest lane. Its time hardly grows from 4,096 to 16,384
// lanes: the pool waits for its longest chain (55-214 steps there; ~66 a lane
// on the medical class's first bounce, whose grid is 73% empty), and at 4,096
// lanes 16 of the 132 SMs hold all of it. The rounds below took 10.3 / 19.6 /
// 43.4 / 88.5 us and 55-59 us a drain bounce there (PERF.md).
//
// The design: lookahead rounds (tailpk.cu's null runs, common.cuh's jumps,
// run_sum and first_stop).  A step's draws are known before its density
// is, and every step of a chain is taken in full (the one crossing dist
// too), so a lookahead group of G threads takes G steps of a chain at once:
// member j jumps to draws 2 j + 1 and 2 j + 2 (ops/rng.jump_constants),
// forms t_j as the eager loop's left-to-right sum over the steps shared by
// shuffles, reads its eight taps and tests its step; a ballot finds the
// first step that crosses or accepts, and the lane takes that step's t and
// PCG state (a round without one goes on from its last step).  A group
// holds M lanes, each computed alike by G / M threads, and takes their
// chains in turn: M = 1 gives each lane all G threads (the least latency,
// G / M-fold redundant work outside the chains), M = G one thread a lane
// (no redundancy; the group's chains one after another).  The rest of the
// bounce, the boundary event, the HG scatter, the albedo, Russian roulette
// and the march, is computed by a lane's threads on the same values, and
// its first thread splats, stores and counts the lane.  The width rule
// (ops/familybody.lookahead, measured by chip_smoke.family_sweep) picks G
// and M by the pool's width; PERF.md holds the times.
//
// Launches (ops/familybody.py):
//   * bounce_kernel: one evaluation of every lane in lookahead groups (G /
//     M threads a lane), the pool's tensors read and written in place (SoA;
//     int64 words holding the u32 RNG) or into another pool.
//   * extend_kernel: one evaluation of every lane, one thread per lane, in
//     place or into another pool.
//   * For both, the counts (lanes alive at the start, or segment starts,
//     for n_rays; lanes alive after) reduce per block with
//     __syncthreads_count and across blocks with atomics; the last block
//     adds n_rays once in float32 and writes the count.  Gated (a stage's
//     control words given, common.cuh): each launch returns untouched
//     where the host's loop would have stopped, and the last block
//     advances the evaluation index and leaves the loop's count (lanes
//     alive + paths not yet issued; in a queue stage the paths alone).
//   * refill_kernel: 1,024 lanes per block, so a refill group (a power of
//     two up to 1,024) lies inside a block and its all-dead test is a warp
//     ballot or the block's ballots; the ranks are a block scan and a
//     single-pass decoupled look-back over the blocks' totals, in the order
//     of a start ticket; the last block advances paths_issued and clears the
//     look-back words.  A separate launch before each bounce or extend: a
//     group of 1,024 lanes spans four of bounce's blocks, whose alive flags
//     the bounce rewrites.
//   * drain_kernel (naiveSK's trace): each lane loads once, runs bounce after
//     bounce in registers until it dies or reaches max_path_length (a dead
//     lane is a fixed point, so this is the loop; a lookahead group bounces
//     together while one of its lanes goes on), and stores once; each
//     lane's evaluation count goes into a histogram by warp-aggregated
//     atomics, and the last block folds the live counts into n_rays in
//     float32, one evaluation after another, as the loop adds them.
//   * The queue-fed loops (regenerationSK, streamingSK, sortingSK) run as a
//     queue stage and a tail.  The queue stage is gated chains of refill +
//     bounce or extend whose count is the paths not yet issued, so it ends
//     at the iteration e0 after the one that issued the last path.  From
//     e0 a refill takes nothing, and every lane runs alone to its death:
//     regenerationSK's tail is drain_kernel with the splat and no path
//     bound, streamingSK's extend_drain_kernel (a thread a lane, segment
//     starts counted per evaluation and folded in order), sortingSK's
//     gated chains of the Morton sort, the flush and one extend_drain_kernel
//     segment up to the next sort point.  A tail drain is enqueued behind
//     every batch of the queue stage and opens on the card once the stage
//     has stopped (tail_open), from the card's e0, so the host reads no
//     more words than the gated chains did.  A tail launches no refill:
//     what the refill's look-back and the near-empty launches of the
//     loop's last ~1,000 iterations cost.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;
constexpr int REFILL_THREADS = 1024;
constexpr int DRAIN_THREADS = 64;
// A lookahead group is G threads (ops/familybody.py GROUPS); a Woodcock
// step takes 2 draws, so the jump table (ops/rng.jump_constants) holds m =
// 0 .. 2 * GROUP_MAX.
constexpr int GROUP_MAX = 16;
constexpr int JUMP_N1 = 2 * GROUP_MAX + 1;
// models/integrator.py _VB_MAX_ITERS: a variable-boundary march's cap
constexpr int VB_MAX_ITERS = 4096;

// Float parameters (ops/familybody.py FP_*).
enum {
  FP_BMIN = 0, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3,
  FP_RMD = FP_EXT + 3,  // the density's (nx, ny, nz) - 1
  FP_RMA = FP_RMD + 3,  // the albedo's
  FP_SCALE = FP_RMA + 3, FP_INV_SIGMAT, FP_G, FP_LE,
  FP_ROUGH = FP_LE + 3, FP_ETA = FP_ROUGH + 2, FP_INV_ETA,
  FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY,
  FP_CAM,  // the camera's (3, 4) inv_view, row-major
  FP_R2VX = FP_CAM + 12, FP_R2VY,
  // the variable boundary: min_step, min_step + EPSILON (summed in double),
  // the gradient threshold
  FP_MINSTEP, FP_MSE, FP_THRESH, N_FP,
};

// Integer parameters (ops/familybody.py IP_*).
enum {
  IP_OP = 0, IP_NX, IP_NY, IP_NZ, IP_AX, IP_AY, IP_AZ, IP_NCH, IP_NEAREST,
  IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH, IP_SPLAT, IP_DEFER, IP_GROUP,
  IP_STREAM, IP_NPATHS, IP_TW, IP_NPIX, IP_BASE, IP_SEEDH,
  IP_THRESH, IP_CHAIN, IP_CAP,  // a stage's exit threshold, chain, drain cap
  IP_VARIABLE,                   // the variable boundary's isosurface march
  IP_LOOK, IP_LANES,  // the bounce's lookahead group: G threads, M lanes
  IP_QUEUE,    // a queue stage: the loop's count is the paths not yet issued
  IP_SEGMENT,  // the extend drain as one gated segment of a tail's chain
  N_IP,
};

// Entry points (IP_OP).
enum { OP_BOUNCE = 0, OP_REFILL, OP_EXTEND, OP_FLUSH };

// Pointer slots (ops/familybody.py S_*): the per-lane fields (a PathState's
// first seven, image_id, then StreamState's), the outputs (the same again),
// n_rays in and out, the count, paths_issued in and out, the image, the
// grids, the scratch, the refill's look-back words, a stage's control words,
// the drain's histogram and the bounce's jump table (null where a launch
// uses none).
enum {
  S_O = 0, S_D, S_TP, S_RAD, S_ALIVE, S_RS, S_RINC, S_IMG,
  S_TRACK, S_T, S_MAXT, S_NRM, S_PEND, S_PSCAT,
  N_LANE,
  S_OUT = N_LANE, S_NRAYS = S_OUT + N_LANE, S_NRAYS_OUT, S_COUNT,
  S_ISSUED, S_ISSUED_OUT, S_ACCUM, S_DENSITY, S_ALBEDO, S_SCRATCH, S_STATUS,
  S_CTRL, S_HIST, S_JUMP, N_S,
};

// The scratch's uint64 words: the two counts, the last-block ticket, the
// refill's start ticket and its paths taken.  Zero before and after a launch.
enum { SC_COUNT = 0, SC_RAYS, SC_TICKET, SC_START, SC_TAKES, N_SCRATCH };

// A queue-fed loop's control words hold one more: the iteration e0 at which
// its tail started (written by the tail's first drain launch).
constexpr int C_E0 = N_CTRL;

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// One lane, in registers.
struct Lane {
  float o[3], d[3], tp[3], rad[3], nrm[3], ps[3];
  float t, maxt;
  uint32_t rs, inc;
  bool alive, trk, pend;
};

// What a launch reads and writes of a lane beyond alive: the path fields, and
// StreamState's.
__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, bool stream, Lane& L) {
  const float* fo = (const float*)Q.p[S_O];
  const float* fd = (const float*)Q.p[S_D];
  const float* ftp = (const float*)Q.p[S_TP];
  const float* frad = (const float*)Q.p[S_RAD];
  for (int k = 0; k < 3; ++k) {
    L.o[k] = fo[3 * i + k];
    L.d[k] = fd[3 * i + k];
    L.tp[k] = ftp[3 * i + k];
    L.rad[k] = frad[3 * i + k];
  }
  L.rs = (uint32_t)((const long long*)Q.p[S_RS])[i];
  L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
  if (!stream) return;
  L.t = ((const float*)Q.p[S_T])[i];
  L.maxt = ((const float*)Q.p[S_MAXT])[i];
  const float* fn = (const float*)Q.p[S_NRM];
  const float* fp = (const float*)Q.p[S_PSCAT];
  for (int k = 0; k < 3; ++k) {
    L.nrm[k] = fn[3 * i + k];
    L.ps[k] = fp[3 * i + k];
  }
}

// Stores the fields a launch may change; the RNG's increment only where it
// can change (a refill) or when writing another pool.
__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, bool stream, bool inc,
                                           const Lane& L) {
  float* go = (float*)Q.p[S_OUT + S_O];
  float* gd = (float*)Q.p[S_OUT + S_D];
  float* gtp = (float*)Q.p[S_OUT + S_TP];
  float* grad = (float*)Q.p[S_OUT + S_RAD];
  for (int k = 0; k < 3; ++k) {
    go[3 * i + k] = L.o[k];
    gd[3 * i + k] = L.d[k];
    gtp[3 * i + k] = L.tp[k];
    grad[3 * i + k] = L.rad[k];
  }
  ((bool*)Q.p[S_OUT + S_ALIVE])[i] = L.alive;
  ((long long*)Q.p[S_OUT + S_RS])[i] = (long long)L.rs;
  if (inc) ((long long*)Q.p[S_OUT + S_RINC])[i] = (long long)L.inc;
  if (!stream) return;
  ((bool*)Q.p[S_OUT + S_TRACK])[i] = L.trk;
  ((float*)Q.p[S_OUT + S_T])[i] = L.t;
  ((float*)Q.p[S_OUT + S_MAXT])[i] = L.maxt;
  ((bool*)Q.p[S_OUT + S_PEND])[i] = L.pend;
  float* gn = (float*)Q.p[S_OUT + S_NRM];
  float* gp = (float*)Q.p[S_OUT + S_PSCAT];
  for (int k = 0; k < 3; ++k) {
    gn[3 * i + k] = L.nrm[k];
    gp[3 * i + k] = L.ps[k];
  }
}

// ---- the grids (common.cuh's samplers over this launch's parameters) ---------

// The box coordinates of a world point: (p - box_min) / extent.
__device__ __forceinline__ void box01(const Params& P, const float p[3], float p01[3]) {
  grid_box01(P.f + FP_BMIN, P.f + FP_EXT, p, p01);
}

// The density at o + t d.
__device__ __forceinline__ float density_at(const Params& P, const Ptrs& Q, const float o[3],
                                            const float d[3], float t) {
  return grid_density_at((const float*)Q.p[S_DENSITY], P.i + IP_NX, P.f + FP_RMD,
                         P.f + FP_BMIN, P.f + FP_EXT, P.i[IP_NEAREST] != 0, o, d, t);
}

// integrator.sample_albedo at p: rgb (a 1-channel grid broadcast).
__device__ __forceinline__ void albedo_at(const Params& P, const Ptrs& Q, const float p[3],
                                          float alb[3]) {
  grid_albedo_at((const float*)Q.p[S_ALBEDO], P.i + IP_AX, (int)P.i[IP_NCH], P.f + FP_RMA,
                 P.f + FP_BMIN, P.f + FP_EXT, P.i[IP_NEAREST] != 0, p, alb);
}

// ---- the variable boundary (integrator.variable_boundary_adjust) -------------

// gradient.volume_intensity: the density at box coordinates q, 0 outside the
// unit cube (whose voxels are then not read).
__device__ __forceinline__ float intensity(const Params& P, const Ptrs& Q, const float q[3]) {
  for (int a = 0; a < 3; ++a)
    if (!(q[a] >= 0.0f && q[a] <= 1.0f)) return 0.0f;
  float rho;
  sample_grid((const float*)Q.p[S_DENSITY], P.i[IP_NX], P.i[IP_NY], P.i[IP_NZ], 1, 1,
              P.f + FP_RMD, q, P.i[IP_NEAREST] != 0, &rho);
  return rho;
}

// gradient.gradient_cd at the world point p: per axis I(p01 - delta) -
// I(p01 + delta), delta min_step on the axis and 0.0 on the other two.
__device__ __forceinline__ void gradient_cd(const Params& P, const Ptrs& Q, const float p[3],
                                            float g[3]) {
  float p01[3];
  box01(P, p, p01);
  for (int ax = 0; ax < 3; ++ax) {
    float hi[3], lo[3];
    for (int a = 0; a < 3; ++a) {
      const float delta = a == ax ? P.f[FP_MINSTEP] : 0.0f;
      hi[a] = p01[a] + delta;
      lo[a] = p01[a] - delta;
    }
    g[ax] = intensity(P, Q, lo) - intensity(P, Q, hi);
  }
}

// The stochastic isosurface march of a live lane from its AABB result (hit,
// inside, dist, nrm), in registers: from the hit point (backward from the
// exit face when the lane is inside) in steps of u * min_step until the
// gradient's norm reaches the threshold.  A march that found the surface
// moves the hit there with the normalized gradient as the normal; one that
// crossed the box reports no hit with inside flipped; one that left by the
// near side or ran VB_MAX_ITERS iterations keeps the AABB result.  The
// eager loop's iteration count is each running lane's own, so a lane's
// march is the loop's.
__device__ __forceinline__ void march(const Params& P, const Ptrs& Q, Lane& L, bool& hit,
                                      bool& inside, float& dist, float nrm[3]) {
  if (!hit) return;
  const float sign = inside ? -1.0f : 1.0f;
  float td[3], to[3];
  const float t0 = dist + EPS;
  for (int k = 0; k < 3; ++k) {
    td[k] = sign * L.d[k];
    to[k] = L.o[k] + L.d[k] * t0;
  }
  const BoxHit h2 = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, to, td);
  if (!(h2.smallest_tmax > h2.largest_tmin && h2.dist > 0.0f)) return;
  for (int k = 0; k < 3; ++k) to[k] = to[k] - td[k] * P.f[FP_MSE];
  float g[3];
  gradient_cd(P, Q, to, g);
  const float step = P.f[FP_MINSTEP], thresh = P.f[FP_THRESH];
  bool running = sqrtf(dot3(g, g)) < thresh;
  float total = 0.0f, nd = dist;
  bool keep = false, lost = false;
  for (int k = 0; running;) {
    const float s = draw_float(L.rs, L.inc) * step;
    total = total + s;
    nd = nd + sign * s;
    if (nd < 0.0f) {  // marched out the near side
      keep = true;
      break;
    }
    if (total > h2.dist) {  // across the box: no surface on this segment
      lost = true;
      break;
    }
    for (int a = 0; a < 3; ++a) to[a] = to[a] + td[a] * s;
    gradient_cd(P, Q, to, g);
    if (++k >= VB_MAX_ITERS) {
      keep = true;
      break;
    }
    running = sqrtf(dot3(g, g)) < thresh;
  }
  if (!keep && !lost && nd > 0.0f && total > 0.0f) {
    dist = nd;
    normalize3(g, nrm);
  }
  if (lost) {
    hit = false;
    inside = !inside;
  }
}

// ---- the bodies -------------------------------------------------------------

__device__ __forceinline__ Ggx ggx_of(const Params& P) {
  return Ggx{P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
             P.i[IP_MITSUBA] != 0};
}

// Russian roulette (integrator.russian_roulette) on a lane of its mask.
__device__ __forceinline__ void roulette(Lane& L) {
  if (roulette_kills(L.tp, L.rs, L.inc)) L.alive = false;
}

// An HG scatter at o + d t - d eps (phase.sample_phase): the new o and d.
__device__ __forceinline__ void scatter(const Params& P, Lane& L, float t, float os[3]) {
  float nd[3];
  for (int k = 0; k < 3; ++k) os[k] = L.o[k] + L.d[k] * t - L.d[k] * EPS;
  const float e1 = draw_float(L.rs, L.inc);
  const float e2 = draw_float(L.rs, L.inc);
  float cos_th, sin_th;
  hg(P.f[FP_G], e1, cos_th, sin_th);
  const float phi = TWO_PI_F * e2;
  turn(L.d, sin_th * cosf(phi), sin_th * sinf(phi), cos_th, nd);
  for (int k = 0; k < 3; ++k) {
    L.o[k] = os[k];
    L.d[k] = nd[k];
  }
}

// A lookahead group: G threads of a warp (G a power of two up to 16,
// aligned) holding M lanes (IP_LANES, a power of two up to G), each lane on
// R = G / M neighbouring threads that compute its bounce alike.  This
// thread is member j, a replica of lane slot j / R, and takes step j of
// every chain of the group: its jump to draw 2 j + 1.
template <int G>
struct Group {
  unsigned mask;
  int j, r;  // member, and threads per lane
  Jump first;
};

template <int G>
__device__ __forceinline__ Group<G> group_of(const Params& P, const Ptrs& Q) {
  const int j = (int)(threadIdx.x % G);
  return Group<G>{group_mask<G>(), j, G / (int)P.i[IP_LANES],
                  null_jump<2>((const int64_t*)Q.p[S_JUMP], JUMP_N1, j)};
}

// woodcock_track for the group's lanes with `need` (inside the box, up to
// their dist): the whole group takes each such lane's chain in turn, in
// rounds of G steps.  Member j takes step j (draws 2 j + 1 and 2 j + 2, by
// jump-ahead), its t_j the eager loop's left-to-right sum (common.cuh
// run_sum), its density at o + t_j d and its test; the first member whose
// step crosses dist or accepts ends the chain, and a round without one
// hands its last step on to the next.  Each lane (every replica) gets its
// chain's t and its PCG state after it; every member calls this.
template <int G>
__device__ __forceinline__ float woodcock(const Params& P, const Ptrs& Q, const Group<G>& g,
                                          Lane& L, bool need, float dist) {
  const float isig = P.f[FP_INV_SIGMAT], scale = P.f[FP_SCALE];
  float mine = 0.0f;
  const unsigned firsts = group_ballot<G>(g.mask, need && g.j % g.r == 0);
  for (unsigned todo = firsts; todo != 0u; todo &= todo - 1u) {
    const int k = __ffs(todo) - 1;  // the first replica of the chain's lane
    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
      o[a] = group_shfl<G>(g.mask, L.o[a], k);
      d[a] = group_shfl<G>(g.mask, L.d[a], k);
    }
    const float dk = group_shfl<G>(g.mask, dist, k);
    const uint32_t inc = group_shfl<G>(g.mask, L.inc, k);
    uint32_t rs = group_shfl<G>(g.mask, L.rs, k);
    float t = 0.0f;
    for (int src = -1; src < 0;) {
      const uint32_t s1 = jumped(g.first, rs, inc);  // u1
      const uint32_t s2 = pcg_next(s1, inc);          // u2
      const float tj = run_sum<G>(g.mask, t, flight(s1, isig), g.j, G);
      const float rho = density_at(P, Q, o, d, tj);
      src = first_stop<G>(g.mask, g.j, G, !(tj <= dk && scale * rho * isig < uniform(s2)));
      const int last = src < 0 ? G - 1 : src;
      t = group_shfl<G>(g.mask, tj, last);
      rs = group_shfl<G>(g.mask, s2, last);
    }
    if (g.j / g.r == k / g.r) {
      mine = t;
      L.rs = rs;
    }
  }
  return mine;
}

// integrator.bounce_step for this thread's lane where `active` (with the
// variable boundary's march after the AABB test where IP_VARIABLE is set).
// Every member of the group calls it: the Woodcock chains are the group's.
template <int G>
__device__ __forceinline__ void bounce(const Params& P, const Ptrs& Q, const Group<G>& g,
                                       Lane& L, bool active) {
  bool hit = false, inside = false;
  float dist = 0.0f, nrm[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
    const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, L.o, L.d);
    hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    dist = h.dist;
    for (int k = 0; k < 3; ++k) nrm[k] = h.nrm[k];
    if (P.i[IP_VARIABLE]) march(P, Q, L, hit, inside, dist, nrm);
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.rad[k] = L.rad[k] + L.tp[k] * P.f[FP_LE + k];
      L.alive = false;
    }
  }
  const bool track = active && hit && inside;
  const float t = woodcock<G>(P, Q, g, L, track, dist);
  if (!active || !hit) return;
  if (!(track && t < dist)) {
    boundary_event(P.i[IP_BSDF] != 0, ggx_of(P), nrm, dist, L.o, L.d, L.tp, L.rs, L.inc);
  } else {
    float os[3], alb[3];
    scatter(P, L, t, os);
    albedo_at(P, Q, os, alb);
    for (int k = 0; k < 3; ++k) L.tp[k] = L.tp[k] * alb[k];
  }
  if (P.i[IP_RR]) roulette(L);
}

// The radiance of a lane that died into its pixel, then zero.
__device__ __forceinline__ void splat(const Ptrs& Q, int i, Lane& L) {
  const long long img = ((const long long*)Q.p[S_IMG])[i];
  float* acc = (float*)Q.p[S_ACCUM] + 3 * img;
  for (int k = 0; k < 3; ++k) {
    atomicAdd(acc + k, L.rad[k]);
    L.rad[k] = 0.0f;
  }
}

// streaming.extend_step for a lane that is alive or tracking; returns whether
// it started a segment (n_rays).
__device__ __forceinline__ bool extend(const Params& P, const Ptrs& Q, Lane& L, bool defer) {
  const bool need_isect = L.alive && !L.trk && !(defer && L.pend);
  bool enters = false, boundary_now = false;
  float dist = 0.0f;
  if (need_isect) {
    const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, L.o, L.d);
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.rad[k] = L.rad[k] + L.tp[k] * P.f[FP_LE + k];
      L.alive = false;
    }
    enters = hit && inside;
    boundary_now = hit && !inside;
    dist = h.dist;
    if (enters) {
      L.trk = true;
      L.t = 0.0f;
      L.maxt = h.dist;
    }
    for (int k = 0; k < 3; ++k) L.nrm[k] = h.nrm[k];
  }
  // woodcock_step_masked: one step of a lane already tracking
  bool terminated = false, scattered = false;
  if (L.trk && !enters) {
    const float isig = P.f[FP_INV_SIGMAT], scale = P.f[FP_SCALE];
    const float t_new = L.t + flight(L.rs = pcg_next(L.rs, L.inc), isig);
    const float rho = density_at(P, Q, L.o, L.d, t_new);
    const float u2 = draw_float(L.rs, L.inc);
    const bool overran = t_new > L.maxt;
    const bool accepted = !(scale * rho * isig < u2);
    terminated = overran || accepted;
    scattered = terminated && !overran;
    L.t = t_new;
  }
  L.trk = L.trk && !terminated;
  const bool boundary = boundary_now || (terminated && !scattered);
  if (boundary) {
    boundary_event(P.i[IP_BSDF] != 0, ggx_of(P), L.nrm, boundary_now ? dist : L.maxt, L.o,
                   L.d, L.tp, L.rs, L.inc);
  }
  if (scattered) {
    float os[3];
    scatter(P, L, L.t, os);
    if (defer) {
      L.pend = true;
      for (int k = 0; k < 3; ++k) L.ps[k] = os[k];
    } else {
      float alb[3];
      albedo_at(P, Q, os, alb);
      for (int k = 0; k < 3; ++k) L.tp[k] = L.tp[k] * alb[k];
    }
  }
  const bool had_event = L.alive && ((scattered && !defer) || boundary);
  if (P.i[IP_RR] && had_event) roulette(L);
  return need_isect;
}

// streaming.flush_pending for a pending lane.
__device__ __forceinline__ void flush(const Params& P, const Ptrs& Q, Lane& L) {
  float alb[3];
  albedo_at(P, Q, L.ps, alb);
  for (int k = 0; k < 3; ++k) L.tp[k] = L.tp[k] * alb[k];
  if (P.i[IP_RR]) roulette(L);
  L.pend = false;
}

// ---- launches ----------------------------------------------------------------

// The count the host's loop reads: lanes alive, plus paths not yet issued
// where the pool is queue-fed; in a queue stage (IP_QUEUE) the paths not yet
// issued alone, so the stage ends once the last path is issued.
__device__ __forceinline__ long long loop_count(const Params& P, const Ptrs& Q, long long alive) {
  if (Q.p[S_ISSUED] == nullptr) return alive;
  const long long unissued = P.i[IP_NPATHS] - *(const long long*)Q.p[S_ISSUED];
  return P.i[IP_QUEUE] ? unissued : alive + unissued;
}

// The counts of one evaluation over the grid; the last block adds n_rays and
// writes the count (the stage's C_COUNT when gated), and clears the scratch.
__device__ __forceinline__ void reduce_counts(const Params& P, const Ptrs& Q, bool rays,
                                              bool alive, long long* ctrl, long long e) {
  const int n_rays = __syncthreads_count(rays);
  const int n_alive = __syncthreads_count(alive);
  if (threadIdx.x != 0) return;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  atomicAdd(scratch + SC_RAYS, (unsigned long long)n_rays);
  atomicAdd(scratch + SC_COUNT, (unsigned long long)n_alive);
  if (!last_block(scratch + SC_TICKET)) return;  // the last block: every count is in
  const unsigned long long r = atomicAdd(scratch + SC_RAYS, 0ull);
  const unsigned long long c = atomicAdd(scratch + SC_COUNT, 0ull);
  *(float*)Q.p[S_NRAYS_OUT] = *(const float*)Q.p[S_NRAYS] + (float)r;
  *(long long*)Q.p[S_COUNT] = loop_count(P, Q, (long long)c);
  scratch[SC_RAYS] = scratch[SC_COUNT] = scratch[SC_TICKET] = 0ull;
  if (ctrl != nullptr) ctrl[C_EVAL] = e + 1;
}

// Whether the launch writes another pool (every lane's fields then copied).
__device__ __forceinline__ bool out_of_place(const Ptrs& Q) {
  return Q.p[S_OUT + S_ALIVE] != Q.p[S_ALIVE];
}

// One bounce of every lane, in lookahead groups (G threads, M lanes); gated
// when S_CTRL is set.  A lane's first replica splats, stores and counts it;
// threads past the pool take part in their group's chains.
template <int G>
__global__ void __launch_bounds__(THREADS) bounce_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  long long e = 0;
  if (ctrl != nullptr) {
    if (stage_stopped(ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])) return;
    e = ctrl[C_EVAL];
  }
  const Group<G> g = group_of<G>(P, Q);
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int i = tid / g.r;
  const bool lead = tid % g.r == 0;
  const bool copy = out_of_place(Q);
  Lane L = {};
  bool was = false;
  if (i < width) {
    L.alive = was = ((const bool*)Q.p[S_ALIVE])[i];
    if (was || copy) load_lane(Q, i, false, L);
  }
  bounce<G>(P, Q, g, L, was);
  if (lead && i < width && (was || copy)) {
    if (was && P.i[IP_SPLAT] && !L.alive) splat(Q, i, L);
    store_lane(Q, i, false, copy, L);
  }
  reduce_counts(P, Q, lead && was, lead && L.alive, ctrl, e);
}

// One extend (or, with OP_FLUSH, one flush) of every lane; gated when S_CTRL
// is set.
__global__ void __launch_bounds__(THREADS) extend_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  long long e = 0;
  if (ctrl != nullptr) {
    if (stage_stopped(ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])) return;
    e = ctrl[C_EVAL];
  }
  const bool is_flush = P.i[IP_OP] == OP_FLUSH;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool isect = false, alive = false;
  if (i < width) {
    Lane L;
    L.alive = ((const bool*)Q.p[S_ALIVE])[i];
    L.trk = ((const bool*)Q.p[S_TRACK])[i];
    L.pend = ((const bool*)Q.p[S_PEND])[i];
    const bool act = is_flush ? L.pend : (L.alive || L.trk);
    const bool copy = out_of_place(Q);
    if (act || copy) {
      load_lane(Q, i, true, L);
      if (act) {
        const bool was = L.alive;
        if (is_flush) {
          flush(P, Q, L);
        } else {
          isect = extend(P, Q, L, P.i[IP_DEFER] != 0);
        }
        if (was && !L.alive) splat(Q, i, L);
      }
      store_lane(Q, i, true, copy, L);
    }
    alive = L.alive;
  }
  if (is_flush) return;  // no counts: the loop reads the next extend's
  reduce_counts(P, Q, isect, alive, ctrl, e);
}

// ---- the refill ----------------------------------------------------------------

// The queue refill of every lane: ranks of the dead lanes (groups of
// IP_GROUP) in lane order, path ids from paths_issued while they last.
__global__ void __launch_bounds__(REFILL_THREADS) refill_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  if (ctrl != nullptr && stage_stopped(ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])) return;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  unsigned long long* status = (unsigned long long*)Q.p[S_STATUS];
  __shared__ unsigned s_ball[REFILL_THREADS / 32];
  const int b = start_ticket(scratch + SC_START);  // the look-back's order
  const int i = b * REFILL_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool dead = i < width && !((const bool*)Q.p[S_ALIVE])[i];
  const unsigned ball = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) s_ball[warp] = ball;
  __syncthreads();
  // _regenerate's group rule: a group refills once all its lanes are dead
  const long long g = P.i[IP_GROUP];
  bool want = dead;
  if (g > 1 && i < (width / g) * g) {
    if (g <= 32) {
      const unsigned m = g == 32 ? 0xffffffffu : ((1u << g) - 1u);
      want = ((ball >> (lane & ~(int)(g - 1))) & m) == m;
    } else {
      const int wg = (int)(g / 32), w0 = warp / wg * wg;
      want = true;
      for (int w = w0; w < w0 + wg; ++w) want = want && s_ball[w] == 0xffffffffu;
    }
  }
  // the ranks: a block scan, then the blocks before (common.cuh)
  const long long rank = queue_rank<REFILL_THREADS>(want, b, status);
  const long long issued = *(const long long*)Q.p[S_ISSUED];
  const long long pid = issued + rank;
  const bool takes = want && pid < P.i[IP_NPATHS];
  const bool stream = P.i[IP_STREAM] != 0;
  const bool copy = out_of_place(Q);
  if (takes) {
    // the path's pixel, its (seed, path id) stream and camera ray
    Lane L;
    const long long img = pid % P.i[IP_NPIX];
    float px, py;
    pixel_of(img, P.i[IP_TW], P.f[FP_INV_TW], P.f[FP_TILEX], P.f[FP_TILEY], px, py);
    path_stream((uint32_t)(pid + P.i[IP_BASE]), (uint32_t)P.i[IP_SEEDH], L.rs, L.inc);
    camera_ray(P.f + FP_CAM, P.f[FP_R2VX], P.f[FP_R2VY], P.f[FP_INV_RESX], P.f[FP_INV_RESY],
               px, py, L.rs, L.inc, L.o, L.d);
    for (int k = 0; k < 3; ++k) {
      L.tp[k] = 1.0f;
      L.rad[k] = 0.0f;
    }
    L.alive = true;
    float* go = (float*)Q.p[S_OUT + S_O];
    float* gd = (float*)Q.p[S_OUT + S_D];
    float* gtp = (float*)Q.p[S_OUT + S_TP];
    float* grad = (float*)Q.p[S_OUT + S_RAD];
    for (int k = 0; k < 3; ++k) {
      go[3 * i + k] = L.o[k];
      gd[3 * i + k] = L.d[k];
      gtp[3 * i + k] = L.tp[k];
      grad[3 * i + k] = L.rad[k];
    }
    ((bool*)Q.p[S_OUT + S_ALIVE])[i] = true;
    ((long long*)Q.p[S_OUT + S_RS])[i] = (long long)L.rs;
    ((long long*)Q.p[S_OUT + S_RINC])[i] = (long long)L.inc;
    ((long long*)Q.p[S_OUT + S_IMG])[i] = img;
    if (stream) ((bool*)Q.p[S_OUT + S_TRACK])[i] = false;
  } else if (copy && i < width) {
    Lane L;
    L.alive = !dead;
    load_lane(Q, i, false, L);
    store_lane(Q, i, false, true, L);
    ((long long*)Q.p[S_OUT + S_IMG])[i] = ((const long long*)Q.p[S_IMG])[i];
    if (stream) ((bool*)Q.p[S_OUT + S_TRACK])[i] = ((const bool*)Q.p[S_TRACK])[i];
  }
  const int n_takes = __syncthreads_count(takes);
  if (threadIdx.x != 0) return;
  atomicAdd(scratch + SC_TAKES, (unsigned long long)n_takes);
  if (!last_block(scratch + SC_TICKET)) return;  // the last block: every block is done
  *(long long*)Q.p[S_ISSUED_OUT] = issued + (long long)atomicAdd(scratch + SC_TAKES, 0ull);
  scratch[SC_TAKES] = scratch[SC_TICKET] = scratch[SC_START] = 0ull;
  for (unsigned k = 0; k < gridDim.x; ++k) status[k] = 0ull;
}

// ---- the drains (naiveSK's trace, the queue-fed loops' tails) -----------------

// Whether a drain runs: always for naiveSK's trace; a queue-fed loop's tail
// drain (IP_QUEUE), enqueued behind each batch of the queue stage's gated
// chains, once the stage has stopped (every path issued, at a chain's
// start) or an earlier launch left lanes at its cap, and until the tail has
// ended.  Every block reads the same words (the last block of a drain
// writes them after every block has read them).
__device__ __forceinline__ bool tail_open(const Params& P, const unsigned long long* ctrl) {
  if (!P.i[IP_QUEUE]) return true;
  const long long* w = (const long long*)ctrl;
  return w[C_TOTAL] == 0 &&
         (w[C_LEFT] > 0 || stage_stopped(w, P.i[IP_CHAIN], P.i[IP_THRESH]));
}

// A tail drain's start, by thread 0 of each block before its ticket: the trip
// count is at least e0 (C_LMAX), and the tail's first launch leaves e0 in
// C_E0.
__device__ __forceinline__ void tail_start(const Params& P, unsigned long long* ctrl,
                                           long long e0) {
  if (!P.i[IP_QUEUE] || threadIdx.x != 0) return;
  atomicMax(ctrl + C_LMAX, (unsigned long long)e0);
  if (ctrl[C_E0] == 0ull) ctrl[C_E0] = (unsigned long long)e0;
}

// Adds each lane's count j (where j > 0; 0 from the threads that count no
// lane) to hist[j]: one atomic per group of a warp's lanes at the same j.
// Every thread of the warp calls it.
__device__ __forceinline__ void warp_count(unsigned long long* hist, int j) {
  const unsigned same = __match_any_sync(0xffffffffu, j);
  if (j > 0 && (int)(threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(hist + j, (unsigned long long)__popc(same));
}

// Every lane bounces until it dies or reaches max_path_length (or the cap);
// a lookahead group bounces together while one of its lanes goes on, and a
// lane's first replica stores and counts it.  With the splat on
// (regenerationSK's tail, whose IP_MAXPATH bounds nothing) a lane's first
// replica splats it where it dies, as bounce_kernel does.
template <int G>
__global__ void __launch_bounds__(DRAIN_THREADS) drain_kernel(Params P, Ptrs Q, int width) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned long long* hist = (unsigned long long*)Q.p[S_HIST];  // [cap + 1]
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  if (!tail_open(P, ctrl)) return;
  const long long cap = P.i[IP_CAP], maxpath = P.i[IP_MAXPATH];
  const long long e0 = (long long)ctrl[C_EVAL];
  const Group<G> g = group_of<G>(P, Q);
  const int tid = blockIdx.x * DRAIN_THREADS + threadIdx.x;
  const int i = tid / g.r;
  const bool lead = tid % g.r == 0;
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false;
  Lane L = {};
  bool going = i < width && ((const bool*)Q.p[S_ALIVE])[i] && e0 < maxpath;
  const bool ran = going;
  if (ran) {
    L.alive = true;
    load_lane(Q, i, false, L);
  }
  const bool splats = P.i[IP_SPLAT] != 0;
  while (group_ballot<G>(g.mask, going) != 0u) {
    bounce<G>(P, Q, g, L, going);
    if (going) {
      ++j;
      if (splats && lead && !L.alive) splat(Q, i, L);
      going = L.alive && j < cap && e0 + j < maxpath;
    }
  }
  if (ran && lead) {
    store_lane(Q, i, false, false, L);
    left = L.alive && e0 + j < maxpath;
    finished = !left;
  }
  if (!lead) j = 0;  // a lane counts once
  warp_count(hist, j);
  const int n_ran = __syncthreads_count(j > 0);
  if (threadIdx.x == 0 && n_ran > 0) atomicAdd(scratch + SC_RAYS, (unsigned long long)n_ran);
  tail_start(P, ctrl, e0);
  DrainEnd end;
  if (!drain_end(ctrl, e0, 1, j, left, finished, end)) return;
  // the last block: every lane is in.  Evaluation e of this launch started
  // with the lanes that ran more than e evaluations.
  long long live = (long long)atomicAdd(scratch + SC_RAYS, 0ull);
  float n = *(const float*)Q.p[S_NRAYS];
  for (long long e = 0; e < end.jmax; ++e) {
    n = n + (float)live;
    live -= (long long)__ldcg(hist + e + 1);
  }
  *(float*)Q.p[S_NRAYS_OUT] = n;
  for (long long e = 1; e <= end.jmax; ++e) hist[e] = 0ull;
  scratch[SC_RAYS] = 0ull;
  drain_close(ctrl, e0, cap, end.left);
}

// Adds each lane's flag to counts[j], j its evaluation in this launch: one
// atomic per group of the warp's active lanes at the same j (fastqbody.cu's).
__device__ __forceinline__ void flag_count(unsigned long long* counts, int j, bool flag) {
  const unsigned active = __activemask();
  const unsigned same = __match_any_sync(active, j);
  const unsigned votes = __ballot_sync(active, flag) & same;
  if ((int)(threadIdx.x & 31) == __ffs(same) - 1 && votes != 0u)
    atomicAdd(counts + j, (unsigned long long)__popc(votes));
}

// Whether a stream lane's next extend can change it: alive (or tracking,
// which only a live lane is) and, with defer, not stalled on its albedo.
__device__ __forceinline__ bool extends(const Lane& L, bool defer) {
  return (L.alive || L.trk) && !(defer && L.pend);
}

// streamingSK's and sortingSK's tail, once every path is issued (a refill
// then takes nothing): each lane extends in registers, a thread a lane,
// until it dies (or, with defer, stalls pending its albedo) or runs IP_CAP
// evaluations, splatting where it dies; its segment starts go into
// hist[j] by evaluation j of the launch.  Free (the drain): the control
// words as drain_kernel's, the trip count rounded up to IP_CHAIN (the
// loop's check_every) and the launch repeated while lanes are left.  A
// segment (IP_SEGMENT, sortingSK between two sort points): gated as an
// extend launch is, IP_CAP the evaluations to the next sort point; the last
// block advances C_EVAL by IP_CAP and leaves the loop's count (lanes alive,
// pending ones included).  Either way the last block folds the
// per-evaluation counts into n_rays in float32 in the loop's order.
__global__ void __launch_bounds__(DRAIN_THREADS) extend_drain_kernel(Params P, Ptrs Q,
                                                                      int width) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  unsigned long long* hist = (unsigned long long*)Q.p[S_HIST];  // [cap]
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  const bool segment = P.i[IP_SEGMENT] != 0;
  if (segment ? stage_stopped((const long long*)ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])
              : !tail_open(P, ctrl))
    return;
  const long long cap = P.i[IP_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const bool defer = P.i[IP_DEFER] != 0;
  const int i = blockIdx.x * DRAIN_THREADS + threadIdx.x;
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false, alive = false;
  if (i < width) {
    Lane L;
    L.alive = ((const bool*)Q.p[S_ALIVE])[i];
    L.trk = ((const bool*)Q.p[S_TRACK])[i];
    L.pend = ((const bool*)Q.p[S_PEND])[i];
    if (extends(L, defer)) {
      load_lane(Q, i, true, L);
      do {
        const bool was = L.alive;
        const bool isect = extend(P, Q, L, defer);
        if (was && !L.alive) splat(Q, i, L);
        flag_count(hist, j, isect);
        ++j;
      } while (j < cap && extends(L, defer));
      store_lane(Q, i, true, false, L);
      left = extends(L, defer);
      finished = !left;
    }
    alive = L.alive;
  }
  if (segment) {
    const int n_alive = __syncthreads_count(alive);
    if (threadIdx.x != 0) return;
    atomicAdd(scratch + SC_COUNT, (unsigned long long)n_alive);
    if (!last_block(scratch + SC_TICKET)) return;  // the last block: every lane is in
    float n = *(const float*)Q.p[S_NRAYS];
    for (long long e = 0; e < cap; ++e) {
      n = n + (float)__ldcg(hist + e);
      hist[e] = 0ull;
    }
    *(float*)Q.p[S_NRAYS_OUT] = n;
    const long long c = (long long)atomicAdd(scratch + SC_COUNT, 0ull);
    ((long long*)ctrl)[C_COUNT] = loop_count(P, Q, c);
    ctrl[C_EVAL] = (unsigned long long)(e0 + cap);
    scratch[SC_COUNT] = scratch[SC_TICKET] = 0ull;
    return;
  }
  tail_start(P, ctrl, e0);
  DrainEnd end;
  if (!drain_end(ctrl, e0, P.i[IP_CHAIN], j, left, finished, end)) return;
  // the last block: every lane is in; evaluations past the longest lane's
  // count nothing, and adding 0 leaves n_rays as it is
  float n = *(const float*)Q.p[S_NRAYS];
  for (long long e = 0; e < end.jmax; ++e) {
    n = n + (float)__ldcg(hist + e);
    hist[e] = 0ull;
  }
  *(float*)Q.p[S_NRAYS_OUT] = n;
  drain_close(ctrl, e0, cap, end.left);
}

// One thread follows `steps` dependent loads through next[] (a cycle) and
// writes where it ended: the latency of one dependent load, for phase 25's
// chain bound (not on any render's path).
__global__ void chase_kernel(const int* next, int steps, int* out) {
  int k = 0;
  for (int s = 0; s < steps; ++s) k = next[k];
  *out = k;
}

// Whether IP_LANES (M) is a power of two that divides IP_LOOK (G).
bool group_ok(const Params& P) {
  const long long G = P.i[IP_LOOK], M = P.i[IP_LANES];
  return M >= 1 && M <= G && G % M == 0 && (M & (M - 1)) == 0;
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

// Plain C entry points, loaded with ctypes (ops/familybody.py).  fparams
// (N_FP,) float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses,
// all in host memory and copied into the launch; width lanes.  Each returns
// cudaGetLastError(), or -1 when a size does not match this build's.

// One evaluation of the entry point IP_OP (bounce, refill, extend or flush):
// the scratch (N_SCRATCH uint64) and, for a refill, the look-back words (one
// uint64 per 1,024 lanes) zero before the launch, and zero after it; with
// ptrs[S_CTRL] set, gated on a stage's control words (IP_THRESH, IP_CHAIN)
// that the host set at its start.
extern "C" int familybody_launch(const float* fparams, int n_fp, const long long* iparams,
                                 int n_ip, void* const* ptrs, int n_s, int width,
                                 void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width <= 0) return 0;
  const Params P = params_of(fparams, iparams);
  const Ptrs Q = ptrs_of(ptrs);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P.i[IP_OP]) {
    case OP_BOUNCE: {
      if (!group_ok(P)) return -1;
      const long long threads = width * (P.i[IP_LOOK] / P.i[IP_LANES]);
      const int blocks = (int)((threads + THREADS - 1) / THREADS);
      switch (P.i[IP_LOOK]) {
        case 1: bounce_kernel<1><<<blocks, THREADS, 0, st>>>(P, Q, width); break;
        case 8: bounce_kernel<8><<<blocks, THREADS, 0, st>>>(P, Q, width); break;
        case 16: bounce_kernel<16><<<blocks, THREADS, 0, st>>>(P, Q, width); break;
        default: return -1;
      }
      break;
    }
    case OP_REFILL:
      refill_kernel<<<(width + REFILL_THREADS - 1) / REFILL_THREADS, REFILL_THREADS, 0, st>>>(
          P, Q, width);
      break;
    case OP_EXTEND:
    case OP_FLUSH:
      extend_kernel<<<(width + THREADS - 1) / THREADS, THREADS, 0, st>>>(P, Q, width);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// The drains, by IP_OP: drain_kernel (OP_BOUNCE) and extend_drain_kernel
// (OP_EXTEND).  The control words zero at the drain's start but C_EVAL and
// C_LMAX (the evaluation it starts at; a segment's words are its stage's),
// the histogram (IP_CAP + 1 uint64) and the scratch zero before each launch
// (each launch leaves them zero).
extern "C" int familybody_drain(const float* fparams, int n_fp, const long long* iparams,
                                int n_ip, void* const* ptrs, int n_s, int width,
                                void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    const Params P = params_of(fparams, iparams);
    const Ptrs Q = ptrs_of(ptrs);
    const cudaStream_t st = (cudaStream_t)stream;
    if (P.i[IP_OP] == OP_EXTEND) {
      extend_drain_kernel<<<(width + DRAIN_THREADS - 1) / DRAIN_THREADS, DRAIN_THREADS, 0,
                            st>>>(P, Q, width);
      return (int)cudaGetLastError();
    }
    if (P.i[IP_OP] != OP_BOUNCE || !group_ok(P)) return -1;
    const long long threads = width * (P.i[IP_LOOK] / P.i[IP_LANES]);
    const int blocks = (int)((threads + DRAIN_THREADS - 1) / DRAIN_THREADS);
    switch (P.i[IP_LOOK]) {
      case 1: drain_kernel<1><<<blocks, DRAIN_THREADS, 0, st>>>(P, Q, width); break;
      case 8: drain_kernel<8><<<blocks, DRAIN_THREADS, 0, st>>>(P, Q, width); break;
      case 16: drain_kernel<16><<<blocks, DRAIN_THREADS, 0, st>>>(P, Q, width); break;
      default: return -1;
    }
  }
  return (int)cudaGetLastError();
}

// chase_kernel, one thread (the chain bound's load latency): next (n,) int32
// on the card holding a cycle, out one int32.
extern "C" int familybody_chase(const int* next, int steps, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_FP, N_IP, N_S, N_CTRL), for the
// wrapper's check.
extern "C" void familybody_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
