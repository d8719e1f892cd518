// brickbody.cu — brickSK's round (phase A and the tracking round) for every
// lane of the wavefront, for Hopper (sm_90a).
//
// Replaces the body of cudavolumerenderer_tpu/models/brick.py:464 (render_tile's
// lax.while_loop, which XLA compiled into one device program: `phase_a` :185,
// `kernel_round` :365 with the Pallas tracking kernel, the argsort :387 and
// the packed permutation :388).  It computes what the port's eager functions
// (models/brick.py phase_a, round_keys and track_rows: the plain versions)
// compute on the card, bit for bit, in the same order.
//
// Layout.  The eager loop permutes the whole state by each round's stable
// sort.  Here the lanes stay where they are and carry `pos`, their sorted
// position; a position's lane is found through `perm` (position -> lane),
// which phase A rebuilds from pos every round.  A lane's path id depends on
// its position (slot = pos / n_pix), and the sort runs over the keys in
// position order, so ties fall as the eager loop's do.
//
// Two launches a round, with one torch op between them (ops/brickbody.py):
//   * phase_a_kernel, one thread per lane: consume the lane's kernel status
//     (a scatter: the stochastic tap into the fused grid, HG and the tap's
//     albedo; a brick exit; a box exit: GGX or the null BSDF), Russian
//     roulette, regeneration with the next path id and its camera ray, the
//     AABB for a segment start (a miss adds throughput * Le), the three DDA
//     brick steps with the empty-brick leap, the EXIT_BOX flag of a pending
//     event; then the lane's sort key in position order (its brick at
//     o + (t + 1e-6) d where it can track, else the sentinel) and
//     perm[pos] = lane.  The round's segment starts are added to n_rays in
//     float32 once (the last block), and the loop's count (lanes alive or
//     with samples left) is left for the round kernel.
//   * torch.sort(keys, stable=True): the sorted keys and the order.
//   * round_kernel, one block per row of 128 sorted positions: a position's
//     lane is perm[order[q]], and its new position q is written to pos.  The
//     row's leading key gives the row's brick; the lanes whose key equals it
//     track (usable): the block stages the brick's dilated table in shared
//     memory, converts the lane's ray to voxel space and runs K Woodcock
//     steps (common.cuh brick_steps, tracking.cu's loop), then writes t, the
//     status (RUNNING turned into MASKED) and the RNG state.  The last block
//     moves the loop's count into the control words and counts the round.
// Gated (a stage's control words given, common.cuh): both launches of a
// round return untouched where the host's loop would have stopped (the count
// 0 before the round), so the host enqueues rounds in batches and reads the
// words once per batch; the sort between them then reorders stale keys, which
// no gated launch reads.  A finished lane is a fixed point of a round.
//
// What bounds it on this card: per round the kernels need a few MB (a
// finished lane's flags and sample count, a live lane's ~130 B of state and
// changed fields, the fused-grid words, brick majorants and dilated-table
// words it taps, the keys, perm, order and pos: ops/brickbody.brick_bytes,
// ~1.4 us each at the memory rate on the brickSK slice), and after its first
// ~100 rounds only a few thousand of the slice's 160,000 lanes are live.  So
// each launch sits near the launch floor (~9 and ~4 us in the slice on an
// H100, PERF.md), the stable sort between them takes ~40 us, and the host's
// enqueue of a round (~0.1 ms) sets the pace.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;  // phase A's lanes per block
constexpr int ROW_W = 128;    // a round block's sorted positions
constexpr long long MASKED = 4;            // models/brick.py: sat out the round
constexpr int SENTINEL = 0x7FFFFFFF;       // the key of a lane that cannot track
constexpr float KEY_EPS = 1e-6f;           // round_keys' step past t

// Float parameters (ops/brickbody.py FP_*).
enum {
  FP_BMIN = 0, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3,
  FP_RM1 = FP_EXT + 3,    // the density's (nx, ny, nz) - 1
  FP_BSIZE = FP_RM1 + 3,  // the brick's (x, y, z) voxels
  FP_VOXS = FP_BSIZE + 3, // res_minus_1 / extent
  FP_SCALE = FP_VOXS + 3, FP_G, FP_LE,
  FP_ALB_A = FP_LE + 3, FP_ALB_B = FP_ALB_A + 3,
  FP_ROUGH = FP_ALB_B + 3, FP_ETA = FP_ROUGH + 2, FP_INV_ETA, FP_EPSW,
  FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY,
  FP_CAM,  // the camera's (3, 4) inv_view, row-major
  FP_R2VX = FP_CAM + 12, FP_R2VY, N_FP,
};

// Integer parameters (ops/brickbody.py IP_*).
enum {
  IP_OP = 0, IP_NX, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_NBZ, IP_NBRICKS, IP_TABLE,
  IP_ALBEDO, IP_BSDF, IP_MITSUBA, IP_RR, IP_SPP, IP_M, IP_NPIX, IP_TW, IP_BASE,
  IP_SEEDH, IP_KSTEPS,
  N_IP,
};

// Entry points (IP_OP).
enum { OP_PHASE_A = 0, OP_ROUND };

// Pointer slots (ops/brickbody.py S_*): the per-lane fields (BrickState's,
// the RNG's two words split, then pos), their outputs, then the rest.
enum {
  S_O = 0, S_D, S_TP, S_ACC, S_NRM, S_BASE, S_T, S_MAXT, S_BEXIT, S_ISIG, S_PIX,
  S_SD, S_STATUS, S_ALIVE, S_TRACKING, S_RS, S_RINC, S_POS,
  N_LANE,
  S_OUT = N_LANE, S_PERM = S_OUT + N_LANE, S_KEYS, S_SKEYS, S_ORDER, S_NRAYS,
  S_NRAYS_OUT, S_COUNT, S_FUSED, S_MAJOR, S_TABLES, S_SCRATCH, S_CTRL, N_S,
};

// The scratch's uint64 words: phase A's two counts and ticket, the round's
// ticket.  Zero before and after a launch.
enum { SC_RAYS = 0, SC_COUNT, SC_TICKET, SC_RTICKET, N_SCRATCH };

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

template <typename T>
__device__ __forceinline__ const T* in(const Ptrs& Q, int slot) {
  return (const T*)Q.p[slot];
}
template <typename T>
__device__ __forceinline__ T* out(const Ptrs& Q, int slot) {
  return (T*)Q.p[S_OUT + slot];
}

// Whether a launch writes other tensors than it reads (every field copied).
__device__ __forceinline__ bool out_of_place(const Ptrs& Q) {
  return Q.p[S_OUT + S_T] != Q.p[S_T];
}

// One lane, in registers.
struct Lane {
  float o[3], d[3], tp[3], acc[3], nrm[3], base[3];
  float t, maxt, bexit, isig;
  long long pix, sd, status;
  bool alive, trk;
  uint32_t rs, inc;
};

__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, Lane& L) {
  const float* f3[6] = {in<float>(Q, S_O), in<float>(Q, S_D), in<float>(Q, S_TP),
                        in<float>(Q, S_ACC), in<float>(Q, S_NRM), in<float>(Q, S_BASE)};
  float* v3[6] = {L.o, L.d, L.tp, L.acc, L.nrm, L.base};
  for (int f = 0; f < 6; ++f)
    for (int k = 0; k < 3; ++k) v3[f][k] = f3[f][3 * i + k];
  L.t = in<float>(Q, S_T)[i];
  L.maxt = in<float>(Q, S_MAXT)[i];
  L.bexit = in<float>(Q, S_BEXIT)[i];
  L.isig = in<float>(Q, S_ISIG)[i];
  L.pix = in<long long>(Q, S_PIX)[i];
  L.sd = in<long long>(Q, S_SD)[i];
  L.status = in<long long>(Q, S_STATUS)[i];
  L.alive = in<bool>(Q, S_ALIVE)[i];
  L.trk = in<bool>(Q, S_TRACKING)[i];
  L.rs = (uint32_t)in<long long>(Q, S_RS)[i];
  L.inc = (uint32_t)in<long long>(Q, S_RINC)[i];
}

// Stores what phase A may change (and pix and pos when out of place).
__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, const Lane& L, bool copy) {
  float* f3[6] = {out<float>(Q, S_O), out<float>(Q, S_D), out<float>(Q, S_TP),
                  out<float>(Q, S_ACC), out<float>(Q, S_NRM), out<float>(Q, S_BASE)};
  const float* v3[6] = {L.o, L.d, L.tp, L.acc, L.nrm, L.base};
  for (int f = 0; f < 6; ++f)
    for (int k = 0; k < 3; ++k) f3[f][3 * i + k] = v3[f][k];
  out<float>(Q, S_T)[i] = L.t;
  out<float>(Q, S_MAXT)[i] = L.maxt;
  out<float>(Q, S_BEXIT)[i] = L.bexit;
  out<float>(Q, S_ISIG)[i] = L.isig;
  out<long long>(Q, S_SD)[i] = L.sd;
  out<long long>(Q, S_STATUS)[i] = L.status;
  out<bool>(Q, S_ALIVE)[i] = L.alive;
  out<bool>(Q, S_TRACKING)[i] = L.trk;
  out<long long>(Q, S_RS)[i] = (long long)L.rs;
  out<long long>(Q, S_RINC)[i] = (long long)L.inc;
  if (copy) {
    out<long long>(Q, S_PIX)[i] = L.pix;
    out<long long>(Q, S_POS)[i] = in<long long>(Q, S_POS)[i];
  }
}

// The brick (x, y, z) and its flat id of the world point o + tt d
// (models/brick.py brick_of).
__device__ __forceinline__ long long brick_at(const Params& P, const float o[3],
                                              const float d[3], float tt, long long bi[3]) {
  const long long hi[3] = {P.i[IP_NBX] - 1, P.i[IP_NBY] - 1, P.i[IP_NBZ] - 1};
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + tt * d[a];
    const float coord =
        jclip((p - P.f[FP_BMIN + a]) / P.f[FP_EXT + a], 0.0f, 1.0f) * P.f[FP_RM1 + a];
    long long b = (long long)floorf(coord / P.f[FP_BSIZE + a]);
    b = b < 0 ? 0 : b;
    bi[a] = b < hi[a] ? b : hi[a];
  }
  return (bi[2] * P.i[IP_NBY] + bi[1]) * P.i[IP_NBX] + bi[0];
}

// Phase A of one lane at sorted position pos (models/brick.py phase_a);
// returns whether the lane starts a segment (n_rays), and its sort key.
__device__ __forceinline__ bool phase_a(const Params& P, const Ptrs& Q, Lane& L,
                                        long long pos, int& key) {
  // ---- consume the kernel statuses ----------------------------------------
  const bool scattered = L.trk && L.status == TRK_SCATTER;
  const bool exited_box = L.trk && L.status == TRK_EXIT_BOX;
  if (L.trk && L.status == TRK_EXIT_BRICK) {  // resume from the brick boundary
    L.t = L.bexit;
    L.bexit = -1.0f;
  }
  L.trk = L.trk && !(scattered || exited_box);

  // ---- scatter event: stochastic albedo tap + HG ---------------------------
  if (scattered) {
    float ps[3], alb[3], nd[3];
    for (int k = 0; k < 3; ++k) ps[k] = L.o[k] + L.t * L.d[k] - L.d[k] * EPS;
    const uint32_t bits = draw_bits(L.rs, L.inc);
    const long long j = tap_flat_at(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RM1, P.i + IP_NX,
                                    false, ps, bits);
    const int layout = (int)P.i[IP_TABLE], mode = (int)P.i[IP_ALBEDO];
    const float rho = mode == ALBEDO_AFFINE ? fused_rho(Q.p[S_FUSED], layout, 0, 0.0f, j) : 0.0f;
    fused_albedo(mode, P.f + FP_ALB_A, P.f + FP_ALB_B, Q.p[S_FUSED], nullptr, 0, j, rho, alb);
    const float e1 = draw_float(L.rs, L.inc);
    const float e2 = draw_float(L.rs, L.inc);
    float cos_th, sin_th;
    hg(P.f[FP_G], e1, cos_th, sin_th);
    const float phi = TWO_PI_F * e2;
    turn(L.d, sin_th * cosf(phi), sin_th * sinf(phi), cos_th, nd);
    for (int k = 0; k < 3; ++k) {
      L.o[k] = ps[k];
      L.d[k] = nd[k];
      L.tp[k] = L.tp[k] * alb[k];
    }
  }

  // ---- boundary event (GGX or null) -----------------------------------------
  if (exited_box) {
    const Ggx G = {P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
                   P.i[IP_MITSUBA] != 0};
    boundary_event(P.i[IP_BSDF] != 0, G, L.nrm, L.maxt, L.o, L.d, L.tp, L.rs, L.inc);
  }

  // ---- Russian roulette -------------------------------------------------------
  if (P.i[IP_RR] && (scattered || exited_box) && roulette_kills(L.tp, L.rs, L.inc)) {
    L.alive = false;
    L.sd = L.sd + 1;
  }

  // ---- regeneration (lane-pinned pixel, next sample) -------------------------
  if (!L.alive && L.sd < P.i[IP_SPP]) {
    const long long npix = P.i[IP_NPIX];
    const uint32_t s = (uint32_t)(pos / npix + P.i[IP_M] * L.sd);
    const uint32_t pid = s * (uint32_t)npix + (uint32_t)L.pix + (uint32_t)P.i[IP_BASE];
    float px, py;
    pixel_of(L.pix, P.i[IP_TW], P.f[FP_INV_TW], P.f[FP_TILEX], P.f[FP_TILEY], px, py);
    path_stream(pid, (uint32_t)P.i[IP_SEEDH], L.rs, L.inc);
    camera_ray(P.f + FP_CAM, P.f[FP_R2VX], P.f[FP_R2VY], P.f[FP_INV_RESX], P.f[FP_INV_RESY],
               px, py, L.rs, L.inc, L.o, L.d);
    for (int k = 0; k < 3; ++k) L.tp[k] = 1.0f;
    L.alive = true;
    L.trk = false;
  }

  // ---- AABB for all segment starts -------------------------------------------
  const bool need_isect = L.alive && !L.trk;
  bool boundary_now = false;
  if (need_isect) {
    const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, L.o, L.d);
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.acc[k] = L.acc[k] + L.tp[k] * P.f[FP_LE + k];
      L.sd = L.sd + 1;
      L.alive = false;
    } else if (inside) {
      L.trk = true;
      L.t = 0.0f;
      L.maxt = h.dist;
      L.bexit = -1.0f;
    } else {
      // an outside hit jumps to the surface: the boundary event next phase A
      L.maxt = h.dist;
      boundary_now = true;
    }
    for (int k = 0; k < 3; ++k) L.nrm[k] = h.nrm[k];
  }

  // ---- DDA brick assignment / empty-brick leap, three steps -------------------
  const float epsw = P.f[FP_EPSW];
  const float scale = P.f[FP_SCALE];
  bool pend_exitbox = false;
  for (int it = 0; it < 3; ++it) {
    if (L.trk && L.t >= L.bexit) {
      long long bi[3];
      const long long bflat = brick_at(P, L.o, L.d, L.t + epsw, bi);
      const float rho_b = in<float>(Q, S_MAJOR)[bflat];
      float bound[3];
      for (int a = 0; a < 3; ++a) {
        const float up = L.d[a] > 0.0f ? 1.0f : 0.0f;
        const float bound_coord = ((float)bi[a] + up) * P.f[FP_BSIZE + a];
        bound[a] = P.f[FP_BMIN + a] + P.f[FP_EXT + a] * bound_coord / P.f[FP_RM1 + a];
      }
      L.bexit = dda_exit(bound, L.o, L.d, L.t + epsw);
      L.isig = rho_b > 0.0f ? (1.0f / (scale * jmax(rho_b, 1e-30f))) * 1.0f : INFINITY;
      for (int a = 0; a < 3; ++a) L.base[a] = (float)bi[a] * P.f[FP_BSIZE + a];
    }
    if (L.trk && !isfinite(L.isig)) {  // an empty brick: leap it now
      if (L.bexit >= L.maxt) {
        pend_exitbox = true;
        L.trk = false;
      }
      L.t = jmin(L.bexit, L.maxt);
    }
  }

  // lanes that leapt to the medium's exit, and fresh outside hits, take the
  // boundary event next phase A: flagged EXIT_BOX and tracking
  const bool pend = pend_exitbox || boundary_now;
  L.status = pend ? TRK_EXIT_BOX : MASKED;
  L.trk = L.trk || pend;

  // ---- the sort key (round_keys) ------------------------------------------------
  key = SENTINEL;
  if (L.trk && isfinite(L.isig) && !pend) {
    long long bi[3];
    key = (int)brick_at(P, L.o, L.d, L.t + KEY_EPS, bi);
  }
  return need_isect;
}

// Phase A of every lane; gated when S_CTRL is set.
__global__ void __launch_bounds__(THREADS) phase_a_kernel(Params P, Ptrs Q, int width) {
  const long long* ctrl = (const long long*)Q.p[S_CTRL];
  if (ctrl != nullptr && stage_stopped(ctrl, 1, 0)) return;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool rays = false, pending = false;
  if (i < width) {
    const long long pos = in<long long>(Q, S_POS)[i];
    const bool copy = out_of_place(Q);
    const bool alive = in<bool>(Q, S_ALIVE)[i];
    const bool trk = in<bool>(Q, S_TRACKING)[i];
    const long long sd = in<long long>(Q, S_SD)[i];
    int key = SENTINEL;
    if (alive || trk || sd < P.i[IP_SPP] || copy) {
      Lane L;
      load_lane(Q, i, L);
      rays = phase_a(P, Q, L, pos, key);
      pending = L.alive || L.sd < P.i[IP_SPP];
      store_lane(Q, i, L, copy);
    } else if (in<long long>(Q, S_STATUS)[i] != MASKED) {
      out<long long>(Q, S_STATUS)[i] = MASKED;  // a finished lane: only its status
    }
    ((int*)Q.p[S_KEYS])[pos] = key;
    ((long long*)Q.p[S_PERM])[pos] = i;
  }
  const int n_rays = __syncthreads_count(rays);
  const int n_pending = __syncthreads_count(pending);
  if (threadIdx.x != 0) return;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  atomicAdd(scratch + SC_RAYS, (unsigned long long)n_rays);
  atomicAdd(scratch + SC_COUNT, (unsigned long long)n_pending);
  if (!last_block(scratch + SC_TICKET)) return;  // the last block: every count is in
  const unsigned long long r = atomicAdd(scratch + SC_RAYS, 0ull);
  const unsigned long long c = atomicAdd(scratch + SC_COUNT, 0ull);
  *(float*)Q.p[S_NRAYS_OUT] = *(const float*)Q.p[S_NRAYS] + (float)r;
  *(long long*)Q.p[S_COUNT] = (long long)c;
  scratch[SC_RAYS] = scratch[SC_COUNT] = scratch[SC_TICKET] = 0ull;
}

// The tracking round of every row of 128 sorted positions; gated when S_CTRL
// is set (on the same count as the round's phase A).
__global__ void __launch_bounds__(ROW_W) round_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  if (ctrl != nullptr && stage_stopped(ctrl, 1, 0)) return;
  __shared__ float row_tab[TRK_ROW];
  const int q = blockIdx.x * ROW_W + threadIdx.x;
  const int* skeys = (const int*)Q.p[S_SKEYS];
  const int row_key = skeys[blockIdx.x * ROW_W];
  const int key = skeys[q];
  const long long lane = ((const long long*)Q.p[S_PERM])[((const long long*)Q.p[S_ORDER])[q]];
  const int i = (int)lane;
  out<long long>(Q, S_POS)[i] = q;
  if (row_key != SENTINEL) {  // the row's brick (uniform over the block)
    const long long brick = min((long long)row_key, P.i[IP_NBRICKS] - 1);
    const float* src = in<float>(Q, S_TABLES) + brick * TRK_ROW;
    row_tab[threadIdx.x] = src[threadIdx.x];
    row_tab[threadIdx.x + ROW_W] = src[threadIdx.x + ROW_W];
    __syncthreads();
  }
  const bool usable = row_key != SENTINEL && key == row_key;
  if (usable) {
    // the lane's ray in voxel space (the steps are geometry-free)
    const float* fo = in<float>(Q, S_O) + 3 * (long long)i;
    const float* fd = in<float>(Q, S_D) + 3 * (long long)i;
    const float* fb = in<float>(Q, S_BASE) + 3 * (long long)i;
    float o[3], d[3], base[3];
    for (int a = 0; a < 3; ++a) {
      o[a] = (fo[a] - P.f[FP_BMIN + a]) * P.f[FP_VOXS + a];
      d[a] = fd[a] * P.f[FP_VOXS + a];
      base[a] = fb[a];
    }
    const float isig = in<float>(Q, S_ISIG)[i];
    float t = in<float>(Q, S_T)[i];
    uint32_t state = (uint32_t)in<long long>(Q, S_RS)[i];
    int status = TRK_RUNNING, tap = 0;
    brick_steps(row_tab, o, d, base, in<float>(Q, S_MAXT)[i], in<float>(Q, S_BEXIT)[i], isig,
                isig * P.f[FP_SCALE], (int)P.i[IP_KSTEPS], t, status, tap, state,
                (uint32_t)in<long long>(Q, S_RINC)[i]);
    out<float>(Q, S_T)[i] = t;
    // a lane still RUNNING at the round's end is masked for the next phase A
    out<long long>(Q, S_STATUS)[i] = status == TRK_RUNNING ? MASKED : (long long)status;
    out<long long>(Q, S_RS)[i] = (long long)state;
  } else if (out_of_place(Q)) {
    out<float>(Q, S_T)[i] = in<float>(Q, S_T)[i];
    out<long long>(Q, S_STATUS)[i] = in<long long>(Q, S_STATUS)[i];
    out<long long>(Q, S_RS)[i] = in<long long>(Q, S_RS)[i];
  }
  if (ctrl == nullptr) return;
  __syncthreads();  // every thread of the block has read the gate
  if (threadIdx.x != 0) return;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  if (!last_block(scratch + SC_RTICKET)) return;  // the last block: the round is done
  ctrl[C_COUNT] = *(const long long*)Q.p[S_COUNT];
  ctrl[C_EVAL] = ctrl[C_EVAL] + 1;
  scratch[SC_RTICKET] = 0ull;
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

// Plain C entry points, loaded with ctypes (ops/brickbody.py).  fparams
// (N_FP,) float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses,
// all in host memory and copied into the launch; width lanes (a multiple of
// 128 for a round).  Returns cudaGetLastError(), or -1 when a size does not
// match this build's.

// One launch of the entry point IP_OP (phase A or the round): the scratch
// (N_SCRATCH uint64) zero before the launch, and zero after it; with
// ptrs[S_CTRL] set, gated on the loop's control words (C_EVAL, C_COUNT) that
// the host set at its start.
extern "C" int brickbody_launch(const float* fparams, int n_fp, const long long* iparams,
                                int n_ip, void* const* ptrs, int n_s, int width,
                                void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width <= 0) return 0;
  const Params P = params_of(fparams, iparams);
  const Ptrs Q = ptrs_of(ptrs);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P.i[IP_OP]) {
    case OP_PHASE_A:
      phase_a_kernel<<<(width + THREADS - 1) / THREADS, THREADS, 0, st>>>(P, Q, width);
      break;
    case OP_ROUND:
      if (width % ROW_W != 0) return -1;
      round_kernel<<<width / ROW_W, ROW_W, 0, st>>>(P, Q, width);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_FP, N_IP, N_S, N_CTRL), for the
// wrapper's check.
extern "C" void brickbody_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
