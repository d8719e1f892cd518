// nestedreplay.cu — render_diff's bounce-lockstep replays, one- and two-level,
// for every lane of a replay, for Hopper (sm_90a).
//
// Replaces the loops that XLA compiled into one device program under `_replay`'s
// lax.while_loop (cudavolumerenderer_tpu/models/differentiable.py:980; no
// Pallas kernel):
//   * `_replay_bounce` (:204), the one-level replay under the global majorant,
//     its Woodcock lax.while_loop at :270: the default differentiable path
//     (render_diff's two_level=False backward, pass A and pass B);
//   * `_replay_bounce_2l` (:344), the nested two-level replay, its tracking
//     loop at :513 (render_diff's replay with fused=False).
// Each computes what the port's eager loop (models/differentiable.py
// `_nested_loop` over `_replay_bounce` / `_replay_bounce_2l`, the plain
// version) computes on the card, bit for bit, in the same order.  Per lane
// and bounce, up to max_path_length bounces while the lane is alive:
//   * the AABB slab test: a miss adds throughput * Le to the radiance and
//     ends the path;
//   * inside the box the whole tracking chain: one-level, Woodcock steps
//     under the global majorant (a flight, the density at o + t d sampled
//     'trilinear' or 'nearest', the acceptance test, until an acceptance or
//     the exit); two-level, common.cuh track_step_2l (the brick probe with
//     the Chebyshev leap, a flight under the brick's majorant, the 30-bit
//     stochastic tap);
//   * a boundary event (GGX or the null BSDF, common.cuh boundary_event) or
//     an HG scatter at o + d t - d eps with the albedo there (one-level: the
//     albedo grid sampled; two-level: the accepted tap's row);
//   * Russian roulette.
// Every draw comes from the lane's own PCG stream, taken only under the eager
// loop's masks (`running` for the Woodcock draws, `boundary` for GGX,
// `scattered` for HG, `alive` for RR).
//
// With a record mode (the backward's pass B) it adds the adjoints:
//   * the density's score term of each evaluated collision inside [0, max_t],
//     s * (1 / rho) (real) or s * (-1 / (rho_max - rho)) (null): one-level to
//     the eight taps of `_trilerp_taps` (always trilinear, weights multiplied
//     (x * y) * z), two-level to the one tap with the brick's majorant;
//   * the albedo's g_c / albedo_c at a scatter (the alpha channel 0): one-level
//     to the eight trilinear taps of the scatter point, two-level to its row.
// Atomic mode adds them with atomicAdd; a constant (one-row) albedo's adjoints
// are summed per thread and per block in double and added to the row once, by
// the last block.  Buffer mode (the wrapper's choice under
// torch.use_deterministic_algorithms) runs the lockstep launches below and
// writes the eager loop's (index, value) arrays, which the wrapper adds as the
// eager loop does (index_add_ in its (step, tap) order; a constant albedo's
// sums per bounce), so the cotangents are the eager loop's bit for bit.
//
// Launches (ops/nestedreplay.py):
//   * drain_kernel (the primal's pass A, and pass B with atomics): each thread
//     loads its lane's start (o, d, its PCG stream; s and g in pass B) once,
//     runs its bounces to its end in registers and stores its end once.  The
//     lanes are independent, so this is the lockstep loop per lane: a lane alive
//     at bounce b has taken b bounces in both.  What bounds it: the longest
//     lane's chain of dependent Woodcock steps (~scale * rho_max * extent per
//     crossing under the global majorant), not bytes; a stats word keeps that
//     lane's steps and bounces.
//   * lockstep_kernel (pass B under deterministic algorithms), one thread per
//     lane, the lane's state in SoA tensors between launches: OP_START (the
//     slab test of a bounce), OP_CHAIN (IP_STEPS Woodcock steps, each lane's
//     records of every step, as the eager loop adds s * 0 at a lane that does
//     not run: one-level at the taps of o + (t + its unconsumed flight) d),
//     OP_END (the events and the albedo's records); each leaves the count the
//     eager loop reads next (running lanes, or alive lanes) in the count word,
//     by a block count and the last block.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;
constexpr int DRAIN_THREADS = 64;
constexpr int N_TAPS = 8;  // _trilerp_taps

// Float parameters (ops/nestedreplay.py FP_*).
enum {
  FP_BMIN = 0, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3,
  FP_RMD = FP_EXT + 3,   // the density's (nx, ny, nz) - 1
  FP_RMA = FP_RMD + 3,   // the albedo's
  FP_BSIZE = FP_RMA + 3, // the two-level brick size in voxels
  FP_SCALE = FP_BSIZE + 3, FP_INV_SIGMAT, FP_RHO_MAX, FP_G, FP_LE,
  FP_EPSW = FP_LE + 3, FP_ROUGH, FP_ETA = FP_ROUGH + 2, FP_INV_ETA, N_FP,
};

// Integer parameters (ops/nestedreplay.py IP_*); IP_NX .. IP_HIZ in
// common.cuh TwoLevel's order.
enum {
  IP_NX = 0, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ,
  IP_AX, IP_AY, IP_AZ, IP_NCH, IP_NEAREST, IP_BSDF, IP_MITSUBA, IP_RR,
  IP_MAXPATH, IP_TWO_LEVEL, IP_RECORD, IP_CONST_ALB, IP_OP, IP_STEPS, N_IP,
};

// Record modes (IP_RECORD) and lockstep entry points (IP_OP).
enum { REC_NONE = 0, REC_ATOMIC = 1, REC_BUFFERS = 2 };
enum { OP_START = 0, OP_CHAIN, OP_END };

// Pointer slots (ops/nestedreplay.py S_*): the lane's start (o, d, the RNG's
// two words) and pass B's weights; its end (o, d, throughput, radiance,
// alive, the RNG's state); the lockstep's per-bounce fields; the tables; the
// cotangents; the record buffers; the scratch, the count and the stats.
enum {
  S_O0 = 0, S_D0, S_RS0, S_RINC, S_SLANE, S_GLANE,
  S_O, S_D, S_TP, S_RAD, S_ALIVE, S_RS,
  S_MAXT, S_NRM, S_T, S_RUN, S_INMED, S_SCAT, S_TAPS, S_BEXIT, S_ISL, S_RLOC,
  S_DENSITY, S_ALBEDO, S_MAJOR, S_LEAP, S_DD, S_DA,
  S_REC_DIDX, S_REC_DVAL, S_REC_AIDX, S_REC_AVAL,
  S_SCRATCH, S_COUNT, S_STATS, N_S,
};

// The scratch's words: a count, the last-block ticket (uint64), then a
// constant albedo's three sums (double).  Zero before and after a launch.
enum { SC_COUNT = 0, SC_TICKET, SC_ALB, N_SCRATCH = SC_ALB + 3 };
// The stats' int64 words (the drain): the longest lane's steps << 24 |
// bounces, the most bounces, all lanes' steps and bounces.
enum { ST_LONGEST = 0, ST_BOUNCES, ST_STEPS, ST_BOUNCES_ALL, N_STATS };

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// One lane's path state, in registers.
struct Lane {
  float o[3], d[3], tp[3], rad[3];
  uint32_t rs, inc;
  bool alive;
};

// One bounce's tracking state: the slab test's distance and normal, t, the
// two-level brick state and accepted tap, and the masks.
struct Seg {
  float maxt, nrm[3], t, bexit, isl, rloc;
  long long tap;
  bool run, inmed, scat;
};

// The density's eight taps (_trilerp_taps) at the world point p: flat indices
// and weights.
__device__ __forceinline__ void trilerp_taps(const float bmin[3], const float ext[3],
                                             const float rm1[3], const long long n[3],
                                             const float p[3], long long idx[N_TAPS],
                                             float w[N_TAPS]) {
  float coord[3], f[3];
  long long i0[3];
  for (int a = 0; a < 3; ++a) {
    coord[a] = ((p[a] - bmin[a]) / ext[a]) * rm1[a];
    const float c0 = floorf(coord[a]);
    i0[a] = to_index(c0);
    f[a] = coord[a] - c0;
  }
  int j = 0;
  for (int dz = 0; dz < 2; ++dz) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx, ++j) {
        const long long ix = clampll(i0[0] + dx, n[0] - 1);
        const long long iy = clampll(i0[1] + dy, n[1] - 1);
        const long long iz = clampll(i0[2] + dz, n[2] - 1);
        w[j] = ((dx ? f[0] : 1.0f - f[0]) * (dy ? f[1] : 1.0f - f[1])) *
               (dz ? f[2] : 1.0f - f[2]);
        idx[j] = (iz * n[1] + iy) * n[0] + ix;
      }
    }
  }
}

__device__ __forceinline__ TwoLevel two_level_of(const Params& P, const Ptrs& Q) {
  return TwoLevel{P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RMD, P.f + FP_BSIZE,
                  P.f[FP_SCALE], P.f[FP_EPSW], P.i + IP_NX,
                  (const float*)Q.p[S_MAJOR], (const float*)Q.p[S_LEAP],
                  (const float*)Q.p[S_DENSITY]};
}

// A bounce's start: the slab test; a miss adds throughput * Le and ends the
// path; a hit keeps max_t and the normal and runs the lane where it is inside.
__device__ __forceinline__ void seg_start(const Params& P, Lane& L, Seg& B) {
  B.t = 0.0f;
  B.bexit = -1.0f;
  B.isl = 0.0f;
  B.rloc = 0.0f;
  B.tap = 0;
  B.run = B.inmed = B.scat = false;
  B.maxt = 0.0f;
  B.nrm[0] = B.nrm[1] = B.nrm[2] = 0.0f;
  if (!L.alive) return;
  const BoxHit h = box_hit(P.f + FP_BMIN, P.f + FP_BMAX, L.o, L.d);
  const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
  const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
  if (!hit) {
    for (int k = 0; k < 3; ++k) L.rad[k] = L.rad[k] + L.tp[k] * P.f[FP_LE + k];
    L.alive = false;
    return;
  }
  B.maxt = h.dist;
  for (int k = 0; k < 3; ++k) B.nrm[k] = h.nrm[k];
  B.inmed = inside;
  B.run = inside;
}

// One one-level Woodcock step of a running lane; its score term (s times
// 1 / rho or -1 / (rho_max - rho), or 0 past max_t or for a lane that does not
// run), and the point whose taps take it.
__device__ __forceinline__ float step_1l(const Params& P, const Ptrs& Q, Lane& L, Seg& B,
                                         float s, float p[3]) {
  const uint32_t next = pcg_next(L.rs, L.inc);
  const float u1 = uniform(next);  // a lane that does not run draws nothing
  const float isig = P.f[FP_INV_SIGMAT];
  const float t_new = B.t + -logf(jmax(u1, EPS)) * isig;
  for (int a = 0; a < 3; ++a) p[a] = L.o[a] + t_new * L.d[a];
  float score = 0.0f;
  if (B.run) {
    L.rs = next;
    const float rho = grid_density_at((const float*)Q.p[S_DENSITY], P.i + IP_NX,
                                      P.f + FP_RMD, P.f + FP_BMIN, P.f + FP_EXT,
                                      P.i[IP_NEAREST] != 0, L.o, L.d, t_new);
    const float u2 = draw_float(L.rs, L.inc);
    const bool overran = t_new > B.maxt;
    const bool accepted = !(P.f[FP_SCALE] * rho * isig < u2);
    if (!overran) {
      score = accepted ? (1.0f / jmax(rho, 1e-8f)) * 1.0f
                       : (1.0f / jmax(P.f[FP_RHO_MAX] - rho, 1e-8f)) * -1.0f;
    }
    B.t = t_new;
    B.run = !(overran || accepted);
  }
  return s * score;
}

// One two-level tracking step of a running lane (common.cuh track_step_2l):
// its score term with the brick's majorant, and the tap that takes it (0 and
// s * 0 where the lane takes no tap).
__device__ __forceinline__ float step_2l(const Params& P, const Ptrs& Q, Lane& L, Seg& B,
                                         float s, long long& tap) {
  tap = 0;
  float score = 0.0f;
  if (!B.run) return s * score;
  TrackStep S;
  track_step_2l(two_level_of(P, Q), L.o, L.d, B.maxt, B.t, B.bexit, B.isl, B.rloc, L.rs,
                L.inc, S);
  if (S.inside) {
    tap = S.tap;
    score = S.accepted ? (1.0f / jmax(S.rho, 1e-8f)) * 1.0f
                       : (1.0f / jmax(B.rloc - S.rho, 1e-8f)) * -1.0f;
  }
  if (S.accepted) {
    B.scat = true;
    B.tap = S.tap;
  }
  B.run = !(S.accepted || S.overran_step || S.overran_empty);
  return s * score;
}

// A bounce's end: the boundary event (GGX or null) at o + d max_t, or the HG
// scatter at os = o + d t - d eps with its albedo; then Russian roulette.  Its
// albedo adjoint g_c / albedo_c (channels past 3 and lanes that do not scatter
// 0), the scatter point and the two-level row are left in adj, os and row.
__device__ __forceinline__ void seg_end(const Params& P, const Ptrs& Q, Lane& L, const Seg& B,
                                        const float g[3], float adj[3], float os[3],
                                        long long& row) {
  const bool two = P.i[IP_TWO_LEVEL] != 0;
  const bool scattered = two ? B.scat : (B.inmed && B.t < B.maxt);
  const bool boundary = L.alive && !scattered;
  for (int k = 0; k < 3; ++k) os[k] = L.o[k] + L.d[k] * B.t - L.d[k] * EPS;
  const long long nch = P.i[IP_NCH];
  row = two && !P.i[IP_CONST_ALB] ? B.tap : 0;
  adj[0] = adj[1] = adj[2] = 0.0f;
  if (boundary) {
    const Ggx G = {P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
                   P.i[IP_MITSUBA] != 0};
    boundary_event(P.i[IP_BSDF] != 0, G, B.nrm, B.maxt, L.o, L.d, L.tp, L.rs, L.inc);
  } else if (scattered) {
    float alb[3];
    if (two) {
      const float* r = (const float*)Q.p[S_ALBEDO] + row * nch;
      for (int k = 0; k < 3; ++k) alb[k] = r[nch == 1 ? 0 : k];
    } else {
      grid_albedo_at((const float*)Q.p[S_ALBEDO], P.i + IP_AX, (int)nch, P.f + FP_RMA,
                     P.f + FP_BMIN, P.f + FP_EXT, P.i[IP_NEAREST] != 0, os, alb);
    }
    for (int k = 0; k < 3 && k < nch; ++k) adj[k] = g[k] / jmax(alb[k], 1e-8f);
    float nd[3];
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
  if (P.i[IP_RR] && L.alive && roulette_kills(L.tp, L.rs, L.inc)) L.alive = false;
}

// ---- the drain ----------------------------------------------------------------

// Atomic mode: a step's score term into the density's cotangent.
__device__ __forceinline__ void add_density(const Params& P, const Ptrs& Q, float val,
                                            const float p[3], long long tap) {
  float* dd = (float*)Q.p[S_DD];
  if (P.i[IP_TWO_LEVEL]) {
    atomicAdd(dd + tap, val);
    return;
  }
  long long idx[N_TAPS];
  float w[N_TAPS];
  trilerp_taps(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RMD, P.i + IP_NX, p, idx, w);
  for (int j = 0; j < N_TAPS; ++j) atomicAdd(dd + idx[j], val * w[j]);
}

// Atomic mode: a scatter's albedo adjoint into the albedo's cotangent, or into
// the thread's sums `acc` for a constant albedo.
__device__ __forceinline__ void add_albedo(const Params& P, const Ptrs& Q, const float adj[3],
                                           const float os[3], long long row, double acc[3]) {
  const long long nch = P.i[IP_NCH];
  const int nk = nch < 3 ? (int)nch : 3;
  float* da = (float*)Q.p[S_DA];
  if (P.i[IP_TWO_LEVEL]) {
    for (int k = 0; k < nk; ++k) {
      if (P.i[IP_CONST_ALB]) {
        acc[k] += (double)adj[k];
      } else {
        atomicAdd(da + row * nch + k, adj[k]);
      }
    }
    return;
  }
  long long idx[N_TAPS];
  float w[N_TAPS];
  trilerp_taps(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RMA, P.i + IP_AX, os, idx, w);
  for (int j = 0; j < N_TAPS; ++j) {
    for (int k = 0; k < nk; ++k) {
      if (P.i[IP_CONST_ALB]) {
        acc[k] += (double)(adj[k] * w[j]);
      } else {
        atomicAdd(da + idx[j] * nch + k, adj[k] * w[j]);
      }
    }
  }
}

// A constant albedo's sums over the block in double, one atomic per channel
// into the scratch (every thread of the block calls it).
__device__ __forceinline__ void block_sum(double v[3], double* acc) {
  __shared__ double part[DRAIN_THREADS / 32][3];
  for (int k = 0; k < 3; ++k) {
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 3; ++k) part[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 0; k < 3; ++k) {
    double sum = 0.0;
    for (int w = 0; w < DRAIN_THREADS / 32; ++w) sum += part[w][k];
    if (sum != 0.0) atomicAdd(acc + k, sum);
  }
}

// Every lane from its start to its end: up to max_path_length bounces.
__global__ void __launch_bounds__(DRAIN_THREADS) drain_kernel(Params P, Ptrs Q, int width) {
  const int i = blockIdx.x * DRAIN_THREADS + threadIdx.x;
  const bool atomic = P.i[IP_RECORD] == REC_ATOMIC;
  const bool two = P.i[IP_TWO_LEVEL] != 0;
  double acc[3] = {0.0, 0.0, 0.0};
  if (i < width) {
    Lane L;
    const float* o0 = (const float*)Q.p[S_O0];
    const float* d0 = (const float*)Q.p[S_D0];
    for (int k = 0; k < 3; ++k) {
      L.o[k] = o0[3 * i + k];
      L.d[k] = d0[3 * i + k];
      L.tp[k] = 1.0f;
      L.rad[k] = 0.0f;
    }
    L.rs = (uint32_t)((const long long*)Q.p[S_RS0])[i];
    L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
    L.alive = true;
    float s = 0.0f, g[3] = {0.0f, 0.0f, 0.0f};
    if (atomic) {
      s = ((const float*)Q.p[S_SLANE])[i];
      for (int k = 0; k < 3; ++k) g[k] = ((const float*)Q.p[S_GLANE])[3 * i + k];
    }
    long long bounces = 0, steps = 0;
    while (bounces < P.i[IP_MAXPATH] && L.alive) {
      Seg B;
      seg_start(P, L, B);
      while (B.run) {
        float p[3], val;
        long long tap = 0;
        val = two ? step_2l(P, Q, L, B, s, tap) : step_1l(P, Q, L, B, s, p);
        ++steps;
        if (atomic && val != 0.0f) add_density(P, Q, val, p, tap);
      }
      float adj[3], os[3];
      long long row;
      seg_end(P, Q, L, B, g, adj, os, row);
      if (atomic && (adj[0] != 0.0f || adj[1] != 0.0f || adj[2] != 0.0f))
        add_albedo(P, Q, adj, os, row, acc);
      ++bounces;
    }
    float* go = (float*)Q.p[S_O];
    float* gd = (float*)Q.p[S_D];
    float* gtp = (float*)Q.p[S_TP];
    float* grad = (float*)Q.p[S_RAD];
    for (int k = 0; k < 3; ++k) {
      go[3 * i + k] = L.o[k];
      gd[3 * i + k] = L.d[k];
      gtp[3 * i + k] = L.tp[k];
      grad[3 * i + k] = L.rad[k];
    }
    ((bool*)Q.p[S_ALIVE])[i] = L.alive;
    ((long long*)Q.p[S_RS])[i] = (long long)L.rs;
    unsigned long long* stats = (unsigned long long*)Q.p[S_STATS];
    atomicMax(stats + ST_LONGEST, ((unsigned long long)steps << 24) |
                                      (unsigned long long)(bounces < (1 << 24) ? bounces
                                                                               : (1 << 24) - 1));
    atomicMax(stats + ST_BOUNCES, (unsigned long long)bounces);
    atomicAdd(stats + ST_STEPS, (unsigned long long)steps);
    atomicAdd(stats + ST_BOUNCES_ALL, (unsigned long long)bounces);
  }
  if (!(atomic && P.i[IP_CONST_ALB])) return;
  // a constant albedo: the block's sums, then the last block adds the whole
  // sum to the row once
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  double* alb_acc = (double*)(scratch + SC_ALB);
  block_sum(acc, alb_acc);
  if (threadIdx.x != 0 || !last_block(scratch + SC_TICKET)) return;
  float* da = (float*)Q.p[S_DA];
  const long long nch = P.i[IP_NCH];
  for (int k = 0; k < 3 && k < nch; ++k) {
    da[k] = da[k] + (float)__ldcg(alb_acc + k);
    alb_acc[k] = 0.0;
  }
  scratch[SC_TICKET] = 0ull;
}

// ---- the lockstep launches (buffer mode) ----------------------------------------

__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, Lane& L) {
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
  L.alive = ((const bool*)Q.p[S_ALIVE])[i];
}

__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, const Lane& L) {
  float* go = (float*)Q.p[S_O];
  float* gd = (float*)Q.p[S_D];
  float* gtp = (float*)Q.p[S_TP];
  float* grad = (float*)Q.p[S_RAD];
  for (int k = 0; k < 3; ++k) {
    go[3 * i + k] = L.o[k];
    gd[3 * i + k] = L.d[k];
    gtp[3 * i + k] = L.tp[k];
    grad[3 * i + k] = L.rad[k];
  }
  ((long long*)Q.p[S_RS])[i] = (long long)L.rs;
  ((bool*)Q.p[S_ALIVE])[i] = L.alive;
}

__device__ __forceinline__ void load_seg(const Ptrs& Q, int i, Seg& B) {
  B.maxt = ((const float*)Q.p[S_MAXT])[i];
  for (int k = 0; k < 3; ++k) B.nrm[k] = ((const float*)Q.p[S_NRM])[3 * i + k];
  B.t = ((const float*)Q.p[S_T])[i];
  B.bexit = ((const float*)Q.p[S_BEXIT])[i];
  B.isl = ((const float*)Q.p[S_ISL])[i];
  B.rloc = ((const float*)Q.p[S_RLOC])[i];
  B.tap = ((const long long*)Q.p[S_TAPS])[i];
  B.run = ((const bool*)Q.p[S_RUN])[i];
  B.inmed = ((const bool*)Q.p[S_INMED])[i];
  B.scat = ((const bool*)Q.p[S_SCAT])[i];
}

__device__ __forceinline__ void store_seg(const Ptrs& Q, int i, const Seg& B) {
  ((float*)Q.p[S_MAXT])[i] = B.maxt;
  for (int k = 0; k < 3; ++k) ((float*)Q.p[S_NRM])[3 * i + k] = B.nrm[k];
  ((float*)Q.p[S_T])[i] = B.t;
  ((float*)Q.p[S_BEXIT])[i] = B.bexit;
  ((float*)Q.p[S_ISL])[i] = B.isl;
  ((float*)Q.p[S_RLOC])[i] = B.rloc;
  ((long long*)Q.p[S_TAPS])[i] = B.tap;
  ((bool*)Q.p[S_RUN])[i] = B.run;
  ((bool*)Q.p[S_INMED])[i] = B.inmed;
  ((bool*)Q.p[S_SCAT])[i] = B.scat;
}

// One lockstep launch of every lane (IP_OP); the count of the lanes that run
// (OP_START, OP_CHAIN) or are alive (OP_END) into the count word.
__global__ void __launch_bounds__(THREADS) lockstep_kernel(Params P, Ptrs Q, int width) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const long long op = P.i[IP_OP];
  const bool two = P.i[IP_TWO_LEVEL] != 0;
  bool counted = false;
  if (i < width) {
    Lane L;
    Seg B;
    load_lane(Q, i, L);
    if (op == OP_START) {
      seg_start(P, L, B);
      counted = B.run;
    } else {
      load_seg(Q, i, B);
      const float s = ((const float*)Q.p[S_SLANE])[i];
      if (op == OP_CHAIN) {
        long long* didx = (long long*)Q.p[S_REC_DIDX];
        float* dval = (float*)Q.p[S_REC_DVAL];
        const long long taps = two ? 1 : N_TAPS;
        for (long long k = 0; k < P.i[IP_STEPS]; ++k) {
          float p[3];
          long long tap = 0, idx[N_TAPS];
          float w[N_TAPS];
          const float val = two ? step_2l(P, Q, L, B, s, tap) : step_1l(P, Q, L, B, s, p);
          if (two) {
            idx[0] = tap;
            w[0] = 1.0f;
          } else {
            trilerp_taps(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RMD, P.i + IP_NX, p, idx, w);
          }
          for (long long j = 0; j < taps; ++j) {
            const long long at = (k * taps + j) * width + i;
            didx[at] = idx[j];
            dval[at] = two ? val : val * w[j];
          }
        }
        counted = B.run;
      } else {
        float g[3], adj[3], os[3];
        for (int k = 0; k < 3; ++k) g[k] = ((const float*)Q.p[S_GLANE])[3 * i + k];
        long long row;
        seg_end(P, Q, L, B, g, adj, os, row);
        const long long nch = P.i[IP_NCH];
        long long* aidx = (long long*)Q.p[S_REC_AIDX];
        float* aval = (float*)Q.p[S_REC_AVAL];
        if (two) {
          const bool scattered = B.scat;
          aidx[i] = scattered ? row : 0;
          for (long long c = 0; c < nch; ++c) aval[i * nch + c] = c < 3 ? adj[c] : 0.0f;
        } else {
          long long idx[N_TAPS];
          float w[N_TAPS];
          trilerp_taps(P.f + FP_BMIN, P.f + FP_EXT, P.f + FP_RMA, P.i + IP_AX, os, idx, w);
          for (int j = 0; j < N_TAPS; ++j) {
            aidx[(long long)j * width + i] = idx[j];
            for (long long c = 0; c < nch; ++c)
              aval[((long long)j * width + i) * nch + c] = (c < 3 ? adj[c] : 0.0f) * w[j];
          }
        }
        counted = L.alive;
      }
    }
    store_lane(Q, i, L);
    store_seg(Q, i, B);
  }
  const int n = __syncthreads_count(counted);
  if (threadIdx.x != 0) return;
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  atomicAdd(scratch + SC_COUNT, (unsigned long long)n);
  if (!last_block(scratch + SC_TICKET)) return;  // the last block: every count is in
  *(long long*)Q.p[S_COUNT] = (long long)atomicAdd(scratch + SC_COUNT, 0ull);
  scratch[SC_COUNT] = scratch[SC_TICKET] = 0ull;
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

// Plain C entry points, loaded with ctypes (ops/nestedreplay.py).  fparams
// (N_FP,) float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses,
// all in host memory and copied into the launch; width lanes.  Each returns
// cudaGetLastError(), or -1 when a size does not match this build's.

// lockstep_kernel (IP_OP): the scratch (N_SCRATCH words) zero before the
// launch and zero after it.
extern "C" int nestedreplay_launch(const float* fparams, int n_fp, const long long* iparams,
                                   int n_ip, void* const* ptrs, int n_s, int width,
                                   void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    const int blocks = (width + THREADS - 1) / THREADS;
    lockstep_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// drain_kernel in blocks of DRAIN_THREADS: the scratch zero before the launch
// (zero after it), the stats (N_STATS int64) zero before it.
extern "C" int nestedreplay_drain(const float* fparams, int n_fp, const long long* iparams,
                                  int n_ip, void* const* ptrs, int n_s, int width,
                                  void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    const int blocks = (width + DRAIN_THREADS - 1) / DRAIN_THREADS;
    drain_kernel<<<blocks, DRAIN_THREADS, 0, (cudaStream_t)stream>>>(
        params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// The layout sizes this build expects (N_FP, N_IP, N_S, N_CTRL), for the
// wrapper's check (no stage control words are used; N_CTRL is common.cuh's).
extern "C" void nestedreplay_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
