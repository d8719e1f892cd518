// replaybody.cu — one evaluation of the fused two-level path replay of
// render_diff for every lane of a pool, for Hopper (sm_90a).
//
// Replaces the body of cudavolumerenderer_tpu/models/differentiable.py:623
// (`_replay_2l_fused`'s `body`, which XLA compiled into one device program
// under the cascade's lax.while_loop; it is no Pallas kernel).  It computes
// what the port's eager body (models/differentiable.py, `_replay_body`, the
// plain version) computes on the card, bit for bit, in the same order: per
// lane,
//   A. a lane that starts a segment takes the AABB slab test: a miss adds
//      throughput * Le to its radiance and ends the path; a hit starts the
//      segment (t = 0, max_t = the hit distance, the face normal kept), and an
//      outside hit is a boundary event now;
//   B. one two-level tracking step of a lane inside the medium
//      (differentiable._track_step; common.cuh track_step_2l, which
//      nestedreplay.cu's nested replay runs too): the brick probe at t >= brick_exit under
//      the dilated majorant with the Chebyshev leap over empty bricks, a
//      flight under the brick's majorant, the crossing test against
//      min(brick_exit, max_t), the 30-bit stochastic tap and the acceptance
//      test, with the overran-step and overran-empty exits;
//   C. a boundary event (GGX or the null BSDF) at o + d max_t, or an HG
//      scatter at the accepted tap with its albedo; Russian roulette on the
//      lanes whose segment ended, then the bounce cap.
// Every draw comes from the lane's own PCG stream, taken only under the eager
// body's mask; a lane that is no longer alive is a fixed point.
//
// With a record mode (the backward's pass B) it also adds the adjoints:
//   * the density's score term at the tap, s * (1 / rho) for a real and
//     s * (-1 / (rho_local - rho)) for a null collision (_record_density);
//   * the albedo's reparameterised adjoint g_c / albedo_c at a scatter's row
//     (_record_albedo; a constant, 1-row albedo gets each evaluation's sum,
//     taken in double and added once per evaluation in evaluation order, as
//     the eager body adds torch.sum of the evaluation's adjoints).
// Atomic mode adds them with atomicAdd; buffer mode (chosen by the wrapper
// under torch.use_deterministic_algorithms) writes each lane's (index, value)
// pairs, the arrays the eager body builds, and the wrapper adds them with
// index_add_ in its order.  A lane that adds nothing adds nothing; the eager
// body's +0.0 added to row 0 changes no sum, so only a NaN (s * 0 with s
// not finite) is added there, as the eager body does.
//
// Three launches run the body (ops/replaybody.py):
//   * replay_kernel, one evaluation of every lane (run_body): one thread per
//     lane, the _Lanes tensors read and written in place (SoA, int64 words
//     holding the u32 RNG).  The alive count reduces per block with
//     __syncthreads_count and across blocks with atomics; the last block
//     writes it and clears the scratch.  What bounds it: bytes.  It moves
//     every lane's whole state, ~107 B read and ~99 B written (+16 B read in
//     pass B), but the function needs only the fields a lane's branch reads
//     and the ones it changes (a dead lane its alive flag), plus each
//     distinct density tap, brick row and albedo row once (ops/replaybody.
//     replay_bytes).
//   * replay_kernel gated (a stage whose loop exits at an alive count above
//     0): each launch reads the stage's control words (common.cuh: the
//     evaluation index and the last alive count) and returns untouched when
//     the loop would have stopped there: at an index that starts a chain,
//     with the count at or under the threshold.  The last block advances
//     the index.
//   * drain_kernel (the last stage: its loop exits at an alive count of 0, so
//     no lane waits for another): each thread loads its lane once, runs
//     evaluations in registers until the lane dies or a cap is reached, and
//     stores it once.  The last block leaves the longest lane's evaluations L
//     and, once no lane is left, E = k_chain * ceil(L / k_chain), the loop's
//     evaluations.  It is bound by the longest lane's chain of dependent
//     steps, not by bytes.
//
#include "common.cuh"

namespace {

using namespace cvr;

constexpr int THREADS = 256;
// the drain's threads per block: a narrow pool in small blocks spreads over
// the SMs (as fastbody.cu's drain)
constexpr int DRAIN_THREADS = 32;

// Float parameters (ops/replaybody.py FP_*).
enum {
  FP_BMIN = 0, FP_BMAX = FP_BMIN + 3, FP_EXT = FP_BMAX + 3, FP_RM1 = FP_EXT + 3,
  FP_BSIZE = FP_RM1 + 3, FP_SCALE = FP_BSIZE + 3, FP_G, FP_LE,
  FP_EPSW = FP_LE + 3, FP_ROUGH, FP_ETA = FP_ROUGH + 2, FP_INV_ETA, N_FP,
};

// Integer parameters (ops/replaybody.py IP_*).
enum {
  IP_NX = 0, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ,
  IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH, IP_RECORD, IP_CONST_ALB, IP_NCHAN,
  IP_THRESH, IP_CHAIN, IP_DRAIN_CAP,  // a stage's exit threshold, chain, drain cap
  N_IP,
};

// Record modes (IP_RECORD).
enum { REC_NONE = 0, REC_ATOMIC = 1, REC_BUFFERS = 2 };

// Pointer slots (ops/replaybody.py S_*): the 15 per-lane fields the body
// updates, the read-only per-lane ones, the outputs (the 15 fields again),
// the alive count, the scratch, the tables, the cotangents, the record
// buffers and a stage's control words (null where a launch uses none).
enum {
  S_O = 0, S_D, S_TP, S_RAD, S_NRM, S_T, S_BEXIT, S_ISL, S_RLOC, S_MAXT,
  S_BOUNCE, S_RS, S_ALIVE, S_SEG, S_INMED,
  N_LANE,
  S_RINC = N_LANE, S_SLANE, S_GLANE,
  S_OUT, S_COUNT = S_OUT + N_LANE, S_SCRATCH,
  S_MAJOR, S_LEAP, S_DENSITY, S_ALBEDO, S_DD, S_DA,
  S_REC_DIDX, S_REC_DVAL, S_REC_AIDX, S_REC_AADJ, S_CTRL, S_ALB_EVALS, N_S,
};

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// One lane's state, in registers.
struct Lane {
  float o[3], d[3], tp[3], rad[3], nrm[3];
  float t, bexit, isl, rloc, maxt;
  long long bounce;
  uint32_t rs, inc;
  bool alive, seg, inmed;
};

// What one evaluation adds in pass B: the density's (index, value) and, at a
// scatter, the albedo row and its adjoint (channels past 3 are 0).
struct Rec {
  long long didx, aidx;
  float dval, adj[3];
  bool inside, scat;
};

__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, Lane& L) {
  const float* fo = (const float*)Q.p[S_O];
  const float* fd = (const float*)Q.p[S_D];
  const float* ftp = (const float*)Q.p[S_TP];
  const float* frad = (const float*)Q.p[S_RAD];
  const float* fnrm = (const float*)Q.p[S_NRM];
  for (int k = 0; k < 3; ++k) {
    L.o[k] = fo[3 * i + k];
    L.d[k] = fd[3 * i + k];
    L.tp[k] = ftp[3 * i + k];
    L.rad[k] = frad[3 * i + k];
    L.nrm[k] = fnrm[3 * i + k];
  }
  L.t = ((const float*)Q.p[S_T])[i];
  L.bexit = ((const float*)Q.p[S_BEXIT])[i];
  L.isl = ((const float*)Q.p[S_ISL])[i];
  L.rloc = ((const float*)Q.p[S_RLOC])[i];
  L.maxt = ((const float*)Q.p[S_MAXT])[i];
  L.bounce = ((const long long*)Q.p[S_BOUNCE])[i];
  L.rs = (uint32_t)((const long long*)Q.p[S_RS])[i];
  L.inc = (uint32_t)((const long long*)Q.p[S_RINC])[i];
  L.alive = ((const bool*)Q.p[S_ALIVE])[i];
  L.seg = ((const bool*)Q.p[S_SEG])[i];
  L.inmed = ((const bool*)Q.p[S_INMED])[i];
}

__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, const Lane& L) {
  float* go = (float*)Q.p[S_OUT + S_O];
  float* gd = (float*)Q.p[S_OUT + S_D];
  float* gtp = (float*)Q.p[S_OUT + S_TP];
  float* grad = (float*)Q.p[S_OUT + S_RAD];
  float* gnrm = (float*)Q.p[S_OUT + S_NRM];
  for (int k = 0; k < 3; ++k) {
    go[3 * i + k] = L.o[k];
    gd[3 * i + k] = L.d[k];
    gtp[3 * i + k] = L.tp[k];
    grad[3 * i + k] = L.rad[k];
    gnrm[3 * i + k] = L.nrm[k];
  }
  ((float*)Q.p[S_OUT + S_T])[i] = L.t;
  ((float*)Q.p[S_OUT + S_BEXIT])[i] = L.bexit;
  ((float*)Q.p[S_OUT + S_ISL])[i] = L.isl;
  ((float*)Q.p[S_OUT + S_RLOC])[i] = L.rloc;
  ((float*)Q.p[S_OUT + S_MAXT])[i] = L.maxt;
  ((long long*)Q.p[S_OUT + S_BOUNCE])[i] = L.bounce;
  ((long long*)Q.p[S_OUT + S_RS])[i] = (long long)L.rs;
  ((bool*)Q.p[S_OUT + S_ALIVE])[i] = L.alive;
  ((bool*)Q.p[S_OUT + S_SEG])[i] = L.seg;
  ((bool*)Q.p[S_OUT + S_INMED])[i] = L.inmed;
}

// One evaluation of the replay body for one lane (s, g: the lane's score
// weight and per-channel adjoint weight, read in pass B only).
__device__ __forceinline__ void evaluate(const Params& P, const Ptrs& Q, Lane& L, float s,
                                         const float g[3], Rec& R) {
  const float* bmin = P.f + FP_BMIN;
  const float* ext = P.f + FP_EXT;
  const float* rm1 = P.f + FP_RM1;
  const float scale = P.f[FP_SCALE];
  R.inside = R.scat = false;
  R.didx = R.aidx = 0;
  R.dval = s * 0.0f;
  R.adj[0] = R.adj[1] = R.adj[2] = 0.0f;

  // -- A: segment start -------------------------------------------------------
  bool imm_bnd = false;
  if (L.alive && !L.seg) {
    const BoxHit h = box_hit(bmin, P.f + FP_BMAX, L.o, L.d);
    const bool hit = h.smallest_tmax > h.largest_tmin && h.dist > 0.0f;
    const bool inside = sum3(h.nrm[0] * L.d[0], h.nrm[1] * L.d[1], h.nrm[2] * L.d[2]) > 0.0f;
    if (!hit) {
      for (int k = 0; k < 3; ++k) L.rad[k] = L.rad[k] + L.tp[k] * P.f[FP_LE + k];
      L.alive = false;
    } else {
      L.seg = true;
      L.t = 0.0f;
      L.bexit = -1.0f;
      L.isl = 0.0f;
      L.rloc = 0.0f;
      L.maxt = h.dist;
      for (int k = 0; k < 3; ++k) L.nrm[k] = h.nrm[k];
      L.inmed = inside;
      imm_bnd = !inside;
    }
  }

  // -- B: one two-level tracking step (common.cuh track_step_2l) ----------------
  TrackStep S{};
  if (L.seg && L.alive && L.inmed) {
    const TwoLevel G = {bmin, ext, rm1, P.f + FP_BSIZE, scale, P.f[FP_EPSW], P.i + IP_NX,
                        (const float*)Q.p[S_MAJOR], (const float*)Q.p[S_LEAP],
                        (const float*)Q.p[S_DENSITY]};
    track_step_2l(G, L.o, L.d, L.maxt, L.t, L.bexit, L.isl, L.rloc, L.rs, L.inc, S);
    if (S.inside) {
      R.inside = true;
      R.didx = S.tap;
      R.dval = s * (S.accepted ? (1.0f / jmax(S.rho, 1e-8f)) * 1.0f
                               : (1.0f / jmax(L.rloc - S.rho, 1e-8f)) * -1.0f);
    }
  }
  const bool accepted = S.accepted;
  const long long tap = S.tap;

  // -- C: the events of lanes whose segment ended ---------------------------------
  const bool trk_done = accepted || S.overran_step || S.overran_empty;
  const bool bnd_now = (trk_done && !accepted) || imm_bnd;
  const bool done_now = trk_done || imm_bnd;
  L.seg = L.seg && !done_now;
  if (bnd_now) {
    const Ggx G = {P.f[FP_ROUGH], P.f[FP_ROUGH + 1], P.f[FP_ETA], P.f[FP_INV_ETA],
                   P.i[IP_MITSUBA] != 0};
    boundary_event(P.i[IP_BSDF] != 0, G, L.nrm, L.maxt, L.o, L.d, L.tp, L.rs, L.inc);
  }
  if (accepted) {
    const long long nch = P.i[IP_NCHAN];
    const long long row = P.i[IP_CONST_ALB] ? 0 : tap;
    const float* alb_row = (const float*)Q.p[S_ALBEDO] + row * nch;
    float alb[3];
    for (int k = 0; k < 3; ++k) alb[k] = alb_row[nch == 1 ? 0 : k];
    R.scat = true;
    R.aidx = row;
    for (int k = 0; k < 3 && k < nch; ++k) R.adj[k] = g[k] / jmax(alb[k], 1e-8f);
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

  // -- Russian roulette, then the bounce cap ---------------------------------------
  if (P.i[IP_RR] && done_now && L.alive) {
    const float p = jmin(jmax(jmax(L.tp[0], L.tp[1]), L.tp[2]), 1.0f);
    const float u = draw_float(L.rs, L.inc);
    if (u > p) {
      L.alive = false;
    } else {
      const float q = jmax(p, 1e-20f);
      for (int k = 0; k < 3; ++k) L.tp[k] = L.tp[k] / q;
    }
  }
  if (done_now) {
    L.bounce = L.bounce + 1;
    if (L.bounce >= P.i[IP_MAXPATH]) L.alive = false;
  }
}

// The lane's score weight s and adjoint weight g (pass B), else zeros.
__device__ __forceinline__ float load_weights(const Params& P, const Ptrs& Q, int i, float g[3]) {
  g[0] = g[1] = g[2] = 0.0f;
  if (P.i[IP_RECORD] == REC_NONE) return 0.0f;
  const float* gl = (const float*)Q.p[S_GLANE];
  for (int k = 0; k < 3; ++k) g[k] = gl[3 * i + k];
  return ((const float*)Q.p[S_SLANE])[i];
}

// Atomic mode: the evaluation's adjoints into the flat cotangents, but for a
// constant albedo's (the caller sums those per evaluation).
__device__ __forceinline__ void record_atomic(const Params& P, const Ptrs& Q, const Rec& R) {
  float* dd = (float*)Q.p[S_DD];
  if (R.inside) {
    atomicAdd(dd + R.didx, R.dval);
  } else if (isnan(R.dval)) {
    atomicAdd(dd, R.dval);  // the eager body's s * 0 at row 0, where it is NaN
  }
  if (!R.scat || P.i[IP_CONST_ALB]) return;
  const long long nch = P.i[IP_NCHAN];
  float* da = (float*)Q.p[S_DA] + R.aidx * nch;
  for (int k = 0; k < 3 && k < nch; ++k) atomicAdd(da + k, R.adj[k]);
}

// A constant albedo: the eager body adds each evaluation's sum of adjoints to
// its one row (da += sum(adj)).  The kernels sum an evaluation's adjoints in
// double, round the sum to float once and add it to the row once per
// evaluation, in evaluation order.
__device__ __forceinline__ void fold_const_albedo(const Params& P, const Ptrs& Q, double* acc) {
  const long long nch = P.i[IP_NCHAN];
  float* da = (float*)Q.p[S_DA];
  for (int k = 0; k < 3 && k < nch; ++k) {
    da[k] = da[k] + (float)__ldcg(acc + k);
    acc[k] = 0.0;
  }
}

// Buffer mode: lane i's (index, value) pairs, the eager body's arrays.
__device__ __forceinline__ void record_buffers(const Params& P, const Ptrs& Q, int i,
                                               const Rec& R) {
  const long long nch = P.i[IP_NCHAN];
  ((long long*)Q.p[S_REC_DIDX])[i] = R.didx;
  ((float*)Q.p[S_REC_DVAL])[i] = R.dval;
  ((long long*)Q.p[S_REC_AIDX])[i] = R.aidx;
  float* adj = (float*)Q.p[S_REC_AADJ] + i * nch;
  for (long long k = 0; k < nch; ++k) adj[k] = k < 3 ? R.adj[k] : 0.0f;
}

// A constant albedo's adjoints of one evaluation summed over the block in
// double, one atomic per channel into `acc` (every thread of the block calls
// it).
template <int T>
__device__ __forceinline__ void add_block_sum(double v[3], double* acc) {
  __shared__ double part[T / 32][3];
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
    for (int w = 0; w < T / 32; ++w) sum += part[w][k];
    atomicAdd(acc + k, sum);
  }
}

// One evaluation of every lane; gated when S_CTRL is set.
__global__ void __launch_bounds__(THREADS) replay_kernel(Params P, Ptrs Q, int width) {
  long long* ctrl = (long long*)Q.p[S_CTRL];
  long long e = 0;
  if (ctrl != nullptr) {
    if (stage_stopped(ctrl, P.i[IP_CHAIN], P.i[IP_THRESH])) return;
    e = ctrl[C_EVAL];
  }
  const int mode = (int)P.i[IP_RECORD];
  const bool const_alb = mode == REC_ATOMIC && P.i[IP_CONST_ALB];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool alive = false;
  double alb[3] = {0.0, 0.0, 0.0};
  if (i < width) {
    Lane L;
    load_lane(Q, i, L);
    float g[3];
    const float s = load_weights(P, Q, i, g);
    Rec R;
    evaluate(P, Q, L, s, g, R);
    store_lane(Q, i, L);
    alive = L.alive;
    if (mode == REC_ATOMIC) record_atomic(P, Q, R);
    if (mode == REC_BUFFERS) record_buffers(P, Q, i, R);
    if (const_alb && R.scat) {
      for (int k = 0; k < 3; ++k) alb[k] = (double)R.adj[k];
    }
  }
  // the scratch: the alive count and the block ticket (uint64), then a
  // constant albedo's sums of this evaluation (double)
  unsigned long long* scratch = (unsigned long long*)Q.p[S_SCRATCH];
  double* alb_acc = (double*)(scratch + 2);
  if (const_alb) add_block_sum<THREADS>(alb, alb_acc);
  // the alive count: per block, then across blocks; the last block writes it
  // (S_COUNT is &ctrl[C_COUNT] when gated) and clears the scratch
  const int n_alive = __syncthreads_count(alive);
  if (threadIdx.x != 0) return;
  atomicAdd(scratch + 0, (unsigned long long)n_alive);
  if (!last_block(scratch + 1)) return;  // the last block: every count and sum is in
  *(long long*)Q.p[S_COUNT] = (long long)atomicAdd(scratch + 0, 0ull);
  scratch[0] = scratch[1] = 0ull;
  if (const_alb) fold_const_albedo(P, Q, alb_acc);
  if (ctrl != nullptr) ctrl[C_EVAL] = e + 1;
}

// The last stage's lanes each run to their end (or to the cap), in registers.
__global__ void __launch_bounds__(DRAIN_THREADS) drain_kernel(Params P, Ptrs Q, int width) {
  unsigned long long* ctrl = (unsigned long long*)Q.p[S_CTRL];
  const long long cap = P.i[IP_DRAIN_CAP];
  const long long e0 = (long long)ctrl[C_EVAL];
  const int mode = (int)P.i[IP_RECORD];
  const bool const_alb = mode == REC_ATOMIC && P.i[IP_CONST_ALB];
  double* alb_evals = (double*)Q.p[S_ALB_EVALS];  // [cap][3]
  const int i = blockIdx.x * DRAIN_THREADS + threadIdx.x;
  int j = 0;  // this lane's evaluations in this launch
  bool left = false, finished = false;
  if (i < width) {
    Lane L;
    load_lane(Q, i, L);
    float g[3];
    const float s = load_weights(P, Q, i, g);
    if (L.alive) {
      do {
        Rec R;
        evaluate(P, Q, L, s, g, R);
        if (mode == REC_ATOMIC) record_atomic(P, Q, R);
        if (const_alb && R.scat) {
          for (int k = 0; k < 3; ++k) atomicAdd(alb_evals + 3 * j + k, (double)R.adj[k]);
        }
        ++j;
      } while (j < cap && L.alive);
      store_lane(Q, i, L);
      left = L.alive;
      finished = !left;
    } else if (mode == REC_ATOMIC && e0 == 0 && ctrl[C_COUNT] > 0 && isnan(s * 0.0f)) {
      // a lane dead at the stage's start adds the eager body's s * 0 to row 0
      // in each of the loop's evaluations: only a NaN changes the row
      atomicAdd((float*)Q.p[S_DD], s * 0.0f);
    }
  }
  DrainEnd end;
  if (!drain_end(ctrl, e0, P.i[IP_CHAIN], j, left, finished, end)) return;
  // the last block: every lane is in
  if (const_alb) {
    // each evaluation's sum, in evaluation order (those past the longest
    // lane's are 0 and add nothing)
    for (long long e = 0; e < end.jmax; ++e) fold_const_albedo(P, Q, alb_evals + 3 * e);
  }
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

// Plain C entry points, loaded with ctypes (ops/replaybody.py).  fparams
// (N_FP,) float32, iparams (N_IP,) int64 and ptrs (N_S,) device addresses,
// all in host memory and copied into the launch; width lanes.  Each returns
// cudaGetLastError(), or -1 when a size does not match this build's.

// replay_kernel: the scratch (2 uint64 and 3 double) must be zero before the
// first launch and is zero after each; with ptrs[S_CTRL] set, a gated evaluation of a stage
// (IP_THRESH, IP_CHAIN) whose control words the host set at its start.
extern "C" int replaybody_launch(const float* fparams, int n_fp, const long long* iparams,
                                 int n_ip, void* const* ptrs, int n_s, int width,
                                 void* stream) {
  if (n_fp != N_FP || n_ip != N_IP || n_s != N_S) return -1;
  if (width > 0) {
    const int blocks = (width + THREADS - 1) / THREADS;
    replay_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        params_of(fparams, iparams), ptrs_of(ptrs), width);
  }
  return (int)cudaGetLastError();
}

// drain_kernel in blocks of DRAIN_THREADS: the control words zero at the
// stage's start but for C_COUNT, the stage's alive count; in atomic mode with a
// constant albedo, the per-evaluation sums (3 * IP_DRAIN_CAP double) zero
// before each launch (each launch leaves them zero).
extern "C" int replaybody_drain(const float* fparams, int n_fp, const long long* iparams,
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
// wrapper's check.
extern "C" void replaybody_layout(int* sizes) {
  sizes[0] = N_FP;
  sizes[1] = N_IP;
  sizes[2] = N_S;
  sizes[3] = N_CTRL;
}
