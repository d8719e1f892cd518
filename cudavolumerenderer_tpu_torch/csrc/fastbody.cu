// fastbody.cu — one evaluation of fastSK's wavefront body for every lane of a
// pool, for Hopper (sm_90a).
//
// Replaces the body of cudavolumerenderer_tpu/models/fast.py:744 (render_tile's
// `body`, which XLA compiled into one device program under the cascade's
// lax.while_loop; it is no Pallas kernel).  It computes what the port's eager
// body (models/fast.py, render_tile's `body`, the plain version) computes on
// the card, bit for bit, for spec_k == 1 and defer_ggx == 0: per lane,
//   1. regenerate a finished lane: a fresh PCG stream from (seed, path id of
//      pixel, slot, samples done), a jittered camera ray (2 draws);
//   2. the AABB slab test of a lane that starts a segment: a miss adds
//      throughput * Le to the lane's accumulator and ends the sample; an
//      inside hit starts tracking; an outside hit is a boundary event now;
//   3. one tracking step: two-level (brick probe with the Chebyshev leap, a
//      flight under the brick's majorant, the crossing test, a 30-bit
//      stochastic-trilinear tap and the acceptance test) or single-level
//      (under the global majorant);
//   4. the tap's density from the flat f32 table, the 'full' rows, or the
//      packed 8/4-bit words, row-major or brick-major, and on a scatter its
//      albedo (constant, affine in density, the row's, or under 'split' the
//      scene's albedo grid at the tap);
//   5. a boundary event: GGX (both visible-normal samplers) or the null BSDF;
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
// later work.
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
  N_IP,
};

// Pointer slots (ops/fastbody.py S_*): the 15 per-lane fields the body
// updates, then the read-only ones, the outputs (the 15 fields again, the
// counts, the pending count, the scratch), the tables, and a stage's
// control words and per-evaluation counts (null for one evaluation).
enum {
  S_O = 0, S_D, S_TP, S_ACC, S_NRM, S_T, S_MAXT, S_BEXIT, S_ISL, S_SD,
  S_BOUNCE, S_ALIVE, S_TRACKING, S_RS, S_RINC,
  N_LANE,
  S_PIX = N_LANE, S_SLOT, S_NRAYS, S_NROWS, S_NBUSY,
  S_OUT, S_COUNTS = S_OUT + N_LANE, S_PENDING, S_SCRATCH,
  S_TABLE, S_ALB_ROWS, S_BTAB, S_TILE_OFF, S_BASES, S_CTRL, S_EVALS, N_S,
};

// A stage's control words (int64, ops/fastbody.py C_*): the evaluations run
// (gated: before this launch; drain: before this launch, then after it), the
// last pending count (gated), and the drain's longest finished lane, its
// accumulators (lanes left at the cap, the most evaluations a lane ran in the
// launch, the block ticket), the lanes left after the launch and the stage's
// evaluation count once no lane is left.
enum {
  C_EVAL = 0, C_PEND, C_LMAX, C_LEFT_ACC, C_JMAX, C_TICKET, C_LEFT, C_TOTAL,
  N_CTRL,
};

// Table modes (IP_TABLE), albedo modes (IP_ALBEDO).
enum { TAB_F32 = 0, TAB_ROWS = 1, TAB_PACKED = 2 };
enum { ALB_CONST = 0, ALB_AFFINE = 1, ALB_ROW = 2, ALB_SPLIT = 3 };

struct Params {
  float f[N_FP];
  long long i[N_IP];
};
struct Ptrs {
  void* p[N_S];
};

// brick-major layout (models/fast.py _BM_BRICK = (8, 8, 128), z, y, x)
constexpr int BM_SZ = 3, BM_SY = 3, BM_SX = 7;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = x ^ (x >> 16);
  x = x * 0x7FEB352Du;
  x = x ^ (x >> 15);
  x = x * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x;
}

// One masked draw: the lane's state steps, and its 32 bits.
__device__ __forceinline__ uint32_t draw_bits(uint32_t& rs, uint32_t inc) {
  rs = pcg_next(rs, inc);
  return pcg_bits(rs);
}
__device__ __forceinline__ float draw_float(uint32_t& rs, uint32_t inc) {
  rs = pcg_next(rs, inc);
  return uniform(rs);
}

// math3.dot on the card: torch's CUDA sum over a last dim of 3 splits it over
// two threads, (x0 + x2) + x1, from accumulators that start at +0 (so the sum
// is never -0).
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + x1) + 0.0f;
}
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}
// math3.normalize: a / max(sqrt(a . a), 1e-20)
__device__ __forceinline__ void normalize3(const float a[3], float out[3]) {
  const float n = jmax(sqrtf(dot3(a, a)), 1e-20f);
  for (int k = 0; k < 3; ++k) out[k] = a[k] / n;
}
__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}
// clamp(x, min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }
// torch.sign on a float
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ---- GGX rough dielectric (ops/ggx.py) --------------------------------------

// _sample_visible11: Mitsuba's slope sampling for alpha = 1.
__device__ void sample_visible11(float theta, float s1, float s2, float& sx, float& sy_out) {
  const float phi = (float)(2.0 * 3.1415926535897932384626433832795) * s2;
  const float r_special = sqrtf(clamp0(s1 / jmax(1.0f - s1, 1e-20f)));
  const float special_x = r_special * cosf(phi);
  const float special_y = r_special * sinf(phi);
  const bool is_special = theta < 1e-4f;
  const float tan_theta = tanf(theta);
  const float safe_tan = is_special ? 1.0f : tan_theta;
  const float a = 1.0f + safe_tan * safe_tan;
  const float g1 = (1.0f / (1.0f + sqrtf(a))) * 2.0f;
  float big_a = ((2.0f * s1) / g1) - 1.0f;
  if (fabsf(big_a) == 1.0f) big_a = big_a - signf(big_a) * EPS;
  const float tmp = (1.0f / (big_a * big_a - 1.0f)) * 1.0f;
  const float b = safe_tan;
  const float dd = sqrtf(clamp0((b * b * tmp * tmp) - ((big_a * big_a - b * b) * tmp)));
  const float sx1 = b * tmp - dd;
  const float sx2 = b * tmp + dd;
  const bool use_1 = big_a < 0.0f || sx2 > (1.0f / safe_tan) * 1.0f;
  float slope_x = use_1 ? sx1 : sx2;
  const float s_sign = s2 > 0.5f ? 1.0f : -1.0f;
  const float sy = s2 > 0.5f ? 2.0f * (s2 - 0.5f) : 2.0f * (0.5f - s2);
  const float z =
      (sy * (sy * (sy * (float)(-0.365728915865723) + (float)0.790235037209296) -
             (float)0.424965825137544) +
       (float)0.000152998850436920) /
      (sy * (sy * (sy * (sy * (float)0.169507819808272 - (float)0.397203533833404) -
                   (float)0.232500544458471) +
             1.0f) -
       (float)0.539825872510702);
  float slope_y = s_sign * z * sqrtf(1.0f + slope_x * slope_x);
  if (is_special) {
    slope_x = special_x;
    slope_y = special_y;
  }
  sx = slope_x;
  sy_out = slope_y;
}

__device__ void vndf_mitsuba(const float wi[3], float ax, float ay, float s1, float s2,
                             float wh[3]) {
  const float st[3] = {ax * wi[0], ay * wi[1], wi[2]};
  float ws[3];
  normalize3(st, ws);
  const float wiz = jclip(ws[2], -1.0f, 1.0f);
  const bool near_pole = wiz >= 0.999999f;
  const float theta = near_pole ? 0.0f : acosf(wiz);
  const float phi = near_pole ? 0.0f : atan2f(ws[1], ws[0]);
  const float sin_phi = sinf(phi), cos_phi = cosf(phi);
  float sx, sy;
  sample_visible11(theta, s1, s2, sx, sy);
  float rx = cos_phi * sx - sin_phi * sy;
  float ry = sin_phi * sx + cos_phi * sy;
  rx = rx * ax;
  ry = ry * ay;
  const float inv_norm = (1.0f / sqrtf(rx * rx + ry * ry + 1.0f)) * 1.0f;
  wh[0] = -rx * inv_norm;
  wh[1] = -ry * inv_norm;
  wh[2] = inv_norm;
}

__device__ void vndf_heitz(const float wi[3], float ax, float ay, float s1, float s2,
                           float wh[3]) {
  const float PI_F = (float)3.1415926535897932384626433832795;
  const float st[3] = {wi[0] * ax, wi[1] * ay, wi[2]};
  float stretched[3];
  normalize3(st, stretched);
  const float z_axis[3] = {0.0f, 0.0f, 1.0f};
  float c[3], t1[3], t2[3];
  cross3(wi, z_axis, c);
  normalize3(c, t1);
  if (!(wi[2] < 0.9999f)) {
    t1[0] = 1.0f;
    t1[1] = 0.0f;
    t1[2] = 0.0f;
  }
  cross3(t1, wi, t2);
  const float a = (1.0f / (1.0f + wi[2])) * 1.0f;
  const float r = sqrtf(s1);
  const bool lower = s2 < a;
  const float phi = lower ? s2 / jmax(a, 1e-12f) * PI_F
                          : (s2 - a) / jmax(1.0f - a, 1e-12f) * PI_F + PI_F;
  const float p1 = r * cosf(phi);
  const float p2 = r * sinf(phi) * (lower ? 1.0f : wi[2]);
  const float pz = sqrtf(clamp0(1.0f - p1 * p1 - p2 * p2));
  float n[3];
  for (int k = 0; k < 3; ++k) n[k] = p1 * t1[k] + p2 * t2[k] + pz * stretched[k];
  const float m[3] = {ax * n[0], ay * n[1], clamp0(n[2])};
  normalize3(m, wh);
}

// Smith G1 with projected roughness (ops/ggx.smith_g1, project_roughness).
__device__ float smith_g1(float ax, float ay, const float v[3], const float m[3]) {
  const float vz = v[2];
  const bool back = dot3(v, m) * vz <= 0.0f;
  const float temp = 1.0f - vz * vz;
  const bool degenerate = temp <= 0.0f;
  const float tan_v = fabsf(sqrtf(clamp0(temp)) / (vz == 0.0f ? 1.0f : vz));
  const float inv_sin2 = (1.0f / jmax(1.0f - vz * vz, 1e-20f)) * 1.0f;
  const float cos_phi2 = v[0] * v[0] * inv_sin2;
  const float sin_phi2 = v[1] * v[1] * inv_sin2;
  const float projected = sqrtf(cos_phi2 * ax * ax + sin_phi2 * ay * ay);
  const bool iso = ax == ay || (1.0f - vz * vz) <= 0.0f;
  const float proj = iso ? ax : projected;
  const float root = proj * tan_v;
  float g = (1.0f / (1.0f + sqrtf(1.0f + root * root))) * 2.0f;
  if (tan_v == 0.0f) g = 1.0f;
  if (degenerate) g = 0.0f;
  if (back) g = 0.0f;
  return g;
}

// ggx_sample: wo (local), weight, valid; draws s1, s2, then the choice.
__device__ void ggx_sample(const Params& P, const float wi[3], uint32_t& rs, uint32_t inc,
                           float wo[3], float& weight, bool& valid) {
  const float ax = P.f[FP_ROUGH], ay = P.f[FP_ROUGH + 1];
  const float eta = P.f[FP_ETA], inv_eta = P.f[FP_INV_ETA];
  const float ndotwi = wi[2];
  const float sgn = ndotwi >= 0.0f ? 1.0f : -1.0f;
  const float s1 = draw_float(rs, inc);
  const float s2 = draw_float(rs, inc);
  const float wis[3] = {sgn * wi[0], sgn * wi[1], sgn * wi[2]};
  float wh[3];
  if (P.i[IP_MITSUBA]) {
    vndf_mitsuba(wis, ax, ay, s1, s2, wh);
  } else {
    vndf_heitz(wis, ax, ay, s1, s2, wh);
  }
  const float whdotwi = dot3(wh, wi);
  // fresnel_dielectric(eta, whdotwi)
  const float scale = whdotwi > 0.0f ? inv_eta : eta;
  const float sin_sqr = 1.0f - whdotwi * whdotwi;
  const float ndotwt_sqr = 1.0f - sin_sqr * scale * scale;
  const bool tir = ndotwt_sqr <= 0.0f;
  const float abs_i = fabsf(whdotwi);
  const float abs_t = sqrtf(clamp0(ndotwt_sqr));
  const float rs_ = (abs_i - eta * abs_t) / (abs_i + eta * abs_t);
  const float rp_ = (eta * abs_i - abs_t) / (eta * abs_i + abs_t);
  float f = 0.5f * (rs_ * rs_ + rp_ * rp_);
  float whdotwt = whdotwi > 0.0f ? -abs_t : abs_t;
  if (tir) {
    f = 1.0f;
    whdotwt = 0.0f;
  }
  if (eta == 1.0f) {
    f = 0.0f;
    whdotwt = -whdotwi;
  }
  const float u_choice = draw_float(rs, inc);
  const bool choose_reflect = u_choice <= f;
  float wr[3], wt[3];
  for (int k = 0; k < 3; ++k) wr[k] = 2.0f * whdotwi * wh[k] - wi[k];
  const bool reflect_valid = ndotwi * wr[2] > 0.0f;
  const float eta_used = whdotwt < 0.0f ? inv_eta : eta;
  const float kk = whdotwi * eta_used + whdotwt;
  for (int k = 0; k < 3; ++k) wt[k] = wh[k] * kk - wi[k] * eta_used;
  const bool refract_valid = whdotwt != 0.0f && ndotwi * wt[2] < 0.0f;
  for (int k = 0; k < 3; ++k) wo[k] = choose_reflect ? wr[k] : wt[k];
  valid = (choose_reflect ? reflect_valid : refract_valid) && ndotwi != 0.0f;
  weight = valid ? smith_g1(ax, ay, wo, wh) : 0.0f;
}

// ---- tables -------------------------------------------------------------

// The flat table index of the stochastic tap at o + t d (bits: the tap draw).
__device__ __forceinline__ long long tap_flat(const Params& P, const float o[3],
                                              const float d[3], float t, uint32_t bits) {
  long long idx[3];
  const long long n[3] = {P.i[IP_NX], P.i[IP_NY], P.i[IP_NZ]};
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + t * d[a];
    const float coord =
        jclip((p - P.f[FP_BMIN + a]) / P.f[FP_EXT + a], 0.0f, 1.0f) * P.f[FP_RM1 + a];
    const float c0 = floorf(coord);
    const float frac = coord - c0;
    const float u = (float)((bits >> (10 * a)) & 0x3FFu) * (1.0f / 1024.0f);
    const long long tap = (long long)c0 + (u < frac ? 1 : 0);
    idx[a] = tap < 0 ? 0 : (tap > n[a] - 1 ? n[a] - 1 : tap);
  }
  if (!P.i[IP_BRICK_MAJOR]) return (idx[2] * n[1] + idx[1]) * n[0] + idx[0];
  return (((idx[2] >> BM_SZ) * (n[1] >> BM_SY) + (idx[1] >> BM_SY)) * (n[0] >> BM_SX) +
          (idx[0] >> BM_SX)) * (8 * 8 * 128) +
         (((idx[2] & 7) << (BM_SY + BM_SX)) + ((idx[1] & 7) << BM_SX) + (idx[0] & 127));
}

// The tap's density (the fused table's rho).
__device__ __forceinline__ float tap_rho(const Params& P, const Ptrs& Q, long long j) {
  const int mode = (int)P.i[IP_TABLE];
  if (mode == TAB_F32) return ((const float*)Q.p[S_TABLE])[j];
  if (mode == TAB_ROWS) return ((const float*)Q.p[S_TABLE])[4 * j + 3];
  const int bits = (int)P.i[IP_BITS];
  const int per = 32 / bits;
  const long long r = j >> 7, c = j & 127;
  const uint32_t word = ((const uint32_t*)Q.p[S_TABLE])[(r / per) * 128 + c];
  const uint32_t level = (word >> (uint32_t)((r % per) * bits)) & ((1u << bits) - 1u);
  return (float)level * P.f[FP_QSCALE];
}

// The scatter albedo of an accepted tap (tap_albedo / fused_row_decode).
__device__ __forceinline__ void tap_albedo(const Params& P, const Ptrs& Q, long long j,
                                           float rho, float alb[3]) {
  switch ((int)P.i[IP_ALBEDO]) {
    case ALB_CONST:
      for (int k = 0; k < 3; ++k) alb[k] = P.f[FP_ALB_B + k];
      break;
    case ALB_AFFINE:
      for (int k = 0; k < 3; ++k) alb[k] = rho * P.f[FP_ALB_A + k] + P.f[FP_ALB_B + k];
      break;
    case ALB_ROW:
      for (int k = 0; k < 3; ++k) alb[k] = ((const float*)Q.p[S_TABLE])[4 * j + k];
      break;
    default: {
      const float* row = (const float*)Q.p[S_ALB_ROWS] + j * P.i[IP_ALB_STRIDE];
      for (int k = 0; k < 3; ++k) alb[k] = row[k];
    }
  }
}

// ---- the body -------------------------------------------------------------

// One lane's state, in registers.
struct Lane {
  float o[3], d[3], tp[3], acc[3], nrm[3];
  float t, max_t, bexit, isl;
  long long sd, bounce, pix, slot;
  bool alive, tracking;
  uint32_t rs, inc;
};

__device__ __forceinline__ void load_lane(const Ptrs& Q, int i, Lane& L) {
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
}

__device__ __forceinline__ void store_lane(const Ptrs& Q, int i, const Lane& L) {
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
}

// fast.py's pending_of: a path in flight or samples left.
__device__ __forceinline__ bool pending_of(const Params& P, const Lane& L) {
  return L.alive || L.sd < P.i[IP_SPP];
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
      px = (float)(local % tw) + off[0];
      py = floorf((float)local * P.f[FP_INV_TW]) + off[1];
    } else {
      pid = s * (uint32_t)npix + (uint32_t)pix + (uint32_t)P.i[IP_BASE];
      px = (float)(pix % tw) + P.f[FP_TILEX];
      py = floorf((float)pix * P.f[FP_INV_TW]) + P.f[FP_TILEY];
    }
    rs = hash32(pid ^ (uint32_t)P.i[IP_SEEDH]);
    inc = (hash32(pid + 0x632BE5ABu) << 1) | 1u;
    // cam.generate_rays
    const float u1 = draw_float(rs, inc);
    const float u2 = draw_float(rs, inc);
    float rx = (px + u1) * 2.0f * P.f[FP_INV_RESX] - 1.0f;
    float ry = (py + u2) * 2.0f * P.f[FP_INV_RESY] - 1.0f;
    rx = rx * P.f[FP_R2VX];
    ry = ry * P.f[FP_R2VY];
    const float v[3] = {rx, ry, 1.0f};
    float dv[3];
    normalize3(v, dv);
    const float* m = P.f + FP_CAM;
    for (int k = 0; k < 3; ++k) {
      d[k] = m[4 * k] * dv[0] + m[4 * k + 1] * dv[1] + m[4 * k + 2] * dv[2];
      o[k] = m[4 * k + 3];
      tp[k] = 1.0f;
    }
    alive = true;
    tracking = false;
    bounce = 0;
  }

  // --- segment start: AABB + classification --------------------------
  const bool need_isect = alive && !tracking;
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
    bool crossed_step = false, inside = false, accepted = false;
    float t_cand = t;
    if (stepping) {
      const float u1 = draw_float(rs, inc);
      const float step = -logf(jmax(u1, EPS)) * isl;
      t_cand = t + step;
      crossed_step = t_cand >= eff_exit;
      inside = !crossed_step;
      if (inside) {
        const uint32_t bits = draw_bits(rs, inc);
        const long long flat = tap_flat(P, o, d, t_cand, bits);
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
    } else if (inside) {
      t = t_cand;
    }
    if (probe_empty) bexit = -1.0f;
    overran = overran_step || overran_empty;
    terminated = overran || accepted;
    scattered = accepted;
    tracking = tracking && !terminated;
  } else {
    // single-level Woodcock tracking under the global majorant
    if (tracking) {
      const float inv_sigmat = P.f[FP_INV_SIGMAT];
      const float u1 = draw_float(rs, inc);
      const float t_new = t + -logf(jmax(u1, EPS)) * inv_sigmat;
      const uint32_t bits = draw_bits(rs, inc);
      const long long flat = tap_flat(P, o, d, t_new, bits);
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

  // --- boundary event ------------------------------------------------------
  const bool boundary = boundary_now || (terminated && overran);
  if (boundary) {
    const float tb = boundary_now ? dist : max_t;
    float o_bound[3];
    for (int k = 0; k < 3; ++k) o_bound[k] = o[k] + d[k] * tb;
    float d_bsdf[3];
    float weight = 1.0f;
    bool valid = true;
    if (P.i[IP_BSDF]) {
      // integrator.boundary_event: the frame from the cached face normal
      float zn[3], helper[3], c[3], fy[3], fx[3], nd[3], v[3], wi[3], wo[3];
      normalize3(nrm, zn);
      const bool helper_is_y = fabsf(zn[0]) > 0.99f;
      helper[0] = helper_is_y ? 0.0f : 1.0f;
      helper[1] = helper_is_y ? 1.0f : 0.0f;
      helper[2] = 0.0f;
      cross3(zn, helper, c);
      normalize3(c, fy);
      cross3(fy, zn, fx);
      for (int k = 0; k < 3; ++k) nd[k] = -d[k];
      normalize3(nd, v);
      wi[0] = dot3(v, fx);
      wi[1] = dot3(v, fy);
      wi[2] = dot3(v, zn);
      ggx_sample(P, wi, rs, inc, wo, weight, valid);
      for (int k = 0; k < 3; ++k) d_bsdf[k] = wo[0] * fx[k] + wo[1] * fy[k] + wo[2] * zn[k];
    } else {
      for (int k = 0; k < 3; ++k) d_bsdf[k] = d[k];
    }
    for (int k = 0; k < 3; ++k) {
      o[k] = valid ? o_bound[k] + d_bsdf[k] * EPS : o_bound[k];
      if (valid) {
        d[k] = d_bsdf[k];
        tp[k] = tp[k] * weight;
      }
    }
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
  const bool had_event = alive && (scattered || boundary);
  if (had_event) bounce = bounce + 1;
  const bool capped = alive && bounce >= P.i[IP_MAXPATH];
  alive = alive && !capped;
  if (capped) sd = sd + 1;
  if (P.i[IP_RR] && had_event && !capped) {
    const float p = jmin(jmax(jmax(tp[0], tp[1]), tp[2]), 1.0f);
    const float u = draw_float(rs, inc);
    if (u > p) {
      alive = false;
      sd = sd + 1;
    } else {
      const float q = jmax(p, 1e-20f);
      for (int k = 0; k < 3; ++k) tp[k] = tp[k] / q;
    }
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
  __threadfence();
  const unsigned long long ticket = atomicAdd(scratch + 3, 1ull);
  if (ticket != gridDim.x - 1) return false;
  __threadfence();  // the last block: every count is in
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
    // the loop's exit, tested where it tests it: at a chain's start.  Every
    // block reads the same words (the last launch left them), so all return
    // or none does.
    e = ctrl[C_EVAL];
    if (e % P.i[IP_CHAIN] == 0 && ctrl[C_PEND] <= P.i[IP_THRESH]) return;
  }
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool isect = false, busy = false, pend = false;
  if (i < width) {
    Lane L;
    load_lane(Q, i, L);
    isect = evaluate(P, Q, L);
    busy = L.tracking;
    pend = pending_of(P, L);
    store_lane(Q, i, L);
  }
  // S_PENDING is &ctrl[C_PEND] when gated
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
    load_lane(Q, i, L);
    if (pending_of(P, L)) {
      do {
        const bool isect = evaluate(P, Q, L);
        warp_count(per_eval, j, isect);
        warp_count(per_eval + cap, j, L.tracking);
        ++j;
      } while (j < cap && pending_of(P, L));
      store_lane(Q, i, L);
      left = pending_of(P, L);
      finished = !left;
    }
  }
  __shared__ int s_j, s_l;
  if (threadIdx.x == 0) s_j = s_l = 0;
  __syncthreads();
  if (j > 0) atomicMax(&s_j, j);
  if (finished) atomicMax(&s_l, j);
  const int n_left = __syncthreads_count(left);
  if (threadIdx.x != 0) return;
  atomicAdd(ctrl + C_LEFT_ACC, (unsigned long long)n_left);
  atomicMax(ctrl + C_JMAX, (unsigned long long)s_j);
  if (s_l > 0) atomicMax(ctrl + C_LMAX, (unsigned long long)(e0 + s_l));
  __threadfence();
  if (atomicAdd(ctrl + C_TICKET, 1ull) != gridDim.x - 1) return;
  __threadfence();  // the last block: every lane's counts are in
  const long long lanes_left = (long long)atomicAdd(ctrl + C_LEFT_ACC, 0ull);
  const long long jmax = (long long)atomicAdd(ctrl + C_JMAX, 0ull);
  const long long lmax = (long long)atomicAdd(ctrl + C_LMAX, 0ull);
  // the evaluations of this launch that the loop makes: all of them while a
  // lane is left, else up to E (those past the cap count nothing)
  long long n_fold = cap;
  if (lanes_left == 0) {
    const long long k = P.i[IP_CHAIN];
    const long long total = (lmax + k - 1) / k * k;
    n_fold = total - e0;
    ctrl[C_TOTAL] = (unsigned long long)total;
  }
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
  for (long long e = 0; e < jmax; ++e) per_eval[e] = per_eval[cap + e] = 0u;
  ctrl[C_EVAL] = (unsigned long long)(e0 + cap);
  ctrl[C_LEFT] = (unsigned long long)lanes_left;
  ctrl[C_LEFT_ACC] = ctrl[C_JMAX] = ctrl[C_TICKET] = 0ull;
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
