// common.cuh — device helpers shared by the kernels (tailpk.cu, tracking.cu,
// fastbody.cu, replaybody.cu, familybody.cu, brickbody.cu, fastqbody.cu,
// nestedreplay.cu): the PCG generator and masked draws, the null-run
// lookahead's jumps, shuffled sums and first-stop ballot (tailpk.cu,
// familybody.cu), the path-id hash, a
// path's stream and camera ray, NaN-propagating min/max, float3 sums in the
// card's order, the flight draw, Henyey-Greenstein sampling, the turn of a
// direction after a scatter, the box's slab test and a brick's DDA exit, the
// GGX boundary event, Russian roulette, the stochastic tap and the fused
// table's density and albedo, the dense grids' trilinear and nearest samplers
// (familybody.cu, nestedreplay.cu), the two-level tracking step of the
// differentiable replays (replaybody.cu, nestedreplay.cu), the brick-binned
// tracking steps, a cascade stage's control words with the gate, the
// last-block ticket and the drain's end of a launch (fastbody.cu,
// replaybody.cu, familybody.cu, brickbody.cu, fastqbody.cu; the host side is
// ops/stages.py), and the work queue's ranks (familybody.cu, fastqbody.cu).
//
// Each follows the port's plain torch version operation by operation, so a
// kernel built with -fmad=false and without --use_fast_math (utils/
// cuda_build.NVCC_FLAGS) rounds where the eager ops round: logf, sinf, cosf,
// sqrtf and division stay IEEE-accurate and no multiply-add is contracted;
// jmin/jmax return NaN when either side is NaN, like torch.minimum/maximum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cvr {

constexpr uint32_t PCG_MULT = 747796405u;
constexpr float EPS = 1e-5f;                    // constants.EPSILON
constexpr float TWO_PI_F = 6.283185307179586f;  // constants.TWO_PI

__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ int iclip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// PCG-RXS-M-XS-32 (ops/rng.py): the state after one more draw, and the 32
// bits a draw that lands on state s returns.
__device__ __forceinline__ uint32_t pcg_next(uint32_t s, uint32_t inc) {
  return s * PCG_MULT + inc;
}
__device__ __forceinline__ uint32_t pcg_bits(uint32_t s) {
  const uint32_t word = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ float uniform(uint32_t s) {
  return (float)(pcg_bits(s) >> 8) * (1.0f / 16777216.0f);
}

// Flight length of a draw: -log(max(u1, eps)) * inv_sig.
__device__ __forceinline__ float flight(uint32_t s, float inv_sig) {
  return -logf(jmax(uniform(s), EPS)) * inv_sig;
}

// HG sampling (ops/phase.importance_sample_hg): cos and sin of the angle.
__device__ __forceinline__ void hg(float g, float e1, float& cos_th, float& sin_th) {
  const float sqr = (1.0f - g * g) / jmax(1.0f - g + 2.0f * g * e1, 1e-12f);
  const float g_safe = fabsf(g) > 1e-12f ? g : 1.0f;
  const float cos_a = (1.0f + g * g - sqr * sqr) / (2.0f * g_safe);
  const float cos_i = 1.0f - 2.0f * e1;
  cos_th = jclip(fabsf(g) > EPS ? cos_a : cos_i, -1.0f, 1.0f);
  sin_th = sqrtf(jmax(0.0f, 1.0f - cos_th * cos_th));
}

// The direction after a scatter from d, with hx = sin_th cos(phi),
// hy = sin_th sin(phi) (ops/math3.local_basis, then the rotation).
__device__ __forceinline__ void turn(const float d[3], float hx, float hy,
                                     float cos_th, float nd[3]) {
  const float inv_n1 = 1.0f / sqrtf(jmax(d[0] * d[0] + d[2] * d[2], 1e-12f));
  const float v1x = d[2] * inv_n1, v1y = 0.0f, v1z = -d[0] * inv_n1;
  const float v2x = d[1] * v1z - d[2] * v1y;
  const float v2y = d[2] * v1x - d[0] * v1z;
  const float v2z = d[0] * v1y - d[1] * v1x;
  nd[0] = hx * v1x + hy * v2x + cos_th * d[0];
  nd[1] = hx * v1y + hy * v2y + cos_th * d[1];
  nd[2] = hx * v1z + hy * v2z + cos_th * d[2];
}

// The slab test of ops/aabb.aabb_intersect on the box [lo, hi]: dist (the
// largest entering t if > eps, else the exit t), the face normal picked in
// the order +x,+y,+z,-x,-y,-z among the planes at t == dist, and the
// largest entering and smallest exit t (for hit and inside).
struct BoxHit {
  float dist, largest_tmin, smallest_tmax;
  float nrm[3];
};

__device__ __forceinline__ BoxHit box_hit(const float lo[3], const float hi[3],
                                          const float o[3], const float d[3]) {
  float ttop[3], tbot[3];
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / d[a];
    tbot[a] = (lo[a] - o[a]) * inv;
    ttop[a] = (hi[a] - o[a]) * inv;
  }
  BoxHit h;
  h.largest_tmin = jmax(
      jmax(jmin(ttop[0], tbot[0]), jmin(ttop[1], tbot[1])), jmin(ttop[2], tbot[2]));
  h.smallest_tmax = jmin(
      jmin(jmax(ttop[0], tbot[0]), jmax(ttop[1], tbot[1])), jmax(ttop[2], tbot[2]));
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

// The DDA exit of a brick: the nearest of the planes `bound` along d (axes
// with |d| <= 1e-12 never exit), floored at t_floor (fast.py's fresh
// brick-exit computation).
__device__ __forceinline__ float dda_exit(const float bound[3], const float o[3],
                                          const float d[3], float t_floor) {
  float exit_t = INFINITY;
  for (int a = 0; a < 3; ++a) {
    const float t_axis = fabsf(d[a]) > 1e-12f ? (bound[a] - o[a]) / d[a] : INFINITY;
    exit_t = jmin(exit_t, t_axis);
  }
  return jmax(exit_t, t_floor);
}

// ---- hashing, draws and small vectors --------------------------------------

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

// ---- null-run lookahead (tailpk.cu's null runs, familybody.cu's chains) -----
//
// Between events a path's steps change only t, and each step takes W draws,
// so the draws of its next steps are known before their densities are.  A
// group of G threads (G a power of two up to 32, aligned in its warp) takes
// up to G of them in one round: member j jumps to the step's first draw,
// W j + 1, forms t_j as the serial loop's left-to-right sum over the steps
// shared by shuffles (run_sum), and tests its step; a ballot finds the
// first member whose step stops the run (first_stop).  Adding -0.0 leaves a
// float unchanged (NaN stays NaN), so member j adds it for the steps after
// its own; a tree scan would round differently.

// The PCG state after m draws: A_m * state + G_m * inc, from
// ops/rng.jump_constants's (2, n1) table.
struct Jump {
  uint32_t a, g;
};
__device__ __forceinline__ Jump jump_of(const int64_t* table, int n1, int m) {
  return Jump{(uint32_t)table[m], (uint32_t)table[n1 + m]};
}
__device__ __forceinline__ uint32_t jumped(const Jump& J, uint32_t rs, uint32_t inc) {
  return J.a * rs + J.g * inc;
}
// Member j's first draw in a null run of W draws a step.
template <int W>
__device__ __forceinline__ Jump null_jump(const int64_t* table, int n1, int j) {
  return jump_of(table, n1, W * j + 1);
}

// The threads of this thread's group of G in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "a power of two up to 32");
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// Member src's v (every member of the group calls it).
template <int G, typename T>
__device__ __forceinline__ T group_shfl(unsigned mask, T v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(mask, v, src, G);
  }
}

// t + step_0 + ... + step_j, left to right over the run's first D steps
// (step: this member's own), as the serial loop adds them.
template <int G>
__device__ __forceinline__ float run_sum(unsigned mask, float t, float step, int j, int D) {
  float tj = t;
  for (int i = 0; i < D; ++i) {
    const float si = group_shfl<G>(mask, step, i);
    tj = tj + (i <= j ? si : -0.0f);
  }
  return tj;
}

// The group's members whose p holds, as bits from member 0 up.
template <int G>
__device__ __forceinline__ unsigned group_ballot(unsigned mask, bool p) {
  if constexpr (G == 1) {
    return p ? 1u : 0u;
  } else {
    unsigned b = __ballot_sync(mask, p) & mask;
    if constexpr (G < 32) b >>= (threadIdx.x & 31) & ~(G - 1);
    return b;
  }
}

// The first of the group's first D members whose step stops the run, or -1.
template <int G>
__device__ __forceinline__ int first_stop(unsigned mask, int j, int D, bool stop) {
  const unsigned b = group_ballot<G>(mask, j < D && stop);
  return b ? __ffs(b) - 1 : -1;
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

// The BSDF's parameters: roughness (ax, ay), eta and its float32 reciprocal,
// and the visible-normal sampler (Mitsuba's or Heitz's).
struct Ggx {
  float ax, ay, eta, inv_eta;
  bool mitsuba;
};

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
__device__ void ggx_sample(const Ggx& G, const float wi[3], uint32_t& rs, uint32_t inc,
                           float wo[3], float& weight, bool& valid) {
  const float ax = G.ax, ay = G.ay;
  const float eta = G.eta, inv_eta = G.inv_eta;
  const float ndotwi = wi[2];
  const float sgn = ndotwi >= 0.0f ? 1.0f : -1.0f;
  const float s1 = draw_float(rs, inc);
  const float s2 = draw_float(rs, inc);
  const float wis[3] = {sgn * wi[0], sgn * wi[1], sgn * wi[2]};
  float wh[3];
  if (G.mitsuba) {
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

// integrator.boundary_event at o + d * tb with the cached face normal nrm: the
// GGX sample in the normal's frame (ggx) or the null BSDF's pass-through.  A
// valid sample moves o off the surface along the new direction and weights
// tp; an invalid one leaves d and tp and puts o on the surface.
__device__ __forceinline__ void boundary_event(bool ggx, const Ggx& G, const float nrm[3],
                                               float tb, float o[3], float d[3], float tp[3],
                                               uint32_t& rs, uint32_t inc) {
  float o_bound[3];
  for (int k = 0; k < 3; ++k) o_bound[k] = o[k] + d[k] * tb;
  float d_bsdf[3];
  float weight = 1.0f;
  bool valid = true;
  if (ggx) {
    // the frame from the cached face normal
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
    ggx_sample(G, wi, rs, inc, wo, weight, valid);
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

// ---- the stochastic tap (models/fast.py _stochastic_tap) --------------------

// brick-major layout (models/fast.py _BM_BRICK = (8, 8, 128), z, y, x)
constexpr int BM_SZ = 3, BM_SY = 3, BM_SX = 7;

// The flat table index of the stochastic tap at the world point p (bits: the
// tap draw) in a grid of n = (nx, ny, nz) voxels over the box at bmin with
// extent ext (rm1 = n - 1 as floats), row-major or brick-major.
__device__ __forceinline__ long long tap_flat_at(const float bmin[3], const float ext[3],
                                                 const float rm1[3], const long long n[3],
                                                 bool brick_major, const float p[3],
                                                 uint32_t bits) {
  long long idx[3];
  for (int a = 0; a < 3; ++a) {
    const float coord = jclip((p[a] - bmin[a]) / ext[a], 0.0f, 1.0f) * rm1[a];
    const float c0 = floorf(coord);
    const float frac = coord - c0;
    const float u = (float)((bits >> (10 * a)) & 0x3FFu) * (1.0f / 1024.0f);
    const long long tap = (long long)c0 + (u < frac ? 1 : 0);
    idx[a] = tap < 0 ? 0 : (tap > n[a] - 1 ? n[a] - 1 : tap);
  }
  if (!brick_major) return (idx[2] * n[1] + idx[1]) * n[0] + idx[0];
  return (((idx[2] >> BM_SZ) * (n[1] >> BM_SY) + (idx[1] >> BM_SY)) * (n[0] >> BM_SX) +
          (idx[0] >> BM_SX)) * (8 * 8 * 128) +
         (((idx[2] & 7) << (BM_SY + BM_SX)) + ((idx[1] & 7) << BM_SX) + (idx[0] & 127));
}

// The same tap at o + t d.
__device__ __forceinline__ long long tap_flat(const float bmin[3], const float ext[3],
                                              const float rm1[3], const long long n[3],
                                              bool brick_major, const float o[3],
                                              const float d[3], float t, uint32_t bits) {
  float p[3];
  for (int a = 0; a < 3; ++a) p[a] = o[a] + t * d[a];
  return tap_flat_at(bmin, ext, rm1, n, brick_major, p, bits);
}

// ---- the fused table (models/fast.py make_fused_grid, fused_row_decode) ----

// Its layouts (fastbody.cu's TAB_*): the flat f32 density, the 'full' rows
// (albedo rgb, density), the packed 8/4-bit density words.
constexpr int FUSED_F32 = 0, FUSED_ROWS = 1, FUSED_PACKED = 2;
// The scatter albedo (fastbody.cu's ALB_*): constant b, affine rho * a + b,
// the row's, the scene's albedo grid at the tap ('split').
constexpr int ALBEDO_CONST = 0, ALBEDO_AFFINE = 1, ALBEDO_ROW = 2, ALBEDO_SPLIT = 3;

// The density at flat index j: the table's float, the row's 4th, or the
// packed level (per = 32 / bits levels a word, strided by 128 rows) times
// qscale (fast.packed_take).
__device__ __forceinline__ float fused_rho(const void* table, int layout, int bits,
                                           float qscale, long long j) {
  if (layout == FUSED_F32) return ((const float*)table)[j];
  if (layout == FUSED_ROWS) return ((const float*)table)[4 * j + 3];
  const int per = 32 / bits;
  const long long r = j >> 7, c = j & 127;
  const uint32_t word = ((const uint32_t*)table)[(r / per) * 128 + c];
  const uint32_t level = (word >> (uint32_t)((r % per) * bits)) & ((1u << bits) - 1u);
  return (float)level * qscale;
}

// The scatter albedo of an accepted tap at flat index j with density rho.
__device__ __forceinline__ void fused_albedo(int mode, const float a[3], const float b[3],
                                             const void* table, const float* alb_rows,
                                             long long stride, long long j, float rho,
                                             float alb[3]) {
  switch (mode) {
    case ALBEDO_CONST:
      for (int k = 0; k < 3; ++k) alb[k] = b[k];
      break;
    case ALBEDO_AFFINE:
      for (int k = 0; k < 3; ++k) alb[k] = rho * a[k] + b[k];
      break;
    case ALBEDO_ROW:
      for (int k = 0; k < 3; ++k) alb[k] = ((const float*)table)[4 * j + k];
      break;
    default: {
      const float* row = alb_rows + j * stride;
      for (int k = 0; k < 3; ++k) alb[k] = row[k];
    }
  }
}

// ---- the dense grids (ops/grid.py) -------------------------------------------

// ops/grid.py _COORD_LIMIT: coordinates clamp here before the int64 cast
constexpr float COORD_LIMIT = 4611686018427387904.0f;  // 2^62

// _to_index: truncation toward zero of a coordinate clamped to +-2^62.
__device__ __forceinline__ long long to_index(float c) {
  return (long long)jclip(c, -COORD_LIMIT, COORD_LIMIT);
}
__device__ __forceinline__ long long clampll(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// sample(grid, p01): the first `nout` channels of a (nz, ny, nx, nch) grid at
// the box coordinates p01, scaled by rm1 = n - 1 (volume_to_grid); 8 clamped
// taps lerped as sample_trilinear does, or sample_nearest's point.
__device__ __forceinline__ void sample_grid(const float* g, long long nx, long long ny,
                                            long long nz, int nch, int nout,
                                            const float rm1[3], const float p01[3],
                                            bool nearest, float* out) {
  float coord[3];
  for (int a = 0; a < 3; ++a) coord[a] = p01[a] * rm1[a];
  if (nearest) {
    const long long ix = clampll(to_index(coord[0]), nx - 1);
    const long long iy = clampll(to_index(coord[1]), ny - 1);
    const long long iz = clampll(to_index(coord[2]), nz - 1);
    const float* v = g + ((iz * ny + iy) * nx + ix) * nch;
    for (int c = 0; c < nout; ++c) out[c] = v[c];
    return;
  }
  float c0[3];
  long long i0[3];
  for (int a = 0; a < 3; ++a) {
    c0[a] = floorf(coord[a]);
    i0[a] = to_index(c0[a]);
  }
  const float fx = coord[0] - c0[0], fy = coord[1] - c0[1], fz = coord[2] - c0[2];
  const long long xa = clampll(i0[0], nx - 1), xb = clampll(i0[0] + 1, nx - 1);
  const long long ya = clampll(i0[1], ny - 1), yb = clampll(i0[1] + 1, ny - 1);
  const long long za = clampll(i0[2], nz - 1), zb = clampll(i0[2] + 1, nz - 1);
  const float* r00 = g + (za * ny + ya) * nx * nch;  // (z, y) rows
  const float* r01 = g + (za * ny + yb) * nx * nch;
  const float* r10 = g + (zb * ny + ya) * nx * nch;
  const float* r11 = g + (zb * ny + yb) * nx * nch;
  const float ofx = 1.0f - fx, ofy = 1.0f - fy, ofz = 1.0f - fz;
  for (int c = 0; c < nout; ++c) {
    const float d000 = r00[xa * nch + c], d001 = r00[xb * nch + c];
    const float d010 = r01[xa * nch + c], d011 = r01[xb * nch + c];
    const float d100 = r10[xa * nch + c], d101 = r10[xb * nch + c];
    const float d110 = r11[xa * nch + c], d111 = r11[xb * nch + c];
    out[c] = ((d000 * ofx + d001 * fx) * ofy + (d010 * ofx + d011 * fx) * fy) * ofz +
             ((d100 * ofx + d101 * fx) * ofy + (d110 * ofx + d111 * fx) * fy) * fz;
  }
}

// The box coordinates of a world point: (p - box_min) / extent.
__device__ __forceinline__ void grid_box01(const float bmin[3], const float ext[3],
                                           const float p[3], float p01[3]) {
  for (int a = 0; a < 3; ++a) p01[a] = (p[a] - bmin[a]) / ext[a];
}

// The density of a (nz, ny, nx) grid (n = (nx, ny, nz), rm1 = n - 1) over the
// box at bmin with extent ext, at o + t d.
__device__ __forceinline__ float grid_density_at(const float* grid, const long long n[3],
                                                 const float rm1[3], const float bmin[3],
                                                 const float ext[3], bool nearest,
                                                 const float o[3], const float d[3],
                                                 float t) {
  float p[3], p01[3], rho;
  for (int a = 0; a < 3; ++a) p[a] = o[a] + t * d[a];
  grid_box01(bmin, ext, p, p01);
  sample_grid(grid, n[0], n[1], n[2], 1, 1, rm1, p01, nearest, &rho);
  return rho;
}

// integrator.sample_albedo at p of a (nz, ny, nx, nch) grid: rgb (a
// 1-channel grid broadcast).
__device__ __forceinline__ void grid_albedo_at(const float* grid, const long long n[3],
                                               int nch, const float rm1[3],
                                               const float bmin[3], const float ext[3],
                                               bool nearest, const float p[3],
                                               float alb[3]) {
  float p01[3];
  grid_box01(bmin, ext, p, p01);
  sample_grid(grid, n[0], n[1], n[2], nch, nch < 3 ? 1 : 3, rm1, p01, nearest, alb);
  if (nch < 3) alb[1] = alb[2] = alb[0];
}

// ---- the two-level tracking step (models/differentiable.py _track_step) ------

// The replays' two-level geometry: the box (bmin, ext), the density's rm1 =
// n - 1, the brick size in voxels, scale, the probe's epsw, the tables (the
// dilated brick majorants, their leaps, the flat density) and, as integers,
// (nx, ny, nz, nbx, nby, the last brick index along x, y, z).
struct TwoLevel {
  const float *bmin, *ext, *rm1, *bsize;
  float scale, epsw;
  const long long* geo;  // nx, ny, nz, nbx, nby, hix, hiy, hiz
  const float *major, *leap, *density;
};

// One step's outcome besides the lane's t, brick exit, inverse majorant and
// local majorant (updated in place).
struct TrackStep {
  bool inside, accepted, overran_step, overran_empty;
  long long tap;  // the stochastic tap's flat index (inside lanes)
  float rho;      // the density there
};

// One two-level tracking step of a running lane (o, d, its segment's max_t):
// the brick probe at t >= brick_exit under the dilated majorant with the
// Chebyshev leap over empty bricks, a flight under the brick's majorant, the
// crossing test against min(brick_exit, max_t), the 30-bit stochastic tap and
// the acceptance test, with the overran-step and overran-empty exits.  The
// nested and the fused replays both run it; its draws are the eager step's.
__device__ __forceinline__ void track_step_2l(const TwoLevel& G, const float o[3],
                                              const float d[3], float maxt, float& t,
                                              float& bexit, float& isl, float& rloc,
                                              uint32_t& rs, uint32_t inc, TrackStep& S) {
  S.inside = S.accepted = S.overran_step = S.overran_empty = false;
  S.tap = 0;
  S.rho = 0.0f;
  bool probe_empty = false;
  float t_leap = 0.0f;
  if (t >= bexit) {
    // the brick probe: the dilated majorant and the leap of the brick at
    // t + epsw, and the brick's exit along d
    const float tt = t + G.epsw;
    long long bi[3];
    float bound[3];
    for (int a = 0; a < 3; ++a) {
      const float p = o[a] + tt * d[a];
      const float coordn = jclip((p - G.bmin[a]) / G.ext[a], 0.0f, 1.0f) * G.rm1[a];
      long long b = (long long)floorf(coordn / G.bsize[a]);
      b = b < 0 ? 0 : b;
      bi[a] = b < G.geo[5 + a] ? b : G.geo[5 + a];
    }
    const long long bflat = (bi[2] * G.geo[4] + bi[1]) * G.geo[3] + bi[0];
    const float rho_b = G.major[bflat];
    const float leap_b = G.leap[bflat];
    for (int a = 0; a < 3; ++a) {
      const float up = d[a] > 0.0f ? 1.0f : 0.0f;
      const float bound_coord = ((float)bi[a] + up) * G.bsize[a];
      bound[a] = G.bmin[a] + G.ext[a] * bound_coord / G.rm1[a];
    }
    const float exit_new = dda_exit(bound, o, d, t + G.epsw);
    bexit = exit_new;
    isl = rho_b > 0.0f ? (1.0f / (G.scale * jmax(rho_b, 1e-30f))) * 1.0f : INFINITY;
    rloc = rho_b;
    probe_empty = rho_b <= 0.0f;
    t_leap = jmax(exit_new, t + leap_b);
    S.overran_empty = probe_empty && t_leap >= maxt;
  }
  bool crossed = false;
  float t_cand = t;
  if (!probe_empty) {
    const float u1 = draw_float(rs, inc);
    t_cand = t + -logf(jmax(u1, EPS)) * isl;
    crossed = t_cand >= jmin(bexit, maxt);
    S.inside = !crossed;
    if (S.inside) {
      const uint32_t bits = draw_bits(rs, inc);
      S.tap = tap_flat(G.bmin, G.ext, G.rm1, G.geo, false, o, d, t_cand, bits);
      S.rho = G.density[S.tap];
      const float u2 = draw_float(rs, inc);
      S.accepted = !(G.scale * S.rho * isl < u2);
    }
  }
  S.overran_step = crossed && maxt <= bexit;
  const bool transit = crossed && !S.overran_step;
  if (probe_empty) {
    t = jmin(t_leap, maxt);
  } else if (transit) {
    t = bexit;
  } else if (S.overran_step) {
    t = jmax(t, maxt);
  } else if (S.inside) {
    t = t_cand;
  }
  if (probe_empty) bexit = -1.0f;
}

// ---- a path's start (cam.generate_rays after rng.make_rng) -----------------

// The (seed, path id) PCG stream of a path: seedh = seed * 0x9E3779B9.
__device__ __forceinline__ void path_stream(uint32_t pid, uint32_t seedh, uint32_t& rs,
                                            uint32_t& inc) {
  rs = hash32(pid ^ seedh);
  inc = (hash32(pid + 0x632BE5ABu) << 1) | 1u;
}

// The pixel of tile-local pixel id pix in a tile tw wide at (tile_x, tile_y):
// x from pix % tw, y = floor(pix * float32(1 / tw)).
__device__ __forceinline__ void pixel_of(long long pix, long long tw, float inv_tw,
                                         float tile_x, float tile_y, float& px, float& py) {
  px = (float)(pix % tw) + tile_x;
  py = floorf((float)pix * inv_tw) + tile_y;
}

// The jittered camera ray through pixel (px, py) (two draws): cam the (3, 4)
// inv_view row-major, r2v the raster-to-view scale, inv_res the float32
// reciprocals of the full resolution.
__device__ __forceinline__ void camera_ray(const float cam[12], float r2vx, float r2vy,
                                           float inv_resx, float inv_resy, float px,
                                           float py, uint32_t& rs, uint32_t inc, float o[3],
                                           float d[3]) {
  const float u1 = draw_float(rs, inc);
  const float u2 = draw_float(rs, inc);
  float rx = (px + u1) * 2.0f * inv_resx - 1.0f;
  float ry = (py + u2) * 2.0f * inv_resy - 1.0f;
  rx = rx * r2vx;
  ry = ry * r2vy;
  const float v[3] = {rx, ry, 1.0f};
  float dv[3];
  normalize3(v, dv);
  for (int k = 0; k < 3; ++k) {
    d[k] = cam[4 * k] * dv[0] + cam[4 * k + 1] * dv[1] + cam[4 * k + 2] * dv[2];
    o[k] = cam[4 * k + 3];
  }
}

// Russian roulette (integrator.russian_roulette) on a lane of its mask, one
// draw: true when the lane is killed, else its throughput divided by the
// survival probability.
__device__ __forceinline__ bool roulette_kills(float tp[3], uint32_t& rs, uint32_t inc) {
  const float p = jmin(jmax(jmax(tp[0], tp[1]), tp[2]), 1.0f);
  const float u = draw_float(rs, inc);
  if (u > p) return true;
  const float q = jmax(p, 1e-20f);
  for (int k = 0; k < 3; ++k) tp[k] = tp[k] / q;
  return false;
}

// ---- brick-binned tracking (tracking.cu, brickbody.cu) -----------------------

// Lane status codes (ops/tracking.py).
constexpr int TRK_RUNNING = 0, TRK_SCATTER = 1, TRK_EXIT_BRICK = 2, TRK_EXIT_BOX = 3;
// One brick's dilated table: 5x5x9 (z, y, x) entries, zero-padded to 256.
constexpr int TRK_DZ = 5, TRK_DY = 5, TRK_DX = 9, TRK_ROW = 256;

// Tap index along one axis: floor(local), plus one with probability
// frac(local) (u = 10 random bits / 1024), clipped to the dilated table.
// The float-to-int conversion saturates and maps NaN to 0; the pre-clip
// keeps the + 1 from overflowing and changes no clipped result.
__device__ __forceinline__ int brick_tap_axis(float local, uint32_t bits10, int n) {
  const float fl = floorf(local);
  const float u = (float)bits10 * (1.0f / 1024.0f);
  const int i = iclip(__float2int_rz(fl), -1, n);
  return iclip(i + (u < local - fl ? 1 : 0), 0, n - 1);
}

// Up to n_steps Woodcock steps of a RUNNING lane inside one brick whose
// dilated table is row_tab: o, d and base (the brick's lowest voxel) in voxel
// space, t, max_t and bexit in world t, inv_sig the reciprocal brick
// majorant and inv_rho = inv_sig * scale.  Each step: a flight draw, the exit
// test (status EXIT_BOX where max_t <= bexit, else EXIT_BRICK), a 30-bit
// stochastic-trilinear tap and the acceptance test (SCATTER, with the tap's
// flat index).  A lane not RUNNING takes no step.
__device__ __forceinline__ void brick_steps(const float* row_tab, const float o[3],
                                            const float d[3], const float base[3],
                                            float max_t, float bexit, float inv_sig,
                                            float inv_rho, int n_steps, float& t,
                                            int& status, int& tap, uint32_t& state,
                                            uint32_t inc) {
  const float eff_exit = jmin(bexit, max_t);
  const int exit_code = max_t <= bexit ? TRK_EXIT_BOX : TRK_EXIT_BRICK;
  for (int k = 0; k < n_steps && status == TRK_RUNNING; ++k) {
    // flight draw and exit test
    const float u1 = draw_float(state, inc);
    const float step = -logf(jmax(u1, EPS)) * inv_sig;
    t = t + step;
    if (t >= eff_exit) {
      status = exit_code;
      break;
    }
    // stochastic-trilinear tap into the dilated table
    const uint32_t bits2 = draw_bits(state, inc);
    const int ix = brick_tap_axis(o[0] + t * d[0] - base[0], bits2 & 0x3FFu, TRK_DX);
    const int iy = brick_tap_axis(o[1] + t * d[1] - base[1], (bits2 >> 10) & 0x3FFu, TRK_DY);
    const int iz = brick_tap_axis(o[2] + t * d[2] - base[2], (bits2 >> 20) & 0x3FFu, TRK_DZ);
    const int flat = (iz * TRK_DY + iy) * TRK_DX + ix;
    const float rho = row_tab[flat];
    // acceptance
    const float u2 = draw_float(state, inc);
    if (!(rho * inv_rho < u2)) {
      status = TRK_SCATTER;
      tap = flat;
      break;
    }
  }
}

// ---- a cascade stage's control words (ops/stages.py) -----------------------

// int64 words: the evaluations run (gated: before this launch; drain: before
// this launch, then after it), the last count of pending (fastbody) or alive
// (replaybody) lanes (gated; the replay's drain reads the stage's count
// there), the drain's longest finished lane, its accumulators (lanes left at
// the cap, the most evaluations a lane ran in the launch, the block ticket),
// the lanes left after a drain launch and the stage's evaluations once no
// lane is left.
enum {
  C_EVAL = 0, C_COUNT, C_LMAX, C_LEFT_ACC, C_JMAX, C_TICKET, C_LEFT, C_TOTAL,
  N_CTRL,
};

// A gated launch: whether the stage's loop stopped before it, tested where
// the loop tests it (at a chain's start, with the count at or under the
// threshold).  Every block reads the same words (the last launch left them),
// so all return or none does.
__device__ __forceinline__ bool stage_stopped(const long long* ctrl, long long chain,
                                              long long thresh) {
  return ctrl[C_EVAL] % chain == 0 && ctrl[C_COUNT] <= thresh;
}

// Thread 0 of a block whose sums are in: whether the block is the grid's last
// to take a ticket, and so sees every block's sums.
__device__ __forceinline__ bool last_block(unsigned long long* ticket) {
  __threadfence();
  if (atomicAdd(ticket, 1ull) != gridDim.x - 1) return false;
  __threadfence();
  return true;
}

// The drain's sums of one launch, as the last block reads them.
struct DrainEnd {
  long long left;   // lanes left at the cap
  long long jmax;   // the most evaluations a lane ran in the launch
  long long total;  // E = chain * ceil(L / chain) once no lane is left, else -1
};

// The end of a drain launch, called by every thread: j, its lane's
// evaluations in this launch (from evaluation e0 of the stage), `left` and
// `finished` whether the lane is still pending or ended in the launch.  True
// for thread 0 of the last block, with the launch's sums in `end` and, once
// no lane is left, C_TOTAL written.
__device__ __forceinline__ bool drain_end(unsigned long long* ctrl, long long e0,
                                          long long chain, int j, bool left,
                                          bool finished, DrainEnd& end) {
  __shared__ int s_j, s_l;
  if (threadIdx.x == 0) s_j = s_l = 0;
  __syncthreads();
  if (j > 0) atomicMax(&s_j, j);
  if (finished) atomicMax(&s_l, j);
  const int n_left = __syncthreads_count(left);
  if (threadIdx.x != 0) return false;
  atomicAdd(ctrl + C_LEFT_ACC, (unsigned long long)n_left);
  atomicMax(ctrl + C_JMAX, (unsigned long long)s_j);
  if (s_l > 0) atomicMax(ctrl + C_LMAX, (unsigned long long)(e0 + s_l));
  if (!last_block(ctrl + C_TICKET)) return false;
  end.left = (long long)atomicAdd(ctrl + C_LEFT_ACC, 0ull);
  end.jmax = (long long)atomicAdd(ctrl + C_JMAX, 0ull);
  end.total = -1;
  if (end.left == 0) {
    const long long lmax = (long long)atomicAdd(ctrl + C_LMAX, 0ull);
    end.total = (lmax + chain - 1) / chain * chain;
    ctrl[C_TOTAL] = (unsigned long long)end.total;
  }
  return true;
}

// The last block's close of a drain launch of at most `cap` evaluations per
// lane: the words the host reads, and the accumulators zero again.
__device__ __forceinline__ void drain_close(unsigned long long* ctrl, long long e0,
                                            long long cap, long long left) {
  ctrl[C_EVAL] = (unsigned long long)(e0 + cap);
  ctrl[C_LEFT] = (unsigned long long)left;
  ctrl[C_LEFT_ACC] = ctrl[C_JMAX] = ctrl[C_TICKET] = 0ull;
}

// ---- the work queue's ranks (familybody.cu's refill, fastqbody.cu) ----------

// The block's place in the grid's order of start (an atomic ticket): the
// order of the look-back below, so a block only waits on blocks that run.
__device__ __forceinline__ int start_ticket(unsigned long long* counter) {
  __shared__ int s_block;
  if (threadIdx.x == 0) s_block = (int)atomicAdd(counter, 1ull);
  __syncthreads();
  return s_block;
}

// Decoupled look-back over the blocks' totals (status words: 0, or a total
// with bit 62 (the block's own) or bit 63 (its inclusive prefix)): the
// exclusive prefix of block b, whose own total is agg.
__device__ __forceinline__ long long look_back(unsigned long long* status, int b,
                                               long long agg) {
  constexpr unsigned long long OWN = 1ull << 62, INCL = 1ull << 63, VAL = OWN - 1ull;
  if (b == 0) {
    atomicExch(status, INCL | (unsigned long long)agg);
    return 0;
  }
  atomicExch(status + b, OWN | (unsigned long long)agg);
  long long excl = 0;
  int k = b - 1;
  while (true) {
    const unsigned long long v = *(volatile unsigned long long*)(status + k);
    if (v == 0ull) continue;  // block k has not published yet
    excl += (long long)(v & VAL);
    if (v & INCL) break;
    --k;
  }
  atomicExch(status + b, INCL | (unsigned long long)(excl + agg));
  return excl;
}

// The deterministic queue's rank of this thread's `want` (the k-th wanting
// lane of the grid in lane order takes queue entry k): a warp ballot, a scan
// of the block's T / 32 warps, and the look-back over the blocks before
// block b (its start ticket; lane i = b * T + threadIdx.x).  Every thread of
// the block calls it; the last block clears the status words after the
// launch (one per block).
template <int T>
__device__ __forceinline__ long long queue_rank(bool want, int b, unsigned long long* status) {
  static_assert(T % 32 == 0 && T <= 1024, "a block of whole warps");
  __shared__ int s_warp[T / 32];
  __shared__ long long s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned wb = __ballot_sync(0xffffffffu, want);
  const int in_warp = __popc(wb & ((1u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(wb);
  __syncthreads();
  if (warp == 0) {
    int v = lane < T / 32 ? s_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < T / 32) s_warp[lane] = v;  // inclusive
  }
  __syncthreads();
  if (threadIdx.x == 0) s_prefix = look_back(status, b, s_warp[T / 32 - 1]);
  __syncthreads();
  return s_prefix + (warp == 0 ? 0 : s_warp[warp - 1]) + in_warp;
}

}  // namespace cvr
