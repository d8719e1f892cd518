// common.cuh — device helpers shared by the fastSK kernels (tailpk.cu,
// fastbody.cu): the PCG generator, NaN-propagating min/max, the flight draw,
// Henyey-Greenstein sampling, the turn of a direction after a scatter, and the
// box's slab test.
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

}  // namespace cvr
