// The per-(ray, triangle) test shared by the ray-lane kernel (lane.cu, K4),
// the fused whole-frame kernel (fused.cu, K3), the tile kernels
// (rt_tile.cu, K5/K6) and the mxtile any-hit kernel's oversized triangles
// (rt_mxu.cu, K2), as their plain PyTorch versions share
// kernels/lane_pallas.py:plane_pair.
//
// Per pair, against a triangle's 13 plane/barycentric constants c:
//   det = -(d . n);  t = (o . n - n.v0) / det;  p = o + t d;
//   u = w_u . p + b_u;  v = w_v . p + b_v;
//   accept iff |det| >= eps, min(u, v) >= eps, u + v <= 1, t >= eps.
// IEEE division; every source that includes it builds with -fmad=false, so
// every product and sum rounds on its own, in the plain version's order.
//
// K3 and K4 read the constants as 12-float rows (plane_t_skip, plane_t4),
// add the exact division skip (plane_t_skip) and build the constants in
// their kernels (tri_constants), rounded as PyTorch on the CPU rounds
// lane_pallas.lane_tri_constants, so that the tables equal the JAX
// package's.

#pragma once

#include <stdint.h>

namespace {

constexpr int kTcsW = 13;      // constants per triangle
constexpr float kBig = 1e30f;  // t of a miss

struct Vec {
  float x, y, z;
};

// Is the pair accepted? Its t goes to `t` either way.
__device__ __forceinline__ bool plane_hit(const float* c, Vec o, Vec d, float eps, float& t) {
  const float det = -(d.x * c[0] + d.y * c[1] + d.z * c[2]);
  const bool ok_det = fabsf(det) >= eps;
  const float inv = 1.0f / (ok_det ? det : 1.0f);
  t = ((o.x * c[0] + o.y * c[1] + o.z * c[2]) - c[3]) * inv;
  const float px = o.x + t * d.x, py = o.y + t * d.y, pz = o.z + t * d.z;
  const float u = c[4] * px + c[5] * py + c[6] * pz + c[7];
  const float v = c[8] * px + c[9] * py + c[10] * pz + c[11];
  return ok_det && fminf(u, v) >= eps && u + v <= 1.0f && t >= eps;
}

// t of an accepted hit of ray (o, d) on the triangle with constants c, or BIG.
__device__ __forceinline__ float plane_t(const float* c, Vec o, Vec d, float eps) {
  float t;
  return plane_hit(c, o, d, eps, t) ? t : kBig;
}

// The exact division skip (lane_pallas.plane_skip): true where plane_hit
// rejects the pair whatever its division gives. Either |det| < eps, or (for
// eps > 0) the numerator num = o . n - n.v0 is zero, NaN or of the other
// sign than det, so that t = num * (1 / det) is <= 0 or NaN, never >= eps.
__device__ __forceinline__ bool plane_skip(float det, float num, float eps) {
  const bool same_sign = (num > 0.0f && det > 0.0f) || (num < 0.0f && det < 0.0f);
  return !(fabsf(det) >= eps) || (eps > 0.0f && !same_sign);
}

// plane_t with the skip, on the constants without the valid flag as three
// 16-byte rows (c0 = normal, n.v0; c1 = w_u, b_u; c2 = w_v, b_v), read from
// shared memory with three vector loads: the same accepted set and the same
// t as plane_t, bit for bit, with no division for the pairs that plane_skip
// rejects.
__device__ __forceinline__ float plane_t_skip(float4 c0, float4 c1, float4 c2, Vec o, Vec d,
                                              float eps) {
  const float det = -(d.x * c0.x + d.y * c0.y + d.z * c0.z);
  const float num = (o.x * c0.x + o.y * c0.y + o.z * c0.z) - c0.w;
  if (plane_skip(det, num, eps)) return kBig;
  const float t = num * (1.0f / det);
  const float px = o.x + t * d.x, py = o.y + t * d.y, pz = o.z + t * d.z;
  const float u = c1.x * px + c1.y * py + c1.z * pz + c1.w;
  const float v = c2.x * px + c2.y * py + c2.z * pz + c2.w;
  return (fminf(u, v) >= eps && u + v <= 1.0f && t >= eps) ? t : kBig;
}

// plane_t on the same three rows, without the skip: the same accepted set
// and t, the division for every pair (K3's any-hit sweep).
__device__ __forceinline__ float plane_t4(float4 c0, float4 c1, float4 c2, Vec o, Vec d,
                                          float eps) {
  const float det = -(d.x * c0.x + d.y * c0.y + d.z * c0.z);
  const bool ok_det = fabsf(det) >= eps;
  const float t = ((o.x * c0.x + o.y * c0.y + o.z * c0.z) - c0.w) * (1.0f / (ok_det ? det : 1.0f));
  const float px = o.x + t * d.x, py = o.y + t * d.y, pz = o.z + t * d.z;
  const float u = c1.x * px + c1.y * py + c1.z * pz + c1.w;
  const float v = c2.x * px + c2.y * py + c2.z * pz + c2.w;
  return (ok_det && fminf(u, v) >= eps && u + v <= 1.0f && t >= eps) ? t : kBig;
}

// Row i of a table of 12-float rows (plane_t_skip's three float4s).
struct Row12 {
  float4 c0, c1, c2;
};

__device__ __forceinline__ Row12 row12(const float* tab, int i) {
  const float4* r = reinterpret_cast<const float4*>(tab + 12 * i);
  return Row12{r[0], r[1], r[2]};
}

// a x b as torch.linalg.cross rounds it on the CPU: each component one
// fused multiply-add, fmaf(a_i, b_j, -(a_j * b_i)) (fmaf is explicit, so
// -fmad=false leaves it alone).
__device__ __forceinline__ Vec cross_fma(Vec a, Vec b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// A 3-term torch.sum on the CPU: ((0 + x) + y) + z, each product rounded.
// The reduction starts from +0, so a sum of three -0 is +0 (the leading
// 0 + x is kept: without fast math it is no identity for x = -0).
__device__ __forceinline__ float dot3(Vec a, Vec b) {
  return ((0.0f + a.x * b.x) + a.y * b.y) + a.z * b.z;
}

// The 13 constants of lane_pallas.lane_tri_constants for one triangle, into
// c[0..12]: normal, n.v0, w_u, b_u, w_v, b_v, valid. An invalid triangle
// gets a zero normal (det == 0 rejects every pair). The signs of zeros
// match too, so the tables compare equal bit for bit.
__device__ __forceinline__ void tri_constants(Vec v0, Vec v1, Vec v2, bool valid, float* c) {
  const Vec e1{v1.x - v0.x, v1.y - v0.y, v1.z - v0.z};
  const Vec e2{v2.x - v0.x, v2.y - v0.y, v2.z - v0.z};
  Vec n = cross_fma(e1, e2);
  if (!valid) n = Vec{0.0f, 0.0f, 0.0f};
  float nn = dot3(n, n);
  nn = nn > 0.0f ? nn : 1.0f;
  Vec wu = cross_fma(e2, n), wv = cross_fma(n, e1);
  wu = Vec{wu.x / nn, wu.y / nn, wu.z / nn};
  wv = Vec{wv.x / nn, wv.y / nn, wv.z / nn};
  c[0] = n.x;
  c[1] = n.y;
  c[2] = n.z;
  c[3] = dot3(n, v0);
  c[4] = wu.x;
  c[5] = wu.y;
  c[6] = wu.z;
  c[7] = -dot3(wu, v0);
  c[8] = wv.x;
  c[9] = wv.y;
  c[10] = wv.z;
  c[11] = -dot3(wv, v0);
  c[12] = valid ? 1.0f : 0.0f;
}

}  // namespace
