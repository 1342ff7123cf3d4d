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

#pragma once

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

}  // namespace
