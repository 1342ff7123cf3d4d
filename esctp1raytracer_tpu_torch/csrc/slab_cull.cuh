// The slab test of kernels/cull.py:block_cull_mask, shared by the kernels
// that cull in registers: the tile kernels (rt_tile.cu, K5/K6) and the
// mxtile kernels (rt_mxu.cu, K1/K2).
//
// Bit for bit: the caller passes inv = 1/d (IEEE: inf on a zero component),
// t0 = (lo - o) * inv, t1 = (hi - o) * inv, NaN-propagating min and max (0 *
// inf on a slab plane gives NaN, and a NaN keeps the box), reject on
// tn > tf, tf < 0 and tn > t_limit (+inf where the caller has no limit:
// that rejects nothing). An inverted box (min 1e30, max -1e30: padding
// only) is kept by every ray, as in block_cull_mask.

#pragma once

#include "lane_plane.cuh"

namespace {

// min and max that return NaN when either operand is NaN, as torch.minimum,
// torch.amax and jnp.minimum do (fminf and fmaxf return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// block_cull_mask's slab test: does the ray (o, inv = 1/d) keep box [lo, hi]?
__device__ __forceinline__ bool slab_keep(Vec o, Vec inv, float tl, Vec lo, Vec hi) {
  const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
  return !(tn > tf || tf < 0.0f || tn > tl);
}

}  // namespace
