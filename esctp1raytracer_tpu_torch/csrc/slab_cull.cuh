// The slab test of kernels/cull.py:block_cull_mask, and the interval test of
// its group_cull_mask, shared by the kernels that cull in registers: the tile
// kernels (rt_tile.cu, K5/K6) and the mxtile kernels (rt_mxu.cu, K1/K2).
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

// slab_keep that also gives its entry t (block_cull_mask(...,
// return_entry=True)) in tn; a copy, so that slab_keep's callers compile as
// they did before the "entry" lists existed.
__device__ __forceinline__ bool slab_entry(Vec o, Vec inv, float tl, Vec lo, Vec hi, float& tn) {
  const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
  return !(tn > tf || tf < 0.0f || tn > tl);
}

// An "entry" list's key of a ray's slab entry t: NaN (a kept box) first,
// an overflowed entry clamped, as rt_tile.py:_cull_lists keys them.
__device__ __forceinline__ float entry_key(float tn) {
  return isnan(tn) ? -__int_as_float(0x7f800000) : fminf(tn, 3.0e38f);  // NaN -> -inf
}

// kernels/cull.py:group_cull_mask's bounds of one ray group, from the
// group's component minima and maxima (NaN-propagating, as torch.amin):
// the interval reciprocal of d per axis, unbounded where d's sign changes
// (or d touches 0), and the group's largest t_limit.
struct Interval {
  float o_lo[3], o_hi[3], inv_lo[3], inv_hi[3], tl_hi;
  bool unb[3];
};

__device__ __forceinline__ Interval make_interval(const float (&o_lo)[3], const float (&o_hi)[3],
                                                  const float (&d_lo)[3], const float (&d_hi)[3],
                                                  float tl_hi) {
  Interval iv;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    iv.o_lo[a] = o_lo[a];
    iv.o_hi[a] = o_hi[a];
    iv.unb[a] = d_lo[a] <= 0.0f && d_hi[a] >= 0.0f;
    const float inv_a = 1.0f / (iv.unb[a] ? 1.0f : d_hi[a]);  // IEEE division
    const float inv_b = 1.0f / (iv.unb[a] ? 1.0f : d_lo[a]);
    iv.inv_lo[a] = nan_min(inv_a, inv_b);
    iv.inv_hi[a] = nan_max(inv_a, inv_b);
  }
  iv.tl_hi = tl_hi;
  return iv;
}

// group_cull_mask's test of box [lo, hi] for the group: per axis the min
// and max of the eight corner products in its order, -big/+big where
// unbounded; reject on tn > tf, tf < 0 and tn > the largest t_limit (a NaN
// anywhere keeps the box).
__device__ __forceinline__ bool interval_keep(const Interval& iv, Vec lo, Vec hi) {
  constexpr float kHuge = 3.4e38f;
  const float bmin[3] = {lo.x, lo.y, lo.z}, bmax[3] = {hi.x, hi.y, hi.z};
  float tn = -kHuge, tf = kHuge;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo1 = bmin[a] - iv.o_hi[a], hi1 = bmin[a] - iv.o_lo[a];
    const float lo2 = bmax[a] - iv.o_hi[a], hi2 = bmax[a] - iv.o_lo[a];
    const float il = iv.inv_lo[a], ih = iv.inv_hi[a];
    const float p[8] = {lo1 * il, lo1 * ih, hi1 * il, hi1 * ih,
                        lo2 * il, lo2 * ih, hi2 * il, hi2 * ih};
    float near = p[0], far = p[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      near = nan_min(near, p[i]);
      far = nan_max(far, p[i]);
    }
    tn = nan_max(tn, iv.unb[a] ? -kHuge : near);
    tf = nan_min(tf, iv.unb[a] ? kHuge : far);
  }
  return !(tn > tf || tf < 0.0f || tn > iv.tl_hi);
}

}  // namespace
