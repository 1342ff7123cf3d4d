// Tile search kernels for Hopper (sm_90a): K5, closest hit, and K6, any hit.
//
// Replace the TPU Pallas kernels esctp1raytracer_tpu/kernels/rt_tile.py:
// _tile_kernel and _occl_tile_kernel, together with the cull pre-pass that
// feeds them there (_prep: a slab test of every ray against every
// sub-block box, compacted into per-bundle lists in device memory). The TPU
// kernel puts a bundle's 8 rays on the 8 sublanes and a 128-triangle
// sub-block on the 128 lanes of one vector op, and walks the bundle's list.
// Here one warp is one bundle, and it builds its list itself:
//
// 1. Cull. Every lane holds the 8 rays in registers. The test is
//    kernels/cull.py:block_cull_mask bit for bit (slab_cull.cuh): IEEE 1/d,
//    t0 = (lo - o) * inv, t1 = (hi - o) * inv, NaN-propagating min and max
//    (0 * inf on a slab plane gives NaN, and a NaN keeps the box), reject
//    on tn > tf, tf < 0 and tn > t_limit (+inf where the caller has no
//    limit: that rejects nothing). It runs on two levels: lane g first
//    tests the union box of boxes 32g..32g+31 (the wrapper's
//    [8, NSUB / 32] `gboxes`), then the warp tests box by box (lane l: box
//    32g + l, coalesced row reads) only the groups that some ray keeps
//    (see cull() for why that is exact). A box is kept if any of the 8
//    rays keeps it; one __ballot_sync per group gives a word of kept boxes,
//    and lane g keeps group g's word (NSUB <= 1024 = 32 x 32), so no list
//    reaches device memory. The kept count per bundle can be written out
//    (cnt_out) to hold it against the plain version's.
// 2. Skip. A box that is inverted (min > max on an axis) holds only
//    padding: every triangle there has a zero normal, det == 0 rejects it,
//    so the warp does not sweep it, and a group of such boxes only is not
//    tested at all. The output is unchanged.
// 3. Sweep. The warp walks the set bits in ascending order (__ffs) and
//    sweeps each sub-block as the TPU kernel does: lane l owns triangles
//    l, l + 32, l + 64, l + 96, loads their 12 plane constants with
//    coalesced 128-byte reads, and tests each against the 8 rays.
//
// Tie rule (K5). A lane visits its pairs in ascending sorted index (the bits
// ascend, and j * 32 + lane ascends in j), so a strict < keeps the lowest
// index at the lane's minimum t. The warp then folds the 32 lanes per ray:
// the smaller t, and on equal t the smaller index. The result is the
// minimum t over the kept sub-blocks, ties to the lowest sorted index: the
// TPU kernel's result. K5 culls by t_limit but never clamps t to it. K6 ORs
// the accepted pairs with t < t_limit per ray, folds with __reduce_or_sync,
// and stops once every ray of the bundle is occluded or cannot be
// (t_limit <= eps): an OR cannot change after that; a bundle that no ray
// can be occluded in skips the cull too. K6 also tests one extra sub-block
// (`ov`, the oversized triangles that the segment tables exclude) for every
// ray, without a cull, when the caller passes one.
//
// What bounds it on the H100: arithmetic. Per bundle, the slab tests of the
// two cull levels at ~25 float32 operations each, plus ~40 operations (one
// an IEEE division) per (ray, triangle) pair of the sub-blocks it sweeps
// (K6: up to its early exit); the tables (6.4 MB at 100k triangles) stay
// in the 50 MB L2, and the rays are read once. On config 5's camera
// wavefront that is ~4.2 ms at the 67 TFLOP/s float32 peak. That peak
// counts an FMA as two operations; built with -fmad=false (below), every
// product and sum issues on its own, one operation per lane per cycle, so
// this code can reach at most half of it. The design keeps the cull in
// registers and ballots and cuts its tests to the groups a bundle can
// reach, reads each constant once per warp for 8 rays, and skips padding
// and settled bundles. Staging each sub-block in shared memory once per
// block, capped registers and other block sizes were tried and gave no
// gain: the kernels are bound by issuing that arithmetic, not by memory.
//
// The per-pair test is plane_hit of lane_plane.cuh, which K3 and K4 share:
// IEEE division (no fast math) and -fmad=false, so every product and sum
// rounds on its own, in the plain PyTorch version's order.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false. C interface, loaded with ctypes;
// each entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lane_plane.cuh"
#include "slab_cull.cuh"

namespace {

constexpr int kBundle = 8;   // rays per bundle (one warp)
constexpr int kSub = 128;    // triangles per sub-block
constexpr int kRows = 16;    // constant rows per sub-block (12 read)
constexpr int kRayW = 8;     // floats per ray: o, d, t_limit, pad
constexpr int kWarps = 8;    // bundles per block
constexpr int kPerLane = kSub / 32;
constexpr int kMaxSub = 32 * 32;  // boxes a warp's 32 ballot words cover
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAllRays = (1u << kBundle) - 1;

struct BundleRays {
  Vec o[kBundle], d[kBundle];
  float tl[kBundle];
};

__device__ __forceinline__ BundleRays load_rays(const float* __restrict__ rays, long long b) {
  BundleRays r;
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    const float* ray = rays + (b * kBundle + s) * kRayW;
    r.o[s] = Vec{ray[0], ray[1], ray[2]};
    r.d[s] = Vec{ray[3], ray[4], ray[5]};
    r.tl[s] = ray[6];
  }
  return r;
}

// Step 1 and 2 for bundle b: lane g ends holding the word of boxes
// 32g..32g+31 that some ray keeps and that are not inverted. With `count`,
// returns the number of kept boxes, inverted ones included (warp-uniform).
//
// Two levels: lane g first tests group g's union box (`gboxes` [8, NG]: the
// union of the boxes of 32g..32g+31 that are not inverted, in rows 0-5)
// against the 8 rays, and only the groups that some ray keeps get the
// per-box test. Rejecting a union rejects every box in it: with a finite
// 1/d, rounding is monotone, so a box inside the union enters each slab no
// earlier and leaves it no later. A zero direction component (1/d
// infinite) can make a box's slab NaN where the union's is not, so a
// bundle with one keeps every group. An inverted union holds padding only,
// so its group is never swept and needs no test. Inverted boxes lie
// outside the union, so to count them a group that holds one (row 6 is 1)
// is tested box by box.
__device__ __forceinline__ int cull(const float* __restrict__ rays,
                                    const float* __restrict__ aabbs,
                                    const float* __restrict__ gboxes, long long b, int nsub,
                                    bool count, int lane, unsigned& word) {
  Vec o[kBundle], inv[kBundle];
  float tl[kBundle];
  bool finite = true;
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    const float* ray = rays + (b * kBundle + s) * kRayW;
    o[s] = Vec{ray[0], ray[1], ray[2]};
    inv[s] = Vec{1.0f / ray[3], 1.0f / ray[4], 1.0f / ray[5]};  // IEEE; inf on a zero
    tl[s] = ray[6];
    finite &= isfinite(inv[s].x) && isfinite(inv[s].y) && isfinite(inv[s].z);
  }
  const int ngroups = (nsub + 31) / 32;
  bool group_keep = false;
  if (lane < ngroups) {
    const Vec lo{__ldg(gboxes + lane), __ldg(gboxes + ngroups + lane),
                 __ldg(gboxes + 2 * ngroups + lane)};
    const Vec hi{__ldg(gboxes + 3 * ngroups + lane), __ldg(gboxes + 4 * ngroups + lane),
                 __ldg(gboxes + 5 * ngroups + lane)};
    group_keep = count && __ldg(gboxes + 6 * ngroups + lane) != 0.0f;
    if (!group_keep && !(lo.x > hi.x || lo.y > hi.y || lo.z > hi.z)) {
      group_keep = !finite;
#pragma unroll
      for (int s = 0; s < kBundle; ++s) group_keep |= slab_keep(o[s], inv[s], tl[s], lo, hi);
    }
  }
  unsigned groups = __ballot_sync(kFull, group_keep);
  word = 0;
  int kept = 0;
  while (groups) {
    const int g = __ffs(groups) - 1;
    groups &= groups - 1;
    const int j = g * 32 + lane;
    bool keep = false, sweep = false;
    if (j < nsub) {
      const Vec lo{__ldg(aabbs + j), __ldg(aabbs + nsub + j), __ldg(aabbs + 2 * nsub + j)};
      const Vec hi{__ldg(aabbs + 3 * nsub + j), __ldg(aabbs + 4 * nsub + j),
                   __ldg(aabbs + 5 * nsub + j)};
#pragma unroll
      for (int s = 0; s < kBundle; ++s) keep |= slab_keep(o[s], inv[s], tl[s], lo, hi);
      sweep = keep && !(lo.x > hi.x || lo.y > hi.y || lo.z > hi.z);
    }
    if (count) kept += __popc(__ballot_sync(kFull, keep));
    const unsigned w = __ballot_sync(kFull, sweep);
    if (lane == g) word = w;
  }
  return kept;
}

// fn(c, sorted index) for each of this lane's 4 triangles of sub-block jb.
// With kSkipDropped, a run of 32 triangles that are all dropped (keep row 0:
// a zero normal, which det == 0 rejects) is skipped, as in the oversized
// sub-block, whose slots past the few oversized triangles are empty.
template <bool kSkipDropped = false, typename Fn>
__device__ __forceinline__ void sweep_block(const float* __restrict__ tc, int jb, int lane,
                                            Fn fn) {
  const float* blk = tc + static_cast<long long>(jb) * kRows * kSub;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int tri = j * 32 + lane;
    if (kSkipDropped && !__any_sync(kFull, __ldg(blk + 12 * kSub + tri) != 0.0f)) continue;
    float c[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) c[i] = __ldg(blk + i * kSub + tri);
    fn(c, jb * kSub + tri);
  }
}

// Step 3: block(jb) for every sub-block of the culled words, ascending, until
// it returns true (warp-uniform).
template <typename Fn>
__device__ __forceinline__ void walk(unsigned word, int nsub, Fn block) {
  for (int g = 0; g * 32 < nsub; ++g) {
    unsigned w = __shfl_sync(kFull, word, g);
    while (w) {
      const int k = __ffs(w) - 1;
      w &= w - 1;
      if (block(g * 32 + k)) return;
    }
  }
}

// K5 for bundle b (one warp).
__device__ __forceinline__ void search_bundle(const float* __restrict__ eps_p,
                                              const float* __restrict__ rays,
                                              const float* __restrict__ aabbs,
                                              const float* __restrict__ gboxes,
                                              const float* __restrict__ tc,
                                              float* __restrict__ t_out, int* __restrict__ idx_out,
                                              int* __restrict__ cnt_out, long long b, int nsub,
                                              int lane) {
  unsigned word;
  const int kept = cull(rays, aabbs, gboxes, b, nsub, cnt_out != nullptr, lane, word);
  if (cnt_out != nullptr && lane == 0) cnt_out[b] = kept;
  const float eps = eps_p[0];
  const BundleRays r = load_rays(rays, b);
  float bt[kBundle];
  int bi[kBundle];
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    bt[s] = kBig;
    bi[s] = -1;
  }
  walk(word, nsub, [&](int jb) {
    sweep_block(tc, jb, lane, [&](const float* c, int idx) {
#pragma unroll
      for (int s = 0; s < kBundle; ++s) {
        const float t = plane_t(c, r.o[s], r.d[s], eps);
        if (t < bt[s]) {  // strict: this lane's visits ascend in sorted index
          bt[s] = t;
          bi[s] = idx;
        }
      }
    });
    return false;
  });
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    float t = bt[s];
    int i = bi[s];
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float t2 = __shfl_xor_sync(kFull, t, off);
      const int i2 = __shfl_xor_sync(kFull, i, off);
      if (t2 < t || (t2 == t && i2 < i)) {
        t = t2;
        i = i2;
      }
    }
    if (lane == s) {
      t_out[b * kBundle + s] = t;
      idx_out[b * kBundle + s] = t < kBig ? i : -1;
    }
  }
}

// K6 for bundle b (one warp).
__device__ __forceinline__ void occl_bundle(const float* __restrict__ eps_p,
                                            const float* __restrict__ rays,
                                            const float* __restrict__ aabbs,
                                            const float* __restrict__ gboxes,
                                            const float* __restrict__ tc,
                                            const float* __restrict__ ov,
                                            int* __restrict__ occ_out, int* __restrict__ cnt_out,
                                            long long b, int nsub, int lane) {
  const float eps = eps_p[0];
  const BundleRays r = load_rays(rays, b);
  unsigned occ = 0;      // bit s: ray s of the bundle is occluded (this lane's pairs)
  unsigned settled = 0;  // bit s: ray s cannot be occluded (no t with eps <= t < t_limit)
#pragma unroll
  for (int s = 0; s < kBundle; ++s) settled |= (r.tl[s] > eps ? 0u : 1u) << s;
  unsigned word = 0;  // a bundle that nothing can occlude needs no cull, unless counted
  if (cnt_out != nullptr || settled != kAllRays) {
    const int kept = cull(rays, aabbs, gboxes, b, nsub, cnt_out != nullptr, lane, word);
    if (cnt_out != nullptr && lane == 0) cnt_out[b] = kept;
  }
  const auto test = [&](const float* c, int) {
#pragma unroll
    for (int s = 0; s < kBundle; ++s) {
      float t;
      if (plane_hit(c, r.o[s], r.d[s], eps, t) && t < r.tl[s]) occ |= 1u << s;
    }
  };
  const auto done = [&]() { return (__reduce_or_sync(kFull, occ) | settled) == kAllRays; };
  if (ov != nullptr && settled != kAllRays) sweep_block<true>(ov, 0, lane, test);
  if (!done()) {
    walk(word, nsub, [&](int jb) {
      sweep_block(tc, jb, lane, test);
      return done();
    });
  }
  occ = __reduce_or_sync(kFull, occ);
  if (lane < kBundle) occ_out[b * kBundle + lane] = (occ >> lane) & 1u;
}

__global__ void __launch_bounds__(kWarps * 32)
tile_search_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                   const float* __restrict__ aabbs, const float* __restrict__ gboxes,
                   const float* __restrict__ tc, float* __restrict__ t_out,
                   int* __restrict__ idx_out, int* __restrict__ cnt_out, int bundles,
                   int nsub) {
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= bundles) return;  // the whole warp leaves together
  search_bundle(eps_p, rays, aabbs, gboxes, tc, t_out, idx_out, cnt_out, b, nsub,
                threadIdx.x & 31);
}

__global__ void __launch_bounds__(kWarps * 32)
tile_occl_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                 const float* __restrict__ aabbs, const float* __restrict__ gboxes,
                 const float* __restrict__ tc, const float* __restrict__ ov,
                 int* __restrict__ occ_out, int* __restrict__ cnt_out, int bundles, int nsub) {
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= bundles) return;
  occl_bundle(eps_p, rays, aabbs, gboxes, tc, ov, occ_out, cnt_out, b, nsub, threadIdx.x & 31);
}

int blocks_for(int bundles) { return (bundles + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int rt_tile_search(const float* eps, const float* rays, const float* aabbs,
                   const float* gboxes, const float* tc, float* t_out, int* idx_out,
                   int* cnt_out, int bundles, int nsub, void* stream) {
  if (nsub > kMaxSub) return static_cast<int>(cudaErrorInvalidValue);
  if (bundles > 0) {
    tile_search_kernel<<<blocks_for(bundles), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        eps, rays, aabbs, gboxes, tc, t_out, idx_out, cnt_out, bundles, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_tile_occl(const float* eps, const float* rays, const float* aabbs, const float* gboxes,
                 const float* tc, const float* ov, int* occ_out, int* cnt_out, int bundles,
                 int nsub, void* stream) {
  if (nsub > kMaxSub) return static_cast<int>(cudaErrorInvalidValue);
  if (bundles > 0) {
    tile_occl_kernel<<<blocks_for(bundles), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, rays, aabbs, gboxes, tc, ov, occ_out, cnt_out, bundles, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
