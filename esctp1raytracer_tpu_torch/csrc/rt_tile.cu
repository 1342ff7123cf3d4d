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
// The JAX package's other pre-pass modes and K6's exit period are further
// instantiations (below tile_occl_kernel: tile_search_mode_kernel,
// tile_occl_mode_kernel), whose warps build their lists in shared memory.
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

// ---------------------------------------------------------------------------
// The JAX package's selectable pre-pass modes (rt_tile.py: CULL_MODE,
// OCCL_EARLY_EXIT), one instantiation each. The kernels above are the
// default: argsort lists, exit after each block.
//
// A warp builds its bundle's list explicitly, in shared memory, exactly as
// rt_tile.py:_lists builds it: the same sub-blocks in the same order and the
// same count, including each mode's dense fallback. Then it walks the list
// (a padding-only sub-block, inverted box, is counted but not swept). The
// modes:
// * argsort (0): the per-ray test, kept sub-blocks ascending;
// * exact (1): the same, but more than kExtractK kept: every sub-block;
// * interval (2): cull.py:group_cull_mask, one interval test per box for
//   the bundle in place of eight, with exact's fallback;
// * hier (3): superblocks of hier_g sub-blocks (union boxes; all-padding
//   ones masked), per-ray tested; more than hier_k kept: every sub-block;
//   else the sub-boxes of the first min(hier_k, superblocks) superblocks in
//   the stable order kept-first (_hier_cull_lists), per-ray tested, padding
//   never listed;
// * entry (4, K6 only): the kept sub-blocks sorted by the bundle's smallest
//   entry key (entry_key), ties to the lower sub-block: a rank sort in
//   shared memory, O(n^2 / 32) per lane for n kept sub-blocks.
// K6 tests "every ray occluded or unable to be" every `period` listed
// sub-blocks (the JAX kernel's early exit E; E = 0 there, and the default
// here, test after each).
// ---------------------------------------------------------------------------

constexpr int kGenWarps = 4;    // bundles per block (8 KB of lists each)
constexpr int kExtractK = 32;   // cull.py:CULL_EXTRACT_K
enum Mode { kArgsort = 0, kExact = 1, kInterval = 2, kHier = 3, kEntry = 4 };

struct WarpLists {
  unsigned short list[kMaxSub];  // the sub-blocks to visit, in order
  unsigned short aux[kMaxSub];   // hier: the superblock order; entry: the sorted list
  float key[kMaxSub];            // entry: the keys, by position in `list`
};

__device__ __forceinline__ Vec box_lo(const float* __restrict__ b, int n, int j) {
  return Vec{__ldg(b + j), __ldg(b + n + j), __ldg(b + 2 * n + j)};
}

__device__ __forceinline__ Vec box_hi(const float* __restrict__ b, int n, int j) {
  return Vec{__ldg(b + 3 * n + j), __ldg(b + 4 * n + j), __ldg(b + 5 * n + j)};
}

__device__ __forceinline__ bool inverted(Vec lo, Vec hi) {
  return lo.x > hi.x || lo.y > hi.y || lo.z > hi.z;
}

// Append the lanes with `keep` to list[n..] in lane order; returns the new n.
__device__ __forceinline__ int append(unsigned short* list, int n, bool keep, int value, int lane) {
  const unsigned w = __ballot_sync(kFull, keep);
  if (keep) list[n + __popc(w & ((1u << lane) - 1u))] = static_cast<unsigned short>(value);
  return n + __popc(w);
}

__device__ __forceinline__ int dense(unsigned short* list, int nsub, int lane) {
  for (int j = lane; j < nsub; j += 32) list[j] = static_cast<unsigned short>(j);
  __syncwarp();
  return nsub;
}

// Bundle b's list; returns its length (the plain version's cnt) and points
// `out` at it.
template <int kMode>
__device__ int build_list(const float* __restrict__ rays, const float* __restrict__ aabbs, int nsub,
                          long long b, int lane, int hier_g, int hier_k, WarpLists& wl,
                          const unsigned short*& out) {
  Vec o[kBundle], inv[kBundle];
  float tl[kBundle];
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    const float* ray = rays + (b * kBundle + s) * kRayW;
    o[s] = Vec{ray[0], ray[1], ray[2]};
    inv[s] = Vec{1.0f / ray[3], 1.0f / ray[4], 1.0f / ray[5]};  // IEEE; inf on a zero
    tl[s] = ray[6];
  }
  out = wl.list;
  int n = 0;
  if constexpr (kMode == kHier) {
    // Superblocks: lane l tests superblock s0 + l; lane w keeps word w of the kept ones.
    const int ns = (nsub + hier_g - 1) / hier_g, k = min(hier_k, ns);
    unsigned sword = 0;
    int kept = 0;
    for (int s0 = 0; s0 < ns; s0 += 32) {
      const int sb = s0 + lane;
      bool keep = false;
      if (sb < ns) {
        Vec lo = box_lo(aabbs, nsub, sb * hier_g), hi = box_hi(aabbs, nsub, sb * hier_g);
        for (int j = 1; j < hier_g; ++j) {  // the union; past nsub, inverted filler
          const int c = sb * hier_g + j;
          const Vec l2 = c < nsub ? box_lo(aabbs, nsub, c) : Vec{1e30f, 1e30f, 1e30f};
          const Vec h2 = c < nsub ? box_hi(aabbs, nsub, c) : Vec{-1e30f, -1e30f, -1e30f};
          lo = Vec{nan_min(lo.x, l2.x), nan_min(lo.y, l2.y), nan_min(lo.z, l2.z)};
          hi = Vec{nan_max(hi.x, h2.x), nan_max(hi.y, h2.y), nan_max(hi.z, h2.z)};
        }
        if (!inverted(lo, hi)) {
#pragma unroll
          for (int s = 0; s < kBundle; ++s) keep |= slab_keep(o[s], inv[s], tl[s], lo, hi);
        }
      }
      const unsigned w = __ballot_sync(kFull, keep);
      if (lane == s0 / 32) sword = w;
      kept += __popc(w);
    }
    if (kept > k) return dense(wl.list, nsub, lane);
    // The first k superblocks of the stable order kept-first, into aux.
    int kept_before = 0, other_before = 0;
    for (int s0 = 0; s0 < ns; s0 += 32) {
      const unsigned kw = __shfl_sync(kFull, sword, s0 / 32);
      const unsigned valid = ns - s0 >= 32 ? kFull : (1u << (ns - s0)) - 1u;
      const unsigned lt = (1u << lane) - 1u;
      if ((valid >> lane) & 1u) {
        const int pos = (kw >> lane) & 1u ? kept_before + __popc(kw & lt)
                                          : kept + other_before + __popc(~kw & valid & lt);
        if (pos < k) wl.aux[pos] = static_cast<unsigned short>(s0 + lane);
      }
      kept_before += __popc(kw);
      other_before += __popc(~kw & valid);
    }
    __syncwarp();
    // Their sub-boxes, in that order: entry q = slot q / hier_g, member q % hier_g.
    for (int q0 = 0; q0 < k * hier_g; q0 += 32) {
      const int q = q0 + lane;
      bool keep = false;
      int c = 0;
      if (q < k * hier_g) {
        c = wl.aux[q / hier_g] * hier_g + q % hier_g;
        if (c < nsub) {
          const Vec lo = box_lo(aabbs, nsub, c), hi = box_hi(aabbs, nsub, c);
          if (!inverted(lo, hi)) {
#pragma unroll
            for (int s = 0; s < kBundle; ++s) keep |= slab_keep(o[s], inv[s], tl[s], lo, hi);
          }
        }
      }
      n = append(wl.list, n, keep, c, lane);
    }
    __syncwarp();
    return n;
  }
  Interval iv;
  if constexpr (kMode == kInterval) {
    float o_lo[3], o_hi[3], d_lo[3], d_hi[3], tl_hi = tl[0];
    const float* r0 = rays + b * kBundle * kRayW;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o_lo[a] = o_hi[a] = r0[a];
      d_lo[a] = d_hi[a] = r0[3 + a];
    }
#pragma unroll
    for (int s = 1; s < kBundle; ++s) {
      const float* ray = rays + (b * kBundle + s) * kRayW;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o_lo[a] = nan_min(o_lo[a], ray[a]);
        o_hi[a] = nan_max(o_hi[a], ray[a]);
        d_lo[a] = nan_min(d_lo[a], ray[3 + a]);
        d_hi[a] = nan_max(d_hi[a], ray[3 + a]);
      }
      tl_hi = nan_max(tl_hi, tl[s]);
    }
    iv = make_interval(o_lo, o_hi, d_lo, d_hi, tl_hi);
  }
  for (int c0 = 0; c0 < nsub; c0 += 32) {
    const int c = c0 + lane;
    bool keep = false;
    float key = __int_as_float(0x7f800000);  // +inf: culled
    if (c < nsub) {
      const Vec lo = box_lo(aabbs, nsub, c), hi = box_hi(aabbs, nsub, c);
      if constexpr (kMode == kInterval) {
        keep = interval_keep(iv, lo, hi);
      } else {
#pragma unroll
        for (int s = 0; s < kBundle; ++s) {
          float tn;
          const bool k = slab_entry(o[s], inv[s], tl[s], lo, hi, tn);
          keep |= k;
          if (kMode == kEntry && k) key = fminf(key, entry_key(tn));
        }
      }
    }
    if constexpr (kMode == kEntry) {
      const unsigned w = __ballot_sync(kFull, keep);
      if (keep) wl.key[n + __popc(w & ((1u << lane) - 1u))] = key;
    }
    n = append(wl.list, n, keep, c, lane);
  }
  __syncwarp();
  if ((kMode == kExact || kMode == kInterval) && n > kExtractK) return dense(wl.list, nsub, lane);
  if constexpr (kMode == kEntry) {
    // Stable sort by key: each kept sub-block's rank, the list ascending in id.
    for (int i = lane; i < n; i += 32) {
      const float ki = wl.key[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const float kj = wl.key[j];
        rank += kj < ki || (kj == ki && j < i);
      }
      wl.aux[rank] = wl.list[i];
    }
    __syncwarp();
    out = wl.aux;
  }
  return n;
}

// fn(sub-block, ends a period) for each listed sub-block in order, -1 in
// place of a padding-only one (which is not swept but counts toward
// `period`); stops when fn returns true (warp-uniform).
template <typename Fn>
__device__ __forceinline__ void walk_list(const unsigned short* list, int n,
                                          const float* __restrict__ aabbs, int nsub, int period,
                                          Fn fn) {
  for (int i = 0; i < n; ++i) {
    const int jb = list[i];
    const bool ends = (i + 1) % period == 0;
    if (!inverted(box_lo(aabbs, nsub, jb), box_hi(aabbs, nsub, jb))) {
      if (fn(jb, ends)) return;
    } else if (ends && fn(-1, true)) {
      return;
    }
  }
}

// search_bundle for the mode kernels (the default's code above stays as it
// was): build() makes the bundle's lists and returns their count; walk(fn)
// calls fn(sub-block, ends a period) for each listed sub-block in order (-1
// for a padding-only one that ends a period), until fn returns true.
template <typename Build, typename Walk>
__device__ __forceinline__ void listed_search(const float* __restrict__ eps_p,
                                              const float* __restrict__ rays,
                                              const float* __restrict__ tc,
                                              float* __restrict__ t_out, int* __restrict__ idx_out,
                                              int* __restrict__ cnt_out, long long b, int lane,
                                              Build build, Walk walk_lists) {
  const int kept = build();
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
  walk_lists([&](int jb, bool) {
    if (jb < 0) return false;  // padding only
    sweep_block(tc, jb, lane, [&](const float* c, int idx) {
#pragma unroll
      for (int s = 0; s < kBundle; ++s) {
        const float t = plane_t(c, r.o[s], r.d[s], eps);
        if (t < bt[s]) {  // strict: the lists ascend, so this lane's visits do
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

// occl_bundle for the mode kernels; build and walk as listed_search's. The
// bundle stops where a period ends with every ray occluded or unable to be.
template <typename Build, typename Walk>
__device__ __forceinline__ void listed_occl(const float* __restrict__ eps_p,
                                            const float* __restrict__ rays,
                                            const float* __restrict__ tc,
                                            const float* __restrict__ ov,
                                            int* __restrict__ occ_out, int* __restrict__ cnt_out,
                                            long long b, int lane, Build build,
                                            Walk walk_lists) {
  const float eps = eps_p[0];
  const BundleRays r = load_rays(rays, b);
  unsigned occ = 0;      // bit s: ray s of the bundle is occluded (this lane's pairs)
  unsigned settled = 0;  // bit s: ray s cannot be occluded (no t with eps <= t < t_limit)
#pragma unroll
  for (int s = 0; s < kBundle; ++s) settled |= (r.tl[s] > eps ? 0u : 1u) << s;
  // A bundle that nothing can occlude needs no lists (walk then visits nothing), unless counted.
  if (cnt_out != nullptr || settled != kAllRays) {
    const int kept = build();
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
    walk_lists([&](int jb, bool ends) {
      if (jb >= 0) sweep_block(tc, jb, lane, test);
      return ends && done();
    });
  }
  occ = __reduce_or_sync(kFull, occ);
  if (lane < kBundle) occ_out[b * kBundle + lane] = (occ >> lane) & 1u;
}

template <int kMode>
__global__ void __launch_bounds__(kGenWarps * 32)
tile_search_mode_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                        const float* __restrict__ aabbs, const float* __restrict__ tc,
                        float* __restrict__ t_out, int* __restrict__ idx_out,
                        int* __restrict__ cnt_out, int bundles, int nsub, int hier_g,
                        int hier_k) {
  __shared__ WarpLists lists[kGenWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kGenWarps + warp;
  if (b >= bundles) return;
  const unsigned short* list = lists[warp].list;
  int n = 0;
  listed_search(
      eps_p, rays, tc, t_out, idx_out, cnt_out, b, lane,
      [&] { return n = build_list<kMode>(rays, aabbs, nsub, b, lane, hier_g, hier_k, lists[warp],
                                         list); },
      [&](auto fn) { walk_list(list, n, aabbs, nsub, 1, fn); });
}

template <int kMode>
__global__ void __launch_bounds__(kGenWarps * 32)
tile_occl_mode_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                      const float* __restrict__ aabbs, const float* __restrict__ tc,
                      const float* __restrict__ ov, int* __restrict__ occ_out,
                      int* __restrict__ cnt_out, int bundles, int nsub, int hier_g, int hier_k,
                      int period) {
  __shared__ WarpLists lists[kGenWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kGenWarps + warp;
  if (b >= bundles) return;
  const unsigned short* list = lists[warp].list;
  int n = 0;
  listed_occl(
      eps_p, rays, tc, ov, occ_out, cnt_out, b, lane,
      [&] { return n = build_list<kMode>(rays, aabbs, nsub, b, lane, hier_g, hier_k, lists[warp],
                                         list); },
      [&](auto fn) { walk_list(list, n, aabbs, nsub, period, fn); });
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

// The mode instantiations: `mode` a Mode, period >= 1 (K6); argsort with
// period 1 is rt_tile_search / rt_tile_occl.
int rt_tile_search_mode(const float* eps, const float* rays, const float* aabbs, const float* tc,
                        float* t_out, int* idx_out, int* cnt_out, int bundles, int nsub, int mode,
                        int hier_g, int hier_k, void* stream) {
  if (nsub > kMaxSub || hier_g < 1 || mode < kExact || mode > kHier) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bundles > 0) {
    const int blocks = (bundles + kGenWarps - 1) / kGenWarps;
    const auto st = static_cast<cudaStream_t>(stream);
    auto kernel = mode == kExact      ? tile_search_mode_kernel<kExact>
                  : mode == kInterval ? tile_search_mode_kernel<kInterval>
                                      : tile_search_mode_kernel<kHier>;
    kernel<<<blocks, kGenWarps * 32, 0, st>>>(eps, rays, aabbs, tc, t_out, idx_out, cnt_out,
                                              bundles, nsub, hier_g, hier_k);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_tile_occl_mode(const float* eps, const float* rays, const float* aabbs, const float* tc,
                      const float* ov, int* occ_out, int* cnt_out, int bundles, int nsub, int mode,
                      int hier_g, int hier_k, int period, void* stream) {
  if (nsub > kMaxSub || hier_g < 1 || period < 1 || mode < kArgsort || mode > kEntry) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bundles > 0) {
    const int blocks = (bundles + kGenWarps - 1) / kGenWarps;
    const auto st = static_cast<cudaStream_t>(stream);
    auto kernel = mode == kExact      ? tile_occl_mode_kernel<kExact>
                  : mode == kInterval ? tile_occl_mode_kernel<kInterval>
                  : mode == kHier     ? tile_occl_mode_kernel<kHier>
                  : mode == kEntry    ? tile_occl_mode_kernel<kEntry>
                                      : tile_occl_mode_kernel<kArgsort>;
    kernel<<<blocks, kGenWarps * 32, 0, st>>>(eps, rays, aabbs, tc, ov, occ_out, cnt_out, bundles,
                                              nsub, hier_g, hier_k, period);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
