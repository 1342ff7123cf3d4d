// Tile search kernels for Hopper (sm_90a): K5, closest hit, and K6, any hit.
//
// Replace the TPU Pallas kernels esctp1raytracer_tpu/kernels/rt_tile.py:
// _tile_kernel and _occl_tile_kernel. The TPU kernel puts a bundle's 8 rays
// on the 8 sublanes and a 128-triangle sub-block on the 128 lanes of one
// vector op, and walks the bundle's ascending sub-block list one sub-block
// per loop step. Here one warp is one bundle: lane l owns triangles
// l, l + 32, l + 64, l + 96 of each sub-block, loads their 12 plane
// constants with coalesced 128-byte reads (the [NSUB, 16, 128] table is
// row-major, so a row of 32 lanes is contiguous), and tests each against
// all 8 rays, which every lane holds in registers. The constants are read
// once per warp and used 8 times; the list entries are read 32 at a time by
// the warp and handed out by shuffle.
//
// Tie rule (K5). A lane visits its pairs in ascending sorted index (the list
// ascends, and j * 32 + lane ascends in j), so a strict < keeps the lowest
// index at the lane's minimum t. The warp then folds the 32 lanes per ray:
// the smaller t, and on equal t the smaller index. The result is the
// minimum t over the bundle's list, ties to the lowest sorted index: the
// TPU kernel's running (t, block) per (ray, lane) with its one lowest-index
// fold per bundle. K6 ORs the accepted pairs with t < t_limit per ray and
// folds with one __reduce_or_sync. Neither kernel clamps K5's t to t_limit:
// the caller's limit only culled the lists.
//
// What bounds it on the H100: arithmetic, about 30 float32 operations and
// one IEEE division per (ray, triangle) pair, with the rays in registers;
// the table (6.4 MB at 100k triangles) stays in the 50 MB L2. The lists are
// heavy-tailed (bundles grazing the ground cross O(100) sub-blocks), and one
// warp per bundle does not balance them: that, shared-memory staging and an
// early exit for K6 are left to later work.
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

namespace {

constexpr int kBundle = 8;   // rays per bundle (one warp)
constexpr int kSub = 128;    // triangles per sub-block
constexpr int kRows = 16;    // constant rows per sub-block (12 read)
constexpr int kRayW = 8;     // floats per ray: o, d, t_limit, pad
constexpr int kWarps = 8;    // bundles per block
constexpr int kPerLane = kSub / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Visits every triangle of bundle b's list: fn(c, sorted index) per lane triangle.
template <typename Fn>
__device__ __forceinline__ void sweep(const int* __restrict__ ids, const int* __restrict__ cnt,
                                      const float* __restrict__ tc, long long b, int nsub,
                                      int lane, Fn fn) {
  const int n = min(cnt[b], nsub);
  const int* list = ids + b * nsub;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int mine = k0 + lane < n ? __ldg(list + k0 + lane) : 0;
    const int m = min(32, n - k0);
    for (int k = 0; k < m; ++k) {
      const int jb = __shfl_sync(kFull, mine, k);
      const float* blk = tc + static_cast<long long>(jb) * kRows * kSub;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int tri = j * 32 + lane;
        float c[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) c[i] = __ldg(blk + i * kSub + tri);
        fn(c, jb * kSub + tri);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
tile_search_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                   const int* __restrict__ ids, const int* __restrict__ cnt,
                   const float* __restrict__ tc, float* __restrict__ t_out,
                   int* __restrict__ idx_out, int bundles, int nsub) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= bundles) return;  // the whole warp leaves together
  const float eps = eps_p[0];
  const BundleRays r = load_rays(rays, b);
  float bt[kBundle];
  int bi[kBundle];
#pragma unroll
  for (int s = 0; s < kBundle; ++s) {
    bt[s] = kBig;
    bi[s] = -1;
  }
  sweep(ids, cnt, tc, b, nsub, lane, [&](const float* c, int idx) {
#pragma unroll
    for (int s = 0; s < kBundle; ++s) {
      const float t = plane_t(c, r.o[s], r.d[s], eps);
      if (t < bt[s]) {  // strict: this lane's visits ascend in sorted index
        bt[s] = t;
        bi[s] = idx;
      }
    }
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

__global__ void __launch_bounds__(kWarps * 32)
tile_occl_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                 const int* __restrict__ ids, const int* __restrict__ cnt,
                 const float* __restrict__ tc, int* __restrict__ occ_out, int bundles,
                 int nsub) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= bundles) return;
  const float eps = eps_p[0];
  const BundleRays r = load_rays(rays, b);
  unsigned occ = 0;  // bit s: ray s of the bundle is occluded
  sweep(ids, cnt, tc, b, nsub, lane, [&](const float* c, int) {
#pragma unroll
    for (int s = 0; s < kBundle; ++s) {
      float t;
      if (plane_hit(c, r.o[s], r.d[s], eps, t) && t < r.tl[s]) occ |= 1u << s;
    }
  });
  occ = __reduce_or_sync(kFull, occ);
  if (lane < kBundle) occ_out[b * kBundle + lane] = (occ >> lane) & 1u;
}

int blocks_for(int bundles) { return (bundles + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int rt_tile_search(const float* eps, const float* rays, const int* ids, const int* cnt,
                   const float* tc, float* t_out, int* idx_out, int bundles, int nsub,
                   void* stream) {
  if (bundles > 0) {
    tile_search_kernel<<<blocks_for(bundles), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(eps, rays, ids, cnt, tc, t_out,
                                                              idx_out, bundles, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_tile_occl(const float* eps, const float* rays, const int* ids, const int* cnt,
                 const float* tc, int* occ_out, int bundles, int nsub, void* stream) {
  if (bundles > 0) {
    tile_occl_kernel<<<blocks_for(bundles), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, rays, ids, cnt, tc, occ_out, bundles, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
