// Ray-lane closest-hit kernel (K4) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel esctp1raytracer_tpu/kernels/lane_pallas.py:
// _lane_kernel. That kernel puts one ray on each vector lane and walks every
// triangle's 13 plane/barycentric constants from scalar memory. Here one
// thread is one ray. The [N, 13] constant table (N <= 4096, 213 KB at the
// limit) streams through shared memory in tiles of kTile triangles: all
// threads of a block copy a tile together, then every thread walks it in
// ascending order, so every shared read is a broadcast and the tie rule
// holds (strict <: minimum t, ties to the lowest index). The whole table is
// never resident, so the block needs 13 KB of shared memory and many blocks
// fit on each SM.
//
// What bounds it on the H100: arithmetic, about 30 float32 operations and
// one IEEE division per (ray, triangle) pair, with the ray in registers and
// the constants broadcast from shared memory. The table copy is 52 bytes per
// triangle per block of 256 rays. No tensor cores.
//
// The per-pair test is plane_t of lane_plane.cuh, which the fused kernel
// (csrc/fused.cu) shares: IEEE division (no fast math) and -fmad=false, so
// every product and sum rounds on its own, in the plain PyTorch version's
// order.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false. C interface, loaded with ctypes;
// the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "lane_plane.cuh"

namespace {

constexpr int kThreads = 256;  // rays per block
constexpr int kTile = 256;     // triangles per shared-memory tile

__global__ void __launch_bounds__(kThreads)
lane_search_kernel(const float* __restrict__ eps_p, const int* __restrict__ n_p,
                   const float* __restrict__ tcs, const float* __restrict__ o_in,
                   const float* __restrict__ d_in, float* __restrict__ t_out,
                   int* __restrict__ idx_out, int rays) {
  __shared__ float tile[kTile * kTcsW];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < rays;
  const float eps = eps_p[0];
  const int n = n_p[0];
  Vec o{0.f, 0.f, 0.f}, d{0.f, 0.f, 1.f};
  if (live) {
    o = Vec{o_in[3 * ray], o_in[3 * ray + 1], o_in[3 * ray + 2]};
    d = Vec{d_in[3 * ray], d_in[3 * ray + 1], d_in[3 * ray + 2]};
  }
  float bt = kBig;
  int bi = -1;
  for (int base = 0; base < n; base += kTile) {
    const int len = min(kTile, n - base);
    __syncthreads();  // the previous tile is done with
    for (int i = threadIdx.x; i < len * kTcsW; i += kThreads) tile[i] = tcs[base * kTcsW + i];
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      const float t = plane_t(tile + i * kTcsW, o, d, eps);
      if (t < bt) {  // strict: ties to the lowest index
        bt = t;
        bi = base + i;
      }
    }
  }
  if (live) {
    t_out[ray] = bt;
    idx_out[ray] = bt < kBig ? bi : -1;
  }
}

}  // namespace

extern "C" {

int lane_search(const float* eps, const int* n_tris, const float* tcs, const float* o,
                const float* d, float* t_out, int* idx_out, int rays, void* stream) {
  if (rays > 0) {
    const int blocks = (rays + kThreads - 1) / kThreads;
    lane_search_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, n_tris, tcs, o, d, t_out, idx_out, rays);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
