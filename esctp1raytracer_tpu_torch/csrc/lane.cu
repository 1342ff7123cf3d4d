// Ray-lane closest-hit kernel (K4) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel esctp1raytracer_tpu/kernels/lane_pallas.py:
// _lane_kernel, together with what feeds it there: the 13 plane/barycentric
// constants per triangle (lane_tri_constants) and the valid prefix. That
// kernel puts one ray on each vector lane and walks every triangle's
// constants from scalar memory. Here one thread is one ray, and the launch
// is the whole lane_tri_search:
//
//   1. prologue, once per block: the block finds n, one past the last valid
//      triangle (a block-wide maximum), and builds the constants of
//      triangles [0, n) from the buffer's v0, v1, v2 and valid columns into
//      dynamic shared memory, rounded as PyTorch rounds lane_tri_constants
//      on the CPU (lane_plane.cuh:tri_constants). The sweep needs 12 of the
//      13 (not the valid flag), stored as three 16-byte rows so that a
//      thread reads a triangle with three vector loads: 48 bytes each,
//      192 KB at N = 4096, under the 227 KB a block may use;
//   2. the blocks are persistent (as many as fit on the card at once), and
//      each thread walks its rays with a grid stride; per ray, every
//      triangle in ascending order, keeping (t, index) on strict < (minimum
//      t, ties to the lowest index), unrolled by 4. Every shared read is a
//      broadcast, and there is no barrier after the prologue. (Blocks of 512
//      and the unrolling read about 5% faster than blocks of 256 without it
//      on Cornell's wavefronts; scripts/probe_k3k4.py, on the H100.)
//
// What bounds it on the H100: arithmetic, 40 float32 operations per (ray,
// triangle) pair, one of them an IEEE division, or 16 where the exact
// division skip of lane_plane.cuh rejects the pair before the division (the
// ray's line meets the triangle's plane behind its origin, or not at all;
// chip_smoke.py counts both kinds on its wavefronts). Built with
// -fmad=false (no FMAs), so it can reach at most
// half of a float32 bound taken at 67 TFLOP/s. No tensor cores.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false. C interface, loaded with ctypes;
// the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_plane.cuh"

namespace {

constexpr int kThreads = 512;   // rays per block at a time
constexpr int kMaxTris = 4096;  // LANE_TRI_LIMIT
constexpr int kRowW = 12;  // floats per triangle in shared memory
constexpr int kMaxSmem = kMaxTris * kRowW * 4;

__device__ __forceinline__ Vec load3(const float* __restrict__ p, int i) {
  return Vec{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__global__ void __launch_bounds__(kThreads)
lane_search_kernel(float eps, const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, const uint8_t* __restrict__ valid, int cap,
                   const float* __restrict__ o_in, const float* __restrict__ d_in,
                   float* __restrict__ t_out, int* __restrict__ idx_out, int rays) {
  extern __shared__ __align__(16) float tab[];  // [n, 12]
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  int last = 0;  // one past this thread's last valid triangle
  for (int i = threadIdx.x; i < cap; i += kThreads) last = valid[i] ? i + 1 : last;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0 && last > 0) atomicMax(&s_n, last);
  __syncthreads();
  const int n = s_n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float c[kTcsW];
    tri_constants(load3(v0, i), load3(v1, i), load3(v2, i), valid[i] != 0, c);
    float4* r = reinterpret_cast<float4*>(tab + i * kRowW);
    r[0] = make_float4(c[0], c[1], c[2], c[3]);
    r[1] = make_float4(c[4], c[5], c[6], c[7]);
    r[2] = make_float4(c[8], c[9], c[10], c[11]);
  }
  __syncthreads();  // the last barrier: the sweep below has none

  for (int ray = blockIdx.x * kThreads + threadIdx.x; ray < rays; ray += gridDim.x * kThreads) {
    const Vec o = load3(o_in, ray), d = load3(d_in, ray);
    float bt = kBig;
    int bi = -1;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const Row12 c = row12(tab, i);
      const float t = plane_t_skip(c.c0, c.c1, c.c2, o, d, eps);
      if (t < bt) {  // strict: ties to the lowest index
        bt = t;
        bi = i;
      }
    }
    t_out[ray] = bt;
    idx_out[ray] = bt < kBig ? bi : -1;
  }
}

// The persistent grid: as many blocks as are resident at once on the card,
// from the kernel's registers (ptxas) and its shared memory, or fewer when
// the rays need fewer.
cudaError_t launch_shape(int rays, int cap, int* blocks, int* per_sm, int* smem) {
  *smem = cap * kRowW * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(lane_search_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, lane_search_kernel, kThreads,
                                                      *smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int want = (rays + kThreads - 1) / kThreads;
  *blocks = want < sms * *per_sm ? want : sms * *per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Threads per block, the blocks resident per SM, the grid and the dynamic
// shared memory of a launch over `rays` rays and a `cap`-triangle buffer.
int lane_launch_shape(int rays, int cap, int* threads, int* per_sm, int* blocks, int* smem) {
  if (cap > kMaxTris) return cudaErrorInvalidValue;
  *threads = kThreads;
  return static_cast<int>(launch_shape(rays, cap, blocks, per_sm, smem));
}

int lane_search(float eps, const float* v0, const float* v1, const float* v2,
                const uint8_t* valid, int cap, const float* o, const float* d, float* t_out,
                int* idx_out, int rays, void* stream) {
  if (cap > kMaxTris) return cudaErrorInvalidValue;
  if (rays > 0) {
    int blocks = 0, per_sm = 0, smem = 0;
    const cudaError_t err = launch_shape(rays, cap, &blocks, &per_sm, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    lane_search_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        eps, v0, v1, v2, valid, cap, o, d, t_out, idx_out, rays);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
