// mxtile closest-hit (K1) and any-hit (K2) kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels esctp1raytracer_tpu/kernels/rt_mxu.py:
// _mxu_kernel (K1) and _mxu_occl_kernel (K2). Both take one 128-ray group
// per CUDA block, one thread per ray, and sweep the group's ascending list
// of 128-triangle blocks. Per block, each ray forms the Möller–Trumbore
// quantities [det, t*det, u*det, v*det] as length-16 dot products of its
// ray features (registers) with the block's [16, 512] feature slab (shared
// memory), then applies the acceptance window
//   |det| >= eps, u >= eps, v >= eps, u + v <= 1, t >= eps (K2: t < t_limit)
// with t = t_num * (1 / det), as the TPU kernel does.
//
// What bounds it on the H100: arithmetic. A (ray, triangle) pair costs 64
// float32 FMAs and 16 shared-memory float4 loads (one slab column per
// quantity, broadcast to the whole warp); the slab copy is 32 KB per block
// and per group, small against the 128 x 128 pairs it feeds. The design
// keeps the rays in registers and each slab in shared memory (32 KB, up to
// 7 blocks per SM), and reads four columns per float4 so that each shared
// load feeds four FMAs. No tensor cores: TF32 or bf16 inputs flip
// winners and shadow tests (the JAX package measured it), so the products
// stay in float32.
//
// Tie rule (K1): each thread visits its blocks in ascending order and the
// columns of a block in ascending order, and keeps a hit only on a strict
// t < best. That gives the TPU kernel's result: the minimum t, ties to the
// lowest sorted triangle index.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//          -shared -Xcompiler -fPIC (never -use_fast_math: the window needs
//          IEEE 1/det). C interface, loaded with ctypes; every entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 128;         // rays per group = threads per block
constexpr int kSub = 128;          // triangles per block
constexpr int kFeat = 16;          // ray / triangle features
constexpr int kCols = 4 * kSub;    // det | t*det | u*det | v*det
constexpr int kSlab = kFeat * kCols;  // floats per block slab (32 KB)
constexpr float kBig = 1e30f;

// Copy block jb's [16, 512] slab into shared memory, coalesced float4s.
__device__ __forceinline__ void load_slab(float* slab, const float* __restrict__ tfq,
                                          int jb) {
  const float4* src = reinterpret_cast<const float4*>(tfq + (size_t)jb * kSlab);
  float4* dst = reinterpret_cast<float4*>(slab);
#pragma unroll 4
  for (int i = threadIdx.x; i < kSlab / 4; i += kRays) dst[i] = src[i];
}

// The four quantities for columns c..c+3 of the slab.
struct Quad {
  float4 det, tn, un, vn;
};

__device__ __forceinline__ void fma4(float4& acc, float r, const float4& s) {
  acc.x = fmaf(r, s.x, acc.x);
  acc.y = fmaf(r, s.y, acc.y);
  acc.z = fmaf(r, s.z, acc.z);
  acc.w = fmaf(r, s.w, acc.w);
}

__device__ __forceinline__ Quad contract4(const float (&rf)[kFeat], const float* slab,
                                          int c) {
  Quad q;
  q.det = q.tn = q.un = q.vn = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* s4 = reinterpret_cast<const float4*>(slab);
#pragma unroll
  for (int f = 0; f < kFeat; ++f) {
    const int row = (f * kCols + c) >> 2;
    fma4(q.det, rf[f], s4[row]);
    fma4(q.tn, rf[f], s4[row + kSub / 4]);
    fma4(q.un, rf[f], s4[row + 2 * kSub / 4]);
    fma4(q.vn, rf[f], s4[row + 3 * kSub / 4]);
  }
  return q;
}

// Acceptance window; writes the hit distance to t.
__device__ __forceinline__ bool accept(float det, float tn, float un, float vn,
                                       float eps, float& t) {
  const float inv = 1.0f / det;  // IEEE division (no fast math)
  t = tn * inv;
  const float u = un * inv;
  const float v = vn * inv;
  return fabsf(det) >= eps && u >= eps && v >= eps && u + v <= 1.0f && t >= eps;
}

__device__ __forceinline__ void load_ray(float (&rf)[kFeat], const float* __restrict__ rays,
                                         int ray) {
  const float4* r4 = reinterpret_cast<const float4*>(rays + (size_t)ray * kFeat);
#pragma unroll
  for (int i = 0; i < kFeat / 4; ++i) {
    const float4 x = r4[i];
    rf[4 * i] = x.x;
    rf[4 * i + 1] = x.y;
    rf[4 * i + 2] = x.z;
    rf[4 * i + 3] = x.w;
  }
}

__global__ void __launch_bounds__(kRays)
mxu_search_kernel(const float* __restrict__ eps_p, const int* __restrict__ ids,
                  const int* __restrict__ cnt, const float* __restrict__ rays,
                  const float* __restrict__ tfq, float* __restrict__ t_out,
                  int* __restrict__ idx_out, int nsub) {
  __shared__ __align__(16) float slab[kSlab];
  const int g = blockIdx.x;
  const int ray = g * kRays + threadIdx.x;
  const float eps = eps_p[0];
  float rf[kFeat];
  load_ray(rf, rays, ray);

  float bt = kBig;
  int bi = -1;
  const int n = cnt[g];
  for (int k = 0; k < n; ++k) {
    const int jb = ids[(size_t)g * nsub + k];
    load_slab(slab, tfq, jb);
    __syncthreads();
    for (int c = 0; c < kSub; c += 4) {
      const Quad q = contract4(rf, slab, c);
      const float dets[4] = {q.det.x, q.det.y, q.det.z, q.det.w};
      const float tns[4] = {q.tn.x, q.tn.y, q.tn.z, q.tn.w};
      const float uns[4] = {q.un.x, q.un.y, q.un.z, q.un.w};
      const float vns[4] = {q.vn.x, q.vn.y, q.vn.z, q.vn.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        if (accept(dets[j], tns[j], uns[j], vns[j], eps, t) && t < bt) {
          bt = t;
          bi = jb * kSub + c + j;
        }
      }
    }
    __syncthreads();  // every ray is done with the slab before the next copy
  }
  t_out[ray] = bt;
  idx_out[ray] = bt < kBig ? bi : -1;
}

__global__ void __launch_bounds__(kRays)
mxu_occl_kernel(const float* __restrict__ eps_p, const int* __restrict__ ids,
                const int* __restrict__ cnt, const float* __restrict__ rays,
                const float* __restrict__ t_limit, const float* __restrict__ tfq,
                int* __restrict__ occ_out, int nsub) {
  __shared__ __align__(16) float slab[kSlab];
  const int g = blockIdx.x;
  const int ray = g * kRays + threadIdx.x;
  const float eps = eps_p[0];
  const float tlim = t_limit[ray];
  float rf[kFeat];
  load_ray(rf, rays, ray);

  bool occ = false;
  const int n = cnt[g];
  for (int k = 0; k < n; ++k) {
    const int jb = ids[(size_t)g * nsub + k];
    load_slab(slab, tfq, jb);
    __syncthreads();
    for (int c = 0; c < kSub && !occ; c += 4) {
      const Quad q = contract4(rf, slab, c);
      const float dets[4] = {q.det.x, q.det.y, q.det.z, q.det.w};
      const float tns[4] = {q.tn.x, q.tn.y, q.tn.z, q.tn.w};
      const float uns[4] = {q.un.x, q.un.y, q.un.z, q.un.w};
      const float vns[4] = {q.vn.x, q.vn.y, q.vn.z, q.vn.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t;
        occ |= accept(dets[j], tns[j], uns[j], vns[j], eps, t) && t < tlim;
      }
    }
    // Barrier before the next copy; the whole group stops once every ray
    // is occluded (an OR cannot change after that).
    if (__syncthreads_and(occ)) break;
  }
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

extern "C" {

int rt_mxu_search(const float* eps, const int* ids, const int* cnt, const float* rays,
                  const float* tfq, float* t_out, int* idx_out, int groups, int nsub,
                  void* stream) {
  if (groups > 0) {
    mxu_search_kernel<<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, ids, cnt, rays, tfq, t_out, idx_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_mxu_occl(const float* eps, const int* ids, const int* cnt, const float* rays,
                const float* t_limit, const float* tfq, int* occ_out, int groups,
                int nsub, void* stream) {
  if (groups > 0) {
    mxu_occl_kernel<<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, ids, cnt, rays, t_limit, tfq, occ_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
