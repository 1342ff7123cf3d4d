// mxtile closest-hit (K1) and any-hit (K2) kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels esctp1raytracer_tpu/kernels/rt_mxu.py:
// _mxu_kernel (K1) and _mxu_occl_kernel (K2), together with what feeds them
// there: the cull pre-pass _prep_mxu (a slab test of every ray against every
// 128-triangle block box, compacted into per-group lists in device memory,
// plus the [G, 128, 16] ray-feature rows) and, for K2, the tensor-op sweep of
// the oversized triangles (rt_tile.py:_oversized_occl). As on the TPU, one
// CUDA block is one 128-ray group (there the M = 128 rows of a [128, 16] @
// [16, 512] contraction per listed block), here one thread per ray:
//
// 1. Cull. Each thread slab-tests its own ray against every box of the
//    segment (NSUB <= 256, staged in shared memory) with slab_cull.cuh, which
//    is kernels/cull.py:block_cull_mask bit for bit (t_limit +inf where the
//    caller has none). A warp votes per box (__any_sync) and ORs its words
//    into 8 shared words, so the list is the union over the group's 128 rays,
//    as _prep_mxu's is: K1 never clamps t to t_limit, so a block kept for a
//    neighbour can still give a ray its hit. The set bits, walked in
//    ascending order, are _prep_mxu's list in its order. With cnt_out the
//    kept count per group is written out, to hold it against _prep_mxu's cnt.
// 2. Skip. A kept block whose box is inverted holds only dropped triangles
//    (zero feature columns, which |det| >= eps rejects): it is counted, not
//    swept. The output is unchanged.
// 3. Features in registers, formed from o and d: each o_i d_j is one rounded
//    product, as core/intersect.py:ray_features gives it.
// 4. Contract only what can be non-zero. By core/intersect.py:tri_features,
//    25 of the 64 coefficients of a triangle's [16, 4] column can be non-zero:
//    det rows 0-2 (-n); t*det rows 3-5 (n) and 15 (-v0.n); u*det and v*det
//    rows 0-2 (v0 x e2, -v0 x e1) and the off-diagonal o_i d_j rows 7-9 and
//    11-13 (the eps-cross matrix has a zero diagonal). Every other one is an
//    exact zero, and dropping fmaf(r, +-0, acc) leaves acc unchanged for a
//    finite r, unless acc is itself zero, and then only its sign: a zero det,
//    t*det, u*det or v*det fails the window either way, so the outputs are
//    those of the full 64-FMA contraction. Each quantity's FMAs run in
//    ascending feature order. Only those 25 row segments of a block's
//    [16, 512] slab are staged in shared memory (12.8 KB of 32 KB), with
//    cp.async into two buffers: the next listed block streams in while the
//    current one is swept.
// 5. Window, as the TPU kernel: t = t*det * (1 / det), u and v alike;
//    accept on |det| >= eps, u >= eps, v >= eps, u + v <= 1, t >= eps (K2:
//    and t < t_limit).
//
// K2 also tests every ray against one extra sub-block `ov` when the caller
// passes one: the [16, 128] plane constants (rt_tile.py:_pack_sub) of the
// oversized triangles that the occlusion tables exclude, with
// lane_plane.cuh:plane_hit, skipping its empty 32-slot runs. A ray stops once
// it is occluded or cannot be (t_limit <= eps), and the group once all its
// rays have: an OR cannot change after that. A group that no ray of can be
// occluded skips the cull too, unless it is counted.
//
// The JAX package's other pre-pass modes (rt_mxu.py: CULL_MODE) are other
// instantiations of the same kernels, whose cull (cull_mode) lists the
// blocks of the plain version's lists in their order and writes its count:
// "exact" (argsort's blocks, but every block above cull.py's
// CULL_EXTRACT_K = 32 kept ones) and "interval" (one group_cull_mask test
// per box for the whole 128-ray group, slab_cull.cuh:interval_keep, with
// exact's fallback). The default (argsort) instantiation runs cull, the
// code the kernels had before the modes existed.
//
// Tie rule (K1): each thread visits its blocks in ascending order and the
// columns of a block in ascending order, and keeps a hit only on a strict
// t < best: the minimum t, ties to the lowest sorted triangle index.
//
// What bounds it on the H100: float32 instruction throughput. Per (ray,
// triangle) pair of a swept block, 25 FMAs, about 6 shared float4 loads
// (broadcasts: every thread of the block reads the same address) and the
// window, whose IEEE division (a reciprocal, its refinement and a range
// check) is after the FMAs its largest part; per (ray, box) the slab test.
// On the 1080p flagship's camera wavefront that is ~41 G operations, ~0.6 ms
// at the 67 TFLOP/s float32 peak. Memory is not the limit: the rays are read
// once and written once, and the table (2.7 MB for the flagship) stays in
// the 50 MB L2. The design keeps lists, features and counts out of device
// memory, drops 39 of 64 FMAs and the padding-only blocks, and overlaps each
// block's copy with the sweep before it. No tensor cores: TF32 or bf16
// inputs flip winners and shadow tests (the JAX package measured bf16x3
// doing so), so the products stay in float32.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false (never -use_fast_math: the window
//          needs IEEE 1/det; -fmad=false makes K2's plane test round every
//          product and sum on its own, as the plain version does; the
//          contraction's fmaf calls are explicit and unaffected). C
// interface, loaded with ctypes; every entry point launches on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "lane_plane.cuh"
#include "slab_cull.cuh"

namespace {

constexpr int kRays = 128;            // rays per group = threads per block
constexpr int kSub = 128;             // triangles per block
constexpr int kCols = 4 * kSub;       // det | t*det | u*det | v*det
constexpr int kSlab = 16 * kCols;     // floats per block of the table
constexpr int kMaxSub = 256;          // blocks per segment (MXU_TRI_LIMIT / kSub)
constexpr int kWords = kMaxSub / 32;  // kept-box words per group
constexpr int kRayW = 8;              // floats per ray: o, d, t_limit, pad
constexpr int kSegs = 25;             // staged row segments of kSub columns
constexpr int kStage = kSegs * kSub;  // floats per staged block (12.8 KB)
constexpr int kOvRows = 13;           // the oversized sub-block's constants and keep row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kExtractK = 32;         // cull.py:CULL_EXTRACT_K
// The pre-pass modes of rt_mxu.py:_prep_mxu (CULL_MODE): argsort, exact
// (argsort's set; more than kExtractK kept blocks: every block) and
// interval (cull.py:group_cull_mask over the 128-ray group, one test per
// box, with exact's fallback).
enum Mode { kArgsort = 0, kExact = 1, kInterval = 2 };
constexpr int kRedVals = 13;  // the group's o and d minima and maxima, its largest t_limit

// Where each staged segment starts in a block's [16, 512] slab (row * 512 +
// quantity * 128), in the order det rows 0-2 | t*det rows 3, 4, 5, 15 |
// u*det rows 0-2, 7-9, 11-13 | v*det the same rows.
#define SEG(row, q) ((row) * kCols + (q) * kSub)
__constant__ int kSegSrc[kSegs] = {
    SEG(0, 0),  SEG(1, 0),  SEG(2, 0),                                          // det
    SEG(3, 1),  SEG(4, 1),  SEG(5, 1),  SEG(15, 1),                             // t*det
    SEG(0, 2),  SEG(1, 2),  SEG(2, 2),  SEG(7, 2),  SEG(8, 2),  SEG(9, 2),      // u*det
    SEG(11, 2), SEG(12, 2), SEG(13, 2),
    SEG(0, 3),  SEG(1, 3),  SEG(2, 3),  SEG(7, 3),  SEG(8, 3),  SEG(9, 3),      // v*det
    SEG(11, 3), SEG(12, 3), SEG(13, 3),
};
#undef SEG

struct __align__(16) Shared {
  float stage[2][kStage];  // two staged blocks (K2: buffer 1 holds `ov` first)
  float box[6 * kMaxSub];  // rows 0-5 of the segment's boxes, [6, NSUB]
  unsigned keep[kWords];   // boxes that some ray of the group keeps
  unsigned pad[kWords];    // inverted boxes: padding only
  int list[kMaxSub];       // kept boxes that are not padding, ascending
};

struct Ray {
  Vec o, d;
  float tl;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int ray) {
  const float4* p = reinterpret_cast<const float4*>(rays + static_cast<size_t>(ray) * kRayW);
  const float4 a = p[0], b = p[1];
  return Ray{Vec{a.x, a.y, a.z}, Vec{a.w, b.x, b.y}, b.z};
}

// The ray features that meet a non-zero coefficient: d (rows 0-2), o (rows
// 3-5; row 15 is 1) and the off-diagonal o_i d_j (rows 7-9, 11-13).
struct Features {
  float d[3], o[3], od[6];
};

__device__ __forceinline__ Features features(const Ray& r) {
  return Features{{r.d.x, r.d.y, r.d.z},
                  {r.o.x, r.o.y, r.o.z},
                  {r.o.x * r.d.y, r.o.x * r.d.z, r.o.y * r.d.x, r.o.y * r.d.z, r.o.z * r.d.x,
                   r.o.z * r.d.y}};
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying block jb's 25 segments into dst (one cp.async group).
__device__ __forceinline__ void stage_block(float* dst, const float* __restrict__ tfq, int jb) {
  const float* src = tfq + static_cast<size_t>(jb) * kSlab;
  for (int i = threadIdx.x; i < kSegs * (kSub / 4); i += kRays) {
    const int s = i / (kSub / 4), e = (i % (kSub / 4)) * 4;
    cp_async16(dst + s * kSub + e, src + kSegSrc[s] + e);
  }
  cp_async_commit();
}

// Steps 1-2. Fills sh.keep, sh.pad and sh.list; returns (the kept count,
// inverted boxes included; the number of blocks to sweep), the same for
// every thread of the group.
__device__ __forceinline__ int2 cull(Shared& sh, const float* __restrict__ aabbs, int nsub,
                                     const Ray& r) {
  for (int i = threadIdx.x; i < 6 * nsub; i += kRays) sh.box[i] = __ldg(aabbs + i);
  if (threadIdx.x < kWords) sh.keep[threadIdx.x] = sh.pad[threadIdx.x] = 0u;
  __syncthreads();
  const Vec inv{1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};  // IEEE; inf on a zero
  for (int g = 0; g * 32 < nsub; ++g) {
    const int n = min(32, nsub - g * 32);
    unsigned word = 0;
    for (int k = 0; k < n; ++k) {
      const int j = g * 32 + k;
      const Vec lo{sh.box[j], sh.box[nsub + j], sh.box[2 * nsub + j]};
      const Vec hi{sh.box[3 * nsub + j], sh.box[4 * nsub + j], sh.box[5 * nsub + j]};
      word |= (__any_sync(kFull, slab_keep(r.o, inv, r.tl, lo, hi)) ? 1u : 0u) << k;
    }
    if ((threadIdx.x & 31) == 0 && word) atomicOr(&sh.keep[g], word);
  }
  for (int j = threadIdx.x; j < nsub; j += kRays) {
    if (sh.box[j] > sh.box[3 * nsub + j] || sh.box[nsub + j] > sh.box[4 * nsub + j] ||
        sh.box[2 * nsub + j] > sh.box[5 * nsub + j]) {
      atomicOr(&sh.pad[j / 32], 1u << (j % 32));
    }
  }
  __syncthreads();
  int kept = 0, swept = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int n = __popc(sh.keep[w] & ~sh.pad[w]);
    kept += __popc(sh.keep[w]);
    before += w < static_cast<int>(threadIdx.x) ? n : 0;
    swept += n;
  }
  if (threadIdx.x < kWords) {  // thread w lists word w's blocks after those of words < w
    for (unsigned w = sh.keep[threadIdx.x] & ~sh.pad[threadIdx.x]; w; w &= w - 1) {
      sh.list[before++] = threadIdx.x * 32 + __ffs(w) - 1;
    }
  }
  __syncthreads();
  return make_int2(kept, swept);
}

// group_cull_mask's bounds of this block's 128 rays (every thread gets them):
// a butterfly per warp, then the 4 warps' values folded through the first
// stage buffer, which nothing uses before the walk. Minima and maxima are
// exact, so the order does not matter.
__device__ __forceinline__ Interval group_interval(Shared& sh, const Ray& r) {
  float (*red)[kRedVals] = reinterpret_cast<float (*)[kRedVals]>(sh.stage[0]);
  float v[kRedVals] = {r.o.x, r.o.y, r.o.z, r.o.x, r.o.y, r.o.z,
                       r.d.x, r.d.y, r.d.z, r.d.x, r.d.y, r.d.z, r.tl};
#pragma unroll
  for (int off = 16; off; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kRedVals; ++i) {
      const float w = __shfl_xor_sync(kFull, v[i], off);
      const bool lo = i < 3 || (i >= 6 && i < 9);  // o_lo, d_lo: minima; the rest maxima
      v[i] = lo ? nan_min(v[i], w) : nan_max(v[i], w);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kRedVals; ++i) red[threadIdx.x >> 5][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kRays / 32; ++w) {
#pragma unroll
    for (int i = 0; i < kRedVals; ++i) {
      const bool lo = i < 3 || (i >= 6 && i < 9);
      v[i] = lo ? nan_min(v[i], red[w][i]) : nan_max(v[i], red[w][i]);
    }
  }
  const float o_lo[3] = {v[0], v[1], v[2]}, o_hi[3] = {v[3], v[4], v[5]};
  const float d_lo[3] = {v[6], v[7], v[8]}, d_hi[3] = {v[9], v[10], v[11]};
  return make_interval(o_lo, o_hi, d_lo, d_hi, v[12]);
}

// cull() in exact or interval mode (kMode): the same steps and results, but
// interval mode tests each box once for the group, and more than kExtractK
// kept blocks keep every block (the count is then NSUB).
template <int kMode>
__device__ __forceinline__ int2 cull_mode(Shared& sh, const float* __restrict__ aabbs, int nsub,
                                          const Ray& r) {
  for (int i = threadIdx.x; i < 6 * nsub; i += kRays) sh.box[i] = __ldg(aabbs + i);
  if (threadIdx.x < kWords) sh.keep[threadIdx.x] = sh.pad[threadIdx.x] = 0u;
  __syncthreads();
  if constexpr (kMode == kInterval) {
    const Interval iv = group_interval(sh, r);
    for (int j = threadIdx.x; j < nsub; j += kRays) {
      const Vec lo{sh.box[j], sh.box[nsub + j], sh.box[2 * nsub + j]};
      const Vec hi{sh.box[3 * nsub + j], sh.box[4 * nsub + j], sh.box[5 * nsub + j]};
      if (interval_keep(iv, lo, hi)) atomicOr(&sh.keep[j / 32], 1u << (j % 32));
    }
  } else {
    const Vec inv{1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};  // IEEE; inf on a zero
    for (int g = 0; g * 32 < nsub; ++g) {
      const int n = min(32, nsub - g * 32);
      unsigned word = 0;
      for (int k = 0; k < n; ++k) {
        const int j = g * 32 + k;
        const Vec lo{sh.box[j], sh.box[nsub + j], sh.box[2 * nsub + j]};
        const Vec hi{sh.box[3 * nsub + j], sh.box[4 * nsub + j], sh.box[5 * nsub + j]};
        word |= (__any_sync(kFull, slab_keep(r.o, inv, r.tl, lo, hi)) ? 1u : 0u) << k;
      }
      if ((threadIdx.x & 31) == 0 && word) atomicOr(&sh.keep[g], word);
    }
  }
  for (int j = threadIdx.x; j < nsub; j += kRays) {
    if (sh.box[j] > sh.box[3 * nsub + j] || sh.box[nsub + j] > sh.box[4 * nsub + j] ||
        sh.box[2 * nsub + j] > sh.box[5 * nsub + j]) {
      atomicOr(&sh.pad[j / 32], 1u << (j % 32));
    }
  }
  __syncthreads();
  int listed = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) listed += __popc(sh.keep[w]);
  if (listed > kExtractK) {  // the dense fallback: every block
    __syncthreads();  // every thread has counted before the words change
    if (threadIdx.x < kWords) {
      const int left = nsub - 32 * static_cast<int>(threadIdx.x);
      sh.keep[threadIdx.x] = left >= 32 ? kFull : left > 0 ? (1u << left) - 1u : 0u;
    }
    __syncthreads();
  }
  int kept = 0, swept = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int n = __popc(sh.keep[w] & ~sh.pad[w]);
    kept += __popc(sh.keep[w]);
    before += w < static_cast<int>(threadIdx.x) ? n : 0;
    swept += n;
  }
  if (threadIdx.x < kWords) {  // thread w lists word w's blocks after those of words < w
    for (unsigned w = sh.keep[threadIdx.x] & ~sh.pad[threadIdx.x]; w; w &= w - 1) {
      sh.list[before++] = threadIdx.x * 32 + __ffs(w) - 1;
    }
  }
  __syncthreads();
  return make_int2(kept, swept);
}

// The four quantities for columns c..c+3 of a staged block.
struct Quad {
  float4 det, tn, un, vn;
};

__device__ __forceinline__ void fma4(float4& acc, float r, const float* st, int s, int c) {
  const float4 x = *reinterpret_cast<const float4*>(st + s * kSub + c);
  acc.x = fmaf(r, x.x, acc.x);
  acc.y = fmaf(r, x.y, acc.y);
  acc.z = fmaf(r, x.z, acc.z);
  acc.w = fmaf(r, x.w, acc.w);
}

// Step 4: the 25 FMAs of each of the 4 columns, in ascending feature order
// per quantity (segment s of the staged block as in kSegSrc).
__device__ __forceinline__ Quad contract(const Features& f, const float* st, int c) {
  Quad q;
  q.det = q.tn = q.un = q.vn = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) fma4(q.det, f.d[i], st, i, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) fma4(q.tn, f.o[i], st, 3 + i, c);
  fma4(q.tn, 1.0f, st, 6, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fma4(q.un, f.d[i], st, 7 + i, c);
    fma4(q.vn, f.d[i], st, 16 + i, c);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    fma4(q.un, f.od[i], st, 10 + i, c);
    fma4(q.vn, f.od[i], st, 19 + i, c);
  }
  return q;
}

// Step 5, the acceptance window; writes the hit distance to t.
__device__ __forceinline__ bool accept(float det, float tn, float un, float vn, float eps,
                                       float& t) {
  const float inv = 1.0f / det;  // IEEE division (no fast math)
  t = tn * inv;
  const float u = un * inv;
  const float v = vn * inv;
  return fabsf(det) >= eps && u >= eps && v >= eps && u + v <= 1.0f && t >= eps;
}

// fn(det, t*det, u*det, v*det, column) for the 4 columns at c.
template <typename Fn>
__device__ __forceinline__ void quad(const Features& f, const float* st, int c, Fn fn) {
  const Quad q = contract(f, st, c);
  fn(q.det.x, q.tn.x, q.un.x, q.vn.x, c);
  fn(q.det.y, q.tn.y, q.un.y, q.vn.y, c + 1);
  fn(q.det.z, q.tn.z, q.un.z, q.vn.z, c + 2);
  fn(q.det.w, q.tn.w, q.un.w, q.vn.w, c + 3);
}

// Walk the group's n listed blocks, ascending, double-buffered: sweep(jb,
// staged block) for each, until it returns true for every thread.
template <typename Fn>
__device__ __forceinline__ void walk(Shared& sh, const float* __restrict__ tfq, int n, Fn sweep) {
  if (n > 0) stage_block(sh.stage[0], tfq, sh.list[0]);
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      stage_block(sh.stage[(k + 1) & 1], tfq, sh.list[k + 1]);
      cp_async_wait<1>();  // block k has landed; block k + 1 may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool done = sweep(sh.list[k], sh.stage[k & 1]);
    // Every thread is done with buffer k & 1 before block k + 2 is copied there.
    if (__syncthreads_and(done)) break;
  }
  cp_async_wait<0>();  // nothing in flight past an early exit
}

template <int kMode>
__global__ void __launch_bounds__(kRays)
mxu_search_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                  const float* __restrict__ aabbs, const float* __restrict__ tfq,
                  float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ cnt_out,
                  int nsub) {
  __shared__ Shared sh;
  const int ray = blockIdx.x * kRays + threadIdx.x;
  const Ray r = load_ray(rays, ray);
  int2 n;
  if constexpr (kMode == kArgsort) {
    n = cull(sh, aabbs, nsub, r);
  } else {
    n = cull_mode<kMode>(sh, aabbs, nsub, r);
  }
  if (cnt_out != nullptr && threadIdx.x == 0) cnt_out[blockIdx.x] = n.x;
  const float eps = eps_p[0];
  const Features f = features(r);
  float bt = kBig;
  int bi = -1;
  walk(sh, tfq, n.y, [&](int jb, const float* st) {
    for (int c = 0; c < kSub; c += 4) {
      quad(f, st, c, [&](float det, float tn, float un, float vn, int col) {
        float t;
        if (accept(det, tn, un, vn, eps, t) && t < bt) {  // strict: ascending visits
          bt = t;
          bi = jb * kSub + col;
        }
      });
    }
    return false;
  });
  t_out[ray] = bt;
  idx_out[ray] = bt < kBig ? bi : -1;
}

template <int kMode>
__global__ void __launch_bounds__(kRays)
mxu_occl_kernel(const float* __restrict__ eps_p, const float* __restrict__ rays,
                const float* __restrict__ aabbs, const float* __restrict__ tfq,
                const float* __restrict__ ov, int* __restrict__ occ_out,
                int* __restrict__ cnt_out, int nsub) {
  __shared__ Shared sh;
  const int ray = blockIdx.x * kRays + threadIdx.x;
  const Ray r = load_ray(rays, ray);
  const float eps = eps_p[0];
  bool occ = false;
  bool done = !(r.tl > eps);  // no t with eps <= t < t_limit: cannot be occluded
  int2 n = make_int2(0, 0);
  // cnt_out is the same for the whole group, so every thread takes the same branch.
  if (cnt_out != nullptr || !__syncthreads_and(done)) {
    if constexpr (kMode == kArgsort) {
      n = cull(sh, aabbs, nsub, r);
    } else {
      n = cull_mode<kMode>(sh, aabbs, nsub, r);
    }
    if (cnt_out != nullptr && threadIdx.x == 0) cnt_out[blockIdx.x] = n.x;
  }
  if (ov != nullptr && !__syncthreads_and(done)) {
    float* c = sh.stage[1];
    for (int i = threadIdx.x; i < kOvRows * kSub / 4; i += kRays) cp_async16(c + 4 * i, ov + 4 * i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int run = 0; run < kSub / 32; ++run) {
      // A run of 32 slots with no triangle (keep row 12 all zero) is skipped.
      if (!__any_sync(kFull, c[12 * kSub + run * 32 + (threadIdx.x & 31)] != 0.0f)) continue;
      for (int j = run * 32; j < run * 32 + 32 && !done; ++j) {
        float k[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) k[i] = c[i * kSub + j];
        float t;
        if (plane_hit(k, r.o, r.d, eps, t) && t < r.tl) occ = done = true;
      }
    }
    __syncthreads();  // every thread is done with buffer 1 before the walk copies there
  }
  const Features f = features(r);
  walk(sh, tfq, __syncthreads_and(done) ? 0 : n.y, [&](int, const float* st) {
    for (int c = 0; c < kSub && !done; c += 4) {
      quad(f, st, c, [&](float det, float tn, float un, float vn, int) {
        float t;
        occ |= accept(det, tn, un, vn, eps, t) && t < r.tl;
      });
      done = occ;
    }
    return done;
  });
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

extern "C" {

int rt_mxu_search(const float* eps, const float* rays, const float* aabbs, const float* tfq,
                  float* t_out, int* idx_out, int* cnt_out, int groups, int nsub, void* stream) {
  if (nsub > kMaxSub) return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 0) {
    mxu_search_kernel<kArgsort><<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, rays, aabbs, tfq, t_out, idx_out, cnt_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_mxu_occl(const float* eps, const float* rays, const float* aabbs, const float* tfq,
                const float* ov, int* occ_out, int* cnt_out, int groups, int nsub,
                void* stream) {
  if (nsub > kMaxSub) return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 0) {
    mxu_occl_kernel<kArgsort><<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
        eps, rays, aabbs, tfq, ov, occ_out, cnt_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

// The other pre-pass modes: `mode` a Mode other than kArgsort (whose
// instantiations rt_mxu_search and rt_mxu_occl launch).
int rt_mxu_search_mode(const float* eps, const float* rays, const float* aabbs, const float* tfq,
                       float* t_out, int* idx_out, int* cnt_out, int groups, int nsub, int mode,
                       void* stream) {
  if (nsub > kMaxSub || (mode != kExact && mode != kInterval)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups > 0) {
    auto kernel = mode == kExact ? mxu_search_kernel<kExact> : mxu_search_kernel<kInterval>;
    kernel<<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(eps, rays, aabbs, tfq, t_out,
                                                                    idx_out, cnt_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_mxu_occl_mode(const float* eps, const float* rays, const float* aabbs, const float* tfq,
                     const float* ov, int* occ_out, int* cnt_out, int groups, int nsub, int mode,
                     void* stream) {
  if (nsub > kMaxSub || (mode != kExact && mode != kInterval)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups > 0) {
    auto kernel = mode == kExact ? mxu_occl_kernel<kExact> : mxu_occl_kernel<kInterval>;
    kernel<<<groups, kRays, 0, static_cast<cudaStream_t>(stream)>>>(eps, rays, aabbs, tfq, ov,
                                                                    occ_out, cnt_out, nsub);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rt_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
