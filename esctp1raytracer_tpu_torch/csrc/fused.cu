// Fused whole-frame kernel (K3) and its table build for Hopper (sm_90a):
// scene and rays in, colors out, in two launches.
//
// Replaces the TPU Pallas kernel esctp1raytracer_tpu/kernels/fused_pallas.py:
// _make_kernel (the inner `kernel`, launched by _fused_call), and what feeds
// it there, fused_tables (XLA operations: padding, build_clusters' Morton
// sort and median, lane_tri_constants, the attribute rows).
//
// fused_tables_kernel, one block of 1024 threads (N <= 2048): pads the
// triangles to a multiple of 128, computes the centroids' 30-bit Morton
// codes and the median of the valid triangles' squared AABB diagonals,
// builds the keys [normal | oversized | invalid], sorts (key, index) with a
// bitonic sort in shared memory (stable: the index breaks ties), gathers the
// sorted rows, and writes the 13 constants and the 32-float attribute row
// per triangle, the chunk AABBs (an all-invalid chunk keeps its inverted
// box), the sphere rows, the light corners (original order), the light
// counts and n_tris. Every value is rounded as the plain tensor-op version
// rounds it on the CPU: one fmaf per cross-product component, 3-term sums as
// (x + y) + z, IEEE division, -fmad=false for the rest. So the tables equal
// the CPU's, and the JAX package's, bit for bit.
//
// fused_frame_kernel computes what the TPU kernel computes, reshaped for the
// card: one thread per ray, the ray's state (origin, direction, throughput,
// active flag, accumulated color) in registers across up to 4 Whitted
// bounces. The blocks are persistent: each loads the tables into dynamic
// shared memory once, with asynchronous copies (cp.async): the constants of
// the valid prefix as 12-float rows (16-byte aligned, so a thread reads a
// triangle with three vector loads; the sweep does not read the valid
// flag), the sphere, light-corner and chunk-box tables beside them (103 KB
// at the limits). Then each of its warps walks 32-ray tiles with a grid
// stride, on its own: no block barrier after the load. Per bounce, per warp:
//
//   1. chunk cull: each masked lane tests its own ray against the G <= 16
//      chunk AABBs of 128 Morton-sorted triangles (slab_cull.cuh's slab
//      test, each box grown by a margin), and the warp ORs the lanes' bit
//      masks; the kept set is that mask in a register, walked in ascending
//      bit order. (The TPU kernel's interval hull of a ray tile keeps
//      nearly every chunk once reflected rays scatter: on config 4 the
//      kernel reads 2.10 ms with it against 0.91 ms with this cull;
//      scripts/probe_k3k4.py, on the H100);
//   2. closest hit: each kept chunk's constants (shared memory, broadcast
//      reads) in ascending order, keeping (t, index) on strict < (the lane
//      search), each pair through lane_plane.cuh's exact division skip
//      (which saves no time here: the lanes of a warp disagree, and without
//      it the kernel reads 0.84 ms on config 4); then the spheres, also on
//      strict <; triangles win ties against spheres;
//   3. the winner's 32-float attribute row, read straight from device
//      memory, the Möller–Trumbore recompute of t/u/v, the hit point backed
//      off by shadow_eps, the shading normal;
//   4. per light: the murmur3 counter draws of utils/rng.py in native
//      uint32, the sampled point on the drawn face, the warp's cull of its
//      shadow rays (mask: active & hit & d.n > 0, ceiling t_limit), an
//      any-hit sweep of the kept chunks that stops once every masked ray of
//      the warp is occluded (__all_sync), the spheres, and the Phong term.
//      This sweep tests its pairs without the division skip: each lane
//      already leaves it at its own first occluder, and the skip's branch on
//      top of that cost more than the divisions it saved (14% of the
//      kernel's time on config 4; scripts/probe_k3k4.py, on the H100);
//   5. the reflected ray for the next bounce; a warp whose rays have all
//      died stops.
//
// The cull is conservative (a culled chunk holds no accepted hit of a masked
// ray, and rays outside the mask contribute nothing), and the list stays
// ascending, so any group of rays gives the colors of the TPU's 1024-ray
// tile. An accepted hit lies inside its triangle, so inside the chunk's box
// up to the rounding of the hit point; the margin, 1e-4 of the box's
// largest coordinate (at least 1e-4), is orders above that rounding, so the
// slab test keeps every box that holds an accepted hit. As on the TPU:
// all-invalid chunks (inverted boxes) are dropped explicitly, each chunk's
// sweep is clamped to n_tris (invalid triangles sort last), and with
// G == 1 the single chunk is swept without a test.
//
// What bounds it on the H100: arithmetic in the sweeps, 40 float32
// operations per (ray, triangle) pair with one IEEE division, or 16 where
// the division skip rejects the pair. -fmad=false (no FMAs) caps it at half
// of a float32 bound taken at 67 TFLOP/s. The table crosses from L2 once
// per resident block, not once per chunk and sweep, and no cull or copy
// takes a block barrier. No tensor cores.
//
// Precision: IEEE division and sqrtf, expf(ns * logf(x)) for the specular
// power (no fast math), rsqrtf for normalisations, and -fmad=false: every
// product and sum rounds on its own, in the plain PyTorch version's order,
// so the two agree to the last ulp but for the math functions. With nvcc's
// default contraction into FMAs, last-ulp differences in the reflected
// directions grew over four bounces to 9e-5 on highlights of the depth-4
// mixed scene, past the 3e-5 bar of tests/test_fused.py.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false. C interface, loaded with ctypes;
// the entry points launch on the caller's stream and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_plane.cuh"  // Vec, plane_t4, plane_t_skip, row12, tri_constants, kTcsW
#include "slab_cull.cuh"   // slab_keep

// The table build's arguments (fused_pallas._TableArgs): the scene's leaves
// (original order, `cap` triangles), the outputs, the sizes. At namespace
// scope, so that the C entry point that takes it keeps external linkage.
struct TableArgs {
  const float *v0, *v1, *v2, *n0, *n1, *n2, *ka, *kd, *ks, *ke, *ns;
  const uint8_t *has_n, *valid;
  const float *s_center, *s_radius, *s_ka, *s_kd, *s_ks, *s_ke, *s_ns;
  const uint8_t* s_valid;
  const int *tri_idx, *face_count;
  float *tcs, *shad, *sph, *lc, *cab;
  int *counts, *n_tris;
  int cap, S, L, F;
};

namespace {

constexpr int kThreads = 256;  // threads per block of the frame kernel
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // FUSED_CHUNK triangles per chunk
constexpr int kShadW = 32;
constexpr int kSphW = 18;
constexpr int kMaxN = 2048;  // FUSED_TRI_LIMIT
constexpr int kMaxS = 32;    // FUSED_SPHERE_LIMIT
constexpr int kMaxLF = 64;   // FUSED_LIGHT_FACE_LIMIT
constexpr int kMaxG = kMaxN / kChunk;
constexpr int kRowW = 12;  // floats per triangle in shared memory (no valid flag)
constexpr int kMaxSmem = 4 * (kMaxN * kRowW + kMaxS * kSphW + kMaxLF * 9 + kMaxG * 6);
constexpr float kMargin = 1e-4f;  // the chunk boxes' growth, relative
constexpr float kTiny = 1e-12f;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// uniform01 of utils/rng.py for stream s: h0 = fmix(id ^ (seed + GOLDEN)).
__device__ __forceinline__ float uniform(uint32_t h0, uint32_t s) {
  const uint32_t bits = fmix(h0 ^ (s * kC1 + kGolden));
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ Vec sub(Vec a, Vec b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(Vec a, Vec b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ Vec cross(Vec a, Vec b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ Vec scale(Vec a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ Vec unit(Vec a) { return scale(a, rsqrtf(fmaxf(dot(a, a), kTiny))); }
__device__ __forceinline__ Vec load3(const float* __restrict__ p, int i) {
  return Vec{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// The analytic sphere test of the TPU kernel (sphere_t); BIG on a miss.
__device__ __forceinline__ float sphere_t(const float* s, Vec o, Vec d, float eps) {
  const Vec oc = sub(o, Vec{s[0], s[1], s[2]});
  const float b = dot(oc, d);
  const float c0 = dot(oc, oc) - s[3] * s[3];
  const float disc = b * b - c0;
  const float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float tn = -b - sq;
  const float t = tn >= eps ? tn : -b + sq;
  return (disc >= 0.0f && t >= eps && s[4] > 0.5f) ? t : kBig;
}

// ---- the frame kernel ------------------------------------------------------

// The chunks the warp's masked rays can reach, as a bit mask (bit g for
// chunk g): each masked lane tests its own ray, within t_limit `tl`,
// against the non-empty (grown) boxes, and the warp ORs the lanes' masks.
// Every lane of the warp calls it.
__device__ __forceinline__ unsigned warp_cull(const float* cab, int G, bool mask, Vec o, Vec d,
                                              float tl) {
  unsigned keep = 0;
  if (mask) {
    if (G == 1) {
      keep = cab[0] <= cab[3] ? 1u : 0u;
    } else {
      const Vec inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
      for (int g = 0; g < G; ++g) {
        const float* b = cab + 6 * g;
        if (b[0] <= b[3] && slab_keep(o, inv, tl, Vec{b[0], b[1], b[2]}, Vec{b[3], b[4], b[5]}))
          keep |= 1u << g;
      }
    }
  }
  return __reduce_or_sync(kFull, keep);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
fused_frame_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
                   const int64_t* __restrict__ ids, const float* __restrict__ tcs,
                   const float* __restrict__ shad, const float* __restrict__ sph,
                   const float* __restrict__ lc, const float* __restrict__ cab,
                   const int* __restrict__ counts, const int* __restrict__ n_tris_p,
                   float* __restrict__ out, int rays, int N, int S, int L, int F, int G,
                   int depth, uint32_t s0, float eps, float sh_eps) {
  extern __shared__ __align__(16) float tab[];  // [n_tris, 12]
  float* s_sph = tab + N * kRowW;
  float* s_lc = s_sph + S * kSphW;
  float* s_cab = s_lc + L * F * 9;

  // ---- the tables, once per block ---------------------------------------
  const int n_tris = n_tris_p[0];
  for (int k = threadIdx.x; k < n_tris * kRowW; k += kThreads) {
    const int i = k / kRowW;
    cp_async4(tab + k, tcs + i * kTcsW + (k - i * kRowW));
  }
  for (int i = threadIdx.x; i < S * kSphW; i += kThreads) cp_async4(s_sph + i, sph + i);
  for (int i = threadIdx.x; i < L * F * 9; i += kThreads) cp_async4(s_lc + i, lc + i);
  if (threadIdx.x < G) {  // the chunk box, grown by the margin (empty ones stay inverted)
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = cab[6 * threadIdx.x + k];
    float m = 1.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) m = fmaxf(m, fabsf(b[k]));
    m = b[0] <= b[3] ? kMargin * m : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_cab[6 * threadIdx.x + k] = b[k] - m;
      s_cab[6 * threadIdx.x + 3 + k] = b[3 + k] + m;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // ---- 32-ray tiles, one warp each, no block barrier from here on --------
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const float inf = __int_as_float(0x7f800000);  // the camera sweep's t_limit
  const float inv_l = 1.0f / static_cast<float>(L);
  for (int base = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32; base < rays;
       base += n_warps * 32) {
    const int ray = base + lane;
    bool active = ray < rays;  // lanes past the end stay inactive and write nothing
    Vec o{0.f, 0.f, 0.f}, d{0.f, 0.f, 1.f};
    uint32_t h0 = 0;
    if (active) {
      o = load3(o_in, ray);
      d = load3(d_in, ray);
      h0 = fmix(static_cast<uint32_t>(ids[ray]) ^ s0);  // the id's low 32 bits
    }
    Vec col{0.f, 0.f, 0.f}, thr{1.f, 1.f, 1.f};

    // Every shuffle, ballot and vote below is reached by all 32 lanes:
    // inactive lanes skip the arithmetic, never the warp-wide steps.
    for (int b = 0; b < depth; ++b) {
      if (!__any_sync(kFull, active)) break;  // every ray of the warp is done

      // ---- closest hit: the culled triangle chunks, then the spheres -----
      float bt = kBig;
      int bi = -1;
      for (unsigned kept = warp_cull(s_cab, G, active, o, d, inf); kept; kept &= kept - 1u) {
        const int c0 = (__ffs(kept) - 1) * kChunk;
        const int len = max(0, min(kChunk, n_tris - c0));
        if (active) {
          for (int i = 0; i < len; ++i) {
            const Row12 c = row12(tab, c0 + i);
            const float t = plane_t_skip(c.c0, c.c1, c.c2, o, d, eps);
            if (t < bt) {  // strict: ties to the lowest sorted index
              bt = t;
              bi = c0 + i;
            }
          }
        }
      }
      float bst = kBig;
      int bsi = -1;
      if (active) {
        for (int j = 0; j < S; ++j) {
          const float t = sphere_t(s_sph + j * kSphW, o, d, eps);
          if (t < bst) {
            bst = t;
            bsi = j;
          }
        }
      }
      const bool is_s = bst < bt;  // strict: triangles win ties
      const float bt_comb = is_s ? bst : bt;
      const bool hit = bt_comb < kBig;

      // ---- winner row, MT recompute, hit point and shading normal -------
      float row[kShadW];
#pragma unroll
      for (int k = 0; k < kShadW; ++k) row[k] = 0.0f;
      if (bi >= 0) {
        const float4* r4 =
            reinterpret_cast<const float4*>(shad + static_cast<size_t>(bi) * kShadW);
#pragma unroll
        for (int k = 0; k < kShadW / 4; ++k) {
          const float4 x = r4[k];
          row[4 * k] = x.x;
          row[4 * k + 1] = x.y;
          row[4 * k + 2] = x.z;
          row[4 * k + 3] = x.w;
        }
      }
      const Vec v0{row[0], row[1], row[2]};
      const Vec e1 = sub(Vec{row[3], row[4], row[5]}, v0);
      const Vec e2 = sub(Vec{row[6], row[7], row[8]}, v0);
      const Vec pv = cross(d, e2);
      const float det = dot(e1, pv);
      const bool ok_det = fabsf(det) >= eps;
      const float inv_det = ok_det ? 1.0f / det : 0.0f;
      const Vec tv = sub(o, v0);
      const float u_r = dot(tv, pv) * inv_det;
      const Vec qv = cross(tv, e1);
      const float v_r = dot(d, qv) * inv_det;
      float t_r = dot(e2, qv) * inv_det;
      const bool ok_r = ok_det && u_r >= eps && u_r <= 1.0f && v_r >= eps &&
                        u_r + v_r <= 1.0f && t_r >= eps;
      t_r = ok_r ? t_r : kBig;
      const float t_tri = t_r < kBig ? t_r : bt_comb;  // borderline: keep the search's t
      const float back = (hit ? (is_s ? bst : t_tri) : 1.0f) - sh_eps;
      const Vec hp = hit ? Vec{o.x + d.x * back, o.y + d.y * back, o.z + d.z * back}
                         : Vec{0.f, 0.f, 0.f};

      Vec nrm{0.f, 0.f, 0.f};
      Vec ka{row[19], row[20], row[21]}, kd{row[22], row[23], row[24]};
      Vec ks{row[25], row[26], row[27]}, ke{row[28], row[29], row[30]};
      float ns = row[31];
      if (is_s) {
        const float* s = s_sph + bsi * kSphW;
        const float inv_r = 1.0f / fmaxf(s[3], 1e-6f);
        nrm = Vec{(hp.x - s[0]) * inv_r, (hp.y - s[1]) * inv_r, (hp.z - s[2]) * inv_r};
        ka = Vec{s[5], s[6], s[7]};
        kd = Vec{s[8], s[9], s[10]};
        ks = Vec{s[11], s[12], s[13]};
        ke = Vec{s[14], s[15], s[16]};
        ns = s[17];
      } else if (hit) {
        if (row[18] > 0.5f) {  // smooth normals: barycentric blend
          const float w = 1.0f - u_r - v_r;
          nrm = unit(Vec{row[12] * u_r + row[15] * v_r + row[9] * w,
                         row[13] * u_r + row[16] * v_r + row[10] * w,
                         row[14] * u_r + row[17] * v_r + row[11] * w});
        } else {
          nrm = unit(cross(e1, e2));
        }
      }

      // ---- per light: draw, shadow any-hit, Phong ------------------------
      Vec lcol{0.f, 0.f, 0.f};
      for (int l = 0; l < L; ++l) {
        const int cnt = counts[l];
        const uint32_t stream = 4u * static_cast<uint32_t>(b * 1024 + l);
        const float u_face = uniform(h0, stream);
        const float r1 = uniform(h0, stream + 1u);
        const float r2 = uniform(h0, stream + 2u);
        const int face = min(static_cast<int>(u_face * static_cast<float>(cnt)), cnt - 1);
        Vec lp{0.f, 0.f, 0.f};
        if (face >= 0) {
          const float* c = s_lc + (l * F + face) * 9;
          lp = Vec{c[0] + (c[3] - c[0]) * r1 + (c[6] - c[0]) * r2,
                   c[1] + (c[4] - c[1]) * r1 + (c[7] - c[1]) * r2,
                   c[2] + (c[5] - c[2]) * r1 + (c[8] - c[2]) * r2};
        }
        const Vec lv = sub(lp, hp);
        const float dist = sqrtf(fmaxf(dot(lv, lv), kTiny));
        const Vec ld = scale(lv, 1.0f / dist);
        const float t_lim = dist - sh_eps;
        const float d_nl = dot(nrm, ld);

        // Occlusion matters only where it gates a contribution.
        const bool smask = active && hit && d_nl > 0.0f;
        bool occ = false;
        for (unsigned kept = warp_cull(s_cab, G, smask, hp, ld, t_lim); kept;
             kept &= kept - 1u) {
          const int c0 = (__ffs(kept) - 1) * kChunk;
          const int len = max(0, min(kChunk, n_tris - c0));
          if (smask) {
            for (int i = 0; i < len && !occ; ++i) {
              const Row12 c = row12(tab, c0 + i);
              occ = plane_t4(c.c0, c.c1, c.c2, hp, ld, eps) < t_lim;
            }
          }
          if (__all_sync(kFull, occ || !smask)) break;  // the warp's answer is final
        }
        if (smask) {
          for (int j = 0; j < S && !occ; ++j)
            occ = sphere_t(s_sph + j * kSphW, hp, ld, eps) < t_lim;
        }

        const Vec hv{(nrm.x + ld.x) * 2.0f, (nrm.y + ld.y) * 2.0f, (nrm.z + ld.z) * 2.0f};
        const float spec_dot = fmaxf(dot(nrm, hv) * rsqrtf(fmaxf(dot(hv, hv), kTiny)), 0.0f);
        const float spec = expf(ns * logf(fmaxf(spec_dot, kTiny)));
        if (hit && !occ && d_nl > 0.0f) {
          lcol.x += (ka.x * 0.5f + ke.x + kd.x * d_nl + ks.x * spec) * inv_l;
          lcol.y += (ka.y * 0.5f + ke.y + kd.y * d_nl + ks.y * spec) * inv_l;
          lcol.z += (ka.z * 0.5f + ke.z + kd.z * d_nl + ks.z * spec) * inv_l;
        }
      }

      // ---- accumulate; the reflected ray for the next bounce ------------
      if (active) {
        col.x += thr.x * lcol.x;
        col.y += thr.y * lcol.y;
        col.z += thr.z * lcol.z;
      }
      if (b + 1 < depth) {
        active = active && hit && fmaxf(fmaxf(ks.x, ks.y), ks.z) > 0.0f;
        if (active) {
          thr = Vec{thr.x * ks.x, thr.y * ks.y, thr.z * ks.z};
          const float ddn = dot(d, nrm);
          const Vec r{d.x - 2.0f * ddn * nrm.x, d.y - 2.0f * ddn * nrm.y,
                      d.z - 2.0f * ddn * nrm.z};
          o = hp;
          d = unit(r);
        }
      }
    }
    if (ray < rays) {
      out[3 * ray] = col.x;
      out[3 * ray + 1] = col.y;
      out[3 * ray + 2] = col.z;
    }
  }
}

// ---- the table build -----------------------------------------------------

constexpr int kBuildThreads = 1024;
constexpr float kOversize2 = 64.0f;  // clusters.OVERSIZE_K ** 2
constexpr float kBoxBig = 1e30f;     // the inverted box of an invalid triangle

// clusters._expand_bits_10: two zeros between each of 10 bits.
__device__ __forceinline__ uint32_t expand_bits_10(uint32_t x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// Triangle i of the padded buffer: the scene's row for i < cap, else zeros.
struct Tri {
  Vec v0, v1, v2;
  bool valid;
};

__device__ __forceinline__ Tri load_tri(const TableArgs& a, int i) {
  if (i >= a.cap) return Tri{{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, false};
  return Tri{load3(a.v0, i), load3(a.v1, i), load3(a.v2, i), a.valid[i] != 0};
}

// (v0 + v1 + v2) / 3, summed left to right as PyTorch does.
__device__ __forceinline__ Vec centroid(const Tri& t) {
  return Vec{((t.v0.x + t.v1.x) + t.v2.x) / 3.0f, ((t.v0.y + t.v1.y) + t.v2.y) / 3.0f,
             ((t.v0.z + t.v1.z) + t.v2.z) / 3.0f};
}

__device__ __forceinline__ Vec vmin(Vec a, Vec b) {
  return Vec{fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z)};
}
__device__ __forceinline__ Vec vmax(Vec a, Vec b) {
  return Vec{fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z)};
}

// The squared diagonal of the triangle's AABB: sum((max - min) ** 2).
__device__ __forceinline__ float diag2(const Tri& t) {
  const Vec e = sub(vmax(vmax(t.v0, t.v1), t.v2), vmin(vmin(t.v0, t.v1), t.v2));
  return dot3(e, e);
}

// Ascending bitonic sort of keys[0, P) (P a power of two), all threads.
__device__ void bitonic_sort(uint64_t* keys, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kBuildThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = keys[i], y = keys[ixj];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__global__ void __launch_bounds__(kBuildThreads) fused_tables_kernel(TableArgs a) {
  __shared__ uint64_t keys[kMaxN];
  __shared__ float red[kBuildThreads / 32][6];
  __shared__ float s_lo[3], s_hi[3];
  __shared__ int s_valid, s_ntris;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = (a.cap + kChunk - 1) / kChunk * kChunk;
  const int G = N / kChunk;
  int P = kChunk;
  while (P < N) P <<= 1;
  if (tid == 0) {
    s_valid = 0;
    s_ntris = 0;
  }

  // 1. The centroids' bounds, and (diag2 | +inf if invalid, index) keys.
  const float inf = __int_as_float(0x7f800000);
  Vec lo{inf, inf, inf}, hi{-inf, -inf, -inf};
  int nv = 0;
  for (int i = tid; i < P; i += kBuildThreads) {
    uint64_t key = ~0ull;
    if (i < N) {
      const Tri t = load_tri(a, i);
      const Vec c = centroid(t);
      lo = vmin(lo, c);
      hi = vmax(hi, c);
      nv += t.valid;
      const float dd = t.valid ? diag2(t) : inf;
      key = (static_cast<uint64_t>(__float_as_uint(dd)) << 32) | static_cast<uint32_t>(i);
    }
    keys[i] = key;
  }
  const float r6[6] = {warp_min(lo.x), warp_min(lo.y), warp_min(lo.z),
                       warp_max(hi.x), warp_max(hi.y), warp_max(hi.z)};
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[warp][k] = r6[k];
  }
  nv = __reduce_add_sync(kFull, nv);
  if (lane == 0 && nv) atomicAdd(&s_valid, nv);
  __syncthreads();
  if (tid < 3) {
    float l = red[0][tid], h = red[0][3 + tid];
    for (int w = 1; w < kBuildThreads / 32; ++w) {
      l = fminf(l, red[w][tid]);
      h = fmaxf(h, red[w][3 + tid]);
    }
    s_lo[tid] = l;
    s_hi[tid] = h;
  }
  // 2. The median of the valid squared diagonals (non-negative floats sort
  // as their bits): element (n_valid - 1) // 2 of the sorted keys.
  bitonic_sort(keys, P);  // (its barriers publish s_lo, s_hi)
  const float med2 = __uint_as_float(static_cast<uint32_t>(keys[max(s_valid - 1, 0) / 2] >> 32));
  const float thresh = kOversize2 * fmaxf(med2, 1e-30f);
  __syncthreads();  // every thread has read the median

  // 3. Segmented Morton keys [normal | oversized | invalid], sorted stably.
  const Vec lo3{s_lo[0], s_lo[1], s_lo[2]}, span{s_hi[0] - s_lo[0], s_hi[1] - s_lo[1],
                                                  s_hi[2] - s_lo[2]};
  const Vec inv{span.x > 1e-30f ? 1.0f / span.x : 0.0f, span.y > 1e-30f ? 1.0f / span.y : 0.0f,
                span.z > 1e-30f ? 1.0f / span.z : 0.0f};
  for (int i = tid; i < P; i += kBuildThreads) {
    uint64_t key = ~0ull;
    if (i < N) {
      const Tri t = load_tri(a, i);
      const Vec c = centroid(t);
      const float q[3] = {fminf(fmaxf((c.x - lo3.x) * inv.x, 0.0f), 1.0f),
                          fminf(fmaxf((c.y - lo3.y) * inv.y, 0.0f), 1.0f),
                          fminf(fmaxf((c.z - lo3.z) * inv.z, 0.0f), 1.0f)};
      uint32_t g[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) g[k] = min(static_cast<int>(q[k] * 1024.0f), 1023);
      uint32_t code = (expand_bits_10(g[0]) << 2) | (expand_bits_10(g[1]) << 1) |
                      expand_bits_10(g[2]);
      if (diag2(t) > thresh) code += 1u << 30;  // oversized
      if (!t.valid) code = 0xFFFFFFFFu;
      key = (static_cast<uint64_t>(code) << 32) | static_cast<uint32_t>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  bitonic_sort(keys, P);

  // 4. The sorted rows: warp w builds chunk w (constants, attributes, box).
  for (int gch = warp; gch < G; gch += kBuildThreads / 32) {
    Vec bmin{kBoxBig, kBoxBig, kBoxBig}, bmax{-kBoxBig, -kBoxBig, -kBoxBig};
    int last = 0;
    for (int k = lane; k < kChunk; k += 32) {
      const int j = gch * kChunk + k;
      const int i = static_cast<int>(keys[j] & 0xFFFFFFFFu);
      const Tri t = load_tri(a, i);
      tri_constants(t.v0, t.v1, t.v2, t.valid, a.tcs + j * kTcsW);
      float* r = a.shad + j * kShadW;
      const bool real = i < a.cap;
      const Vec z{0.f, 0.f, 0.f};
      const Vec attr[7] = {real ? load3(a.n0, i) : z, real ? load3(a.n1, i) : z,
                           real ? load3(a.n2, i) : z, real ? load3(a.ka, i) : z,
                           real ? load3(a.kd, i) : z, real ? load3(a.ks, i) : z,
                           real ? load3(a.ke, i) : z};
      const Vec pos[3] = {t.v0, t.v1, t.v2};
      for (int m = 0; m < 3; ++m) {
        r[3 * m] = pos[m].x;
        r[3 * m + 1] = pos[m].y;
        r[3 * m + 2] = pos[m].z;
      }
      for (int m = 0; m < 3; ++m) {
        r[9 + 3 * m] = attr[m].x;
        r[10 + 3 * m] = attr[m].y;
        r[11 + 3 * m] = attr[m].z;
      }
      r[18] = real && a.has_n[i] ? 1.0f : 0.0f;
      for (int m = 3; m < 7; ++m) {
        r[19 + 3 * (m - 3)] = attr[m].x;
        r[20 + 3 * (m - 3)] = attr[m].y;
        r[21 + 3 * (m - 3)] = attr[m].z;
      }
      r[31] = real ? a.ns[i] : 0.0f;
      if (t.valid) {
        bmin = vmin(bmin, vmin(vmin(t.v0, t.v1), t.v2));
        bmax = vmax(bmax, vmax(vmax(t.v0, t.v1), t.v2));
        last = j + 1;
      }
    }
    const float box[6] = {warp_min(bmin.x), warp_min(bmin.y), warp_min(bmin.z),
                          warp_max(bmax.x), warp_max(bmax.y), warp_max(bmax.z)};
    if (lane < 6) a.cab[gch * 6 + lane] = box[lane];
    last = __reduce_max_sync(kFull, last);
    if (lane == 0 && last) atomicMax(&s_ntris, last);
  }

  // 5. Spheres, light corners (original order) and counts.
  for (int s = tid; s < a.S; s += kBuildThreads) {
    float* r = a.sph + s * kSphW;
    const Vec c = load3(a.s_center, s);
    const Vec m[4] = {load3(a.s_ka, s), load3(a.s_kd, s), load3(a.s_ks, s), load3(a.s_ke, s)};
    r[0] = c.x;
    r[1] = c.y;
    r[2] = c.z;
    r[3] = a.s_radius[s];
    r[4] = a.s_valid[s] ? 1.0f : 0.0f;
    for (int k = 0; k < 4; ++k) {
      r[5 + 3 * k] = m[k].x;
      r[6 + 3 * k] = m[k].y;
      r[7 + 3 * k] = m[k].z;
    }
    r[17] = a.s_ns[s];
  }
  for (int f = tid; f < a.L * a.F; f += kBuildThreads) {
    const int i = a.tri_idx[f];
    const Vec pos[3] = {load3(a.v0, i), load3(a.v1, i), load3(a.v2, i)};
    for (int m = 0; m < 3; ++m) {
      a.lc[9 * f + 3 * m] = pos[m].x;
      a.lc[9 * f + 3 * m + 1] = pos[m].y;
      a.lc[9 * f + 3 * m + 2] = pos[m].z;
    }
  }
  for (int l = tid; l < a.L; l += kBuildThreads) a.counts[l] = a.face_count[l];
  __syncthreads();
  if (tid == 0) a.n_tris[0] = s_ntris;
}

// The frame kernel's persistent grid: as many blocks as are resident at once
// on the card, from the kernel's registers (ptxas) and its shared memory, or
// fewer when the rays need fewer.
cudaError_t frame_shape(int rays, int N, int S, int LF, int* per_sm, int* blocks, int* smem) {
  *smem = 4 * (N * kRowW + S * kSphW + LF * 9 + N / kChunk * 6);
  cudaError_t err = cudaFuncSetAttribute(fused_frame_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_frame_kernel, kThreads,
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

bool limits_ok(int N, int S, int L, int F) {
  return N <= kMaxN && N % kChunk == 0 && S <= kMaxS && L >= 1 && L * F <= kMaxLF;
}

}  // namespace

extern "C" {

// Threads per block, blocks resident per SM, the grid and the dynamic
// shared memory of a frame launch over `rays` rays.
int fused_launch_shape(int rays, int N, int S, int L, int F, int* threads, int* per_sm,
                       int* blocks, int* smem) {
  if (!limits_ok(N, S, L, F)) return cudaErrorInvalidValue;
  *threads = kThreads;
  return static_cast<int>(frame_shape(rays, N, S, L * F, per_sm, blocks, smem));
}

int fused_frame(const float* o, const float* d, const int64_t* ids, const float* tcs,
                const float* shad, const float* sph, const float* lc, const float* cab,
                const int* counts, const int* n_tris, float* out, int rays, int N, int S, int L,
                int F, int depth, unsigned int s0, float eps, float shadow_eps, void* stream) {
  if (!limits_ok(N, S, L, F)) return cudaErrorInvalidValue;
  if (rays > 0) {
    int per_sm = 0, blocks = 0, smem = 0;
    const cudaError_t err = frame_shape(rays, N, S, L * F, &per_sm, &blocks, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fused_frame_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        o, d, ids, tcs, shad, sph, lc, cab, counts, n_tris, out, rays, N, S, L, F,
        N / kChunk, depth, s0, eps, shadow_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_tables_build(const TableArgs* args, void* stream) {
  const int N = (args->cap + kChunk - 1) / kChunk * kChunk;
  if (args->cap < 1 || !limits_ok(N, args->S, args->L, args->F)) return cudaErrorInvalidValue;
  fused_tables_kernel<<<1, kBuildThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
