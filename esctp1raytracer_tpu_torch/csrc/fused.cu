// Fused whole-frame kernel (K3) for Hopper (sm_90a): rays in, colors out.
//
// Replaces the TPU Pallas kernel esctp1raytracer_tpu/kernels/fused_pallas.py:
// _make_kernel (the inner `kernel`, launched by _fused_call). It computes
// what that kernel computes, reshaped for the card: one thread per ray, the
// ray's state (origin, direction, throughput, active flag, accumulated
// color) in registers across up to 4 Whitted bounces. Per bounce:
//
//   1. chunk cull: the block builds the interval hull of its active rays
//      (warp shuffles, then shared memory), tests it against the G <= 16
//      chunk AABBs of 128 Morton-sorted triangles, and compacts the kept
//      chunk ids into shared memory in ascending order;
//   2. closest hit: each kept chunk's 13 plane constants per triangle are
//      copied into shared memory (6.6 KB) and every thread walks them in
//      ascending order, keeping (t, index) on strict < (the lane search);
//      then the sphere table (shared memory), also on strict <; triangles
//      win ties against spheres;
//   3. the winner's 32-float attribute row is read straight from device
//      memory (the TPU's windowed masked scan exists only because a TPU
//      has no per-lane gather), then the Möller–Trumbore recompute of
//      t/u/v, the hit point backed off by shadow_eps, the shading normal;
//   4. per light: the murmur3 counter draws of utils/rng.py in native
//      uint32, the sampled point on the drawn face, a chunk cull of the
//      shadow rays (mask: active & hit & d.n > 0, ceiling t_limit), an
//      any-hit sweep of the kept chunks and the spheres, and the Phong term;
//   5. the reflected ray for the next bounce.
//
// The cull is conservative (a culled chunk provably holds no accepted hit of
// a masked ray, and rays outside the mask contribute nothing), and the list
// stays ascending, so any block size gives the colors of the TPU's 1024-ray
// tile. As on the TPU: all-invalid chunks (inverted boxes) are dropped
// explicitly, each chunk's sweep is clamped to n_tris (invalid triangles
// sort last), and with G == 1 the single chunk is swept without a hull test.
//
// What bounds it on the H100: arithmetic in the sweeps, about 30 float32
// operations and one IEEE division per (ray, triangle) pair. The cull keeps
// the pairs to the chunks a block's rays can reach, blocks whose rays all
// died skip later bounces, and a shadow sweep stops once every masked ray of
// the block is occluded. Shared memory is ~12 KB per block, so many blocks
// fit on each SM. No tensor cores.
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
// the entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_plane.cuh"  // Vec, plane_t, kTcsW, kBig

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // FUSED_CHUNK triangles per chunk
constexpr int kShadW = 32;
constexpr int kSphW = 18;
constexpr int kMaxS = 32;   // FUSED_SPHERE_LIMIT
constexpr int kMaxLF = 64;  // FUSED_LIGHT_FACE_LIMIT
constexpr int kMaxG = 16;   // FUSED_TRI_LIMIT / FUSED_CHUNK
constexpr int kHull = 13;   // reduced values: -min/max of o and d, max t_limit
constexpr float kFBig = 3.4e38f;
constexpr float kTiny = 1e-12f;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Shared {
  float tile[kChunk * kTcsW];
  float sph[kMaxS * kSphW];
  float lc[kMaxLF * 9];
  float cab[kMaxG * 6];
  float red[kWarps][kHull];
  int list[kMaxG];
  int cnt;
};

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

// Compacted ascending list of the chunks the masked rays' interval hull can
// reach (and, with use_tmax, within the largest masked t_limit). Every
// thread of the block calls it; returns the list's length.
__device__ int chunk_cull(Shared& sm, int G, bool mask, Vec o, Vec d, float tlim,
                          bool use_tmax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[kHull] = {o.x, o.y, o.z, d.x, d.y, d.z, -o.x, -o.y, -o.z, -d.x, -d.y, -d.z, -tlim};
#pragma unroll
  for (int k = 0; k < kHull; ++k) {
    v[k] = mask ? v[k] : kFBig;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  __syncthreads();  // the previous list and hull are no longer read
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kHull; ++k) sm.red[warp][k] = v[k];
  }
  const bool live = __syncthreads_or(mask);
  if (warp == 0) {
    bool keep = false;
    if (lane < G) {
      const float* box = sm.cab + 6 * lane;
      keep = live && box[0] <= box[3];  // non-empty chunk, some masked ray
      if (keep && G > 1) {
        float h[kHull];
#pragma unroll
        for (int k = 0; k < kHull; ++k) {
          h[k] = sm.red[0][k];
          for (int w = 1; w < kWarps; ++w) h[k] = fminf(h[k], sm.red[w][k]);
        }
        float near_all = -kFBig, far_all = kFBig;
        bool unsure = false;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float o_lo = h[a], o_hi = -h[6 + a], d_lo = h[3 + a], d_hi = -h[9 + a];
          const bool unb = d_lo <= 0.0f && d_hi >= 0.0f;  // the interval holds 0
          const float ia = 1.0f / (unb ? 1.0f : d_hi), ib = 1.0f / (unb ? 1.0f : d_lo);
          const float il = fminf(ia, ib), ih = fmaxf(ia, ib);
          const float lo1 = box[a] - o_hi, hi1 = box[a] - o_lo;
          const float lo2 = box[3 + a] - o_hi, hi2 = box[3 + a] - o_lo;
          const float p[8] = {lo1 * il, lo1 * ih, hi1 * il, hi1 * ih,
                              lo2 * il, lo2 * ih, hi2 * il, hi2 * ih};
          float nr = p[0], fr = p[0];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            unsure |= isnan(p[k]);  // 0 * inf: keep the chunk
            nr = fminf(nr, p[k]);
            fr = fmaxf(fr, p[k]);
          }
          if (!unb) {
            near_all = fmaxf(near_all, nr);
            far_all = fminf(far_all, fr);
          }
        }
        const float tmax = -h[12];
        keep = unsure || !(near_all > far_all || far_all < 0.0f || (use_tmax && near_all > tmax));
      }
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) sm.list[__popc(kept & ((1u << lane) - 1u))] = lane;
    if (lane == 0) sm.cnt = __popc(kept);
  }
  __syncthreads();
  return sm.cnt;
}

// Copy chunk g's constants, clamped to n_tris, into shared memory; returns
// the number of triangles copied. Called by every thread; ends in a barrier.
__device__ __forceinline__ int load_chunk(Shared& sm, const float* __restrict__ tcs, int g,
                                          int n_tris) {
  const int c0 = g * kChunk;
  const int len = max(0, min(kChunk, n_tris - c0));
  __syncthreads();  // the previous chunk is done with
  for (int i = threadIdx.x; i < len * kTcsW; i += kThreads) sm.tile[i] = tcs[c0 * kTcsW + i];
  __syncthreads();
  return len;
}

__global__ void __launch_bounds__(kThreads)
fused_frame_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
                   const int* __restrict__ ids, const float* __restrict__ tcs,
                   const float* __restrict__ shad, const float* __restrict__ sph,
                   const float* __restrict__ lc, const float* __restrict__ cab,
                   const int* __restrict__ counts, const int* __restrict__ n_tris_p,
                   float* __restrict__ out, int rays, int S, int L, int F, int G, int depth,
                   uint32_t s0, float eps, float sh_eps) {
  __shared__ Shared sm;
  for (int i = threadIdx.x; i < S * kSphW; i += kThreads) sm.sph[i] = sph[i];
  for (int i = threadIdx.x; i < L * F * 9; i += kThreads) sm.lc[i] = lc[i];
  for (int i = threadIdx.x; i < G * 6; i += kThreads) sm.cab[i] = cab[i];
  // (the barrier opening each bounce orders these copies before any read)
  const int n_tris = n_tris_p[0];
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  bool active = ray < rays;  // padding threads stay inactive and write nothing
  Vec o{0.f, 0.f, 0.f}, d{0.f, 0.f, 1.f};
  uint32_t h0 = 0;
  if (active) {
    o = Vec{o_in[3 * ray], o_in[3 * ray + 1], o_in[3 * ray + 2]};
    d = Vec{d_in[3 * ray], d_in[3 * ray + 1], d_in[3 * ray + 2]};
    h0 = fmix(static_cast<uint32_t>(ids[ray]) ^ s0);
  }
  Vec col{0.f, 0.f, 0.f}, thr{1.f, 1.f, 1.f};
  const float inv_l = 1.0f / static_cast<float>(L);

  // Every barrier below is reached by all threads of the block: inactive
  // rays skip the arithmetic, never the loops that hold barriers.
  for (int b = 0; b < depth; ++b) {
    if (!__syncthreads_or(active)) break;  // every ray of the block is done

    // ---- closest hit: the culled triangle chunks, then the spheres -------
    float bt = kBig;
    int bi = -1;
    const int nc = chunk_cull(sm, G, active, o, d, 0.0f, false);
    for (int k = 0; k < nc; ++k) {
      const int c0 = sm.list[k] * kChunk;
      const int len = load_chunk(sm, tcs, sm.list[k], n_tris);
      if (active) {
        for (int i = 0; i < len; ++i) {
          const float t = plane_t(sm.tile + i * kTcsW, o, d, eps);
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
        const float t = sphere_t(sm.sph + j * kSphW, o, d, eps);
        if (t < bst) {
          bst = t;
          bsi = j;
        }
      }
    }
    const bool is_s = bst < bt;  // strict: triangles win ties
    const float bt_comb = is_s ? bst : bt;
    const bool hit = bt_comb < kBig;

    // ---- winner row, MT recompute, hit point and shading normal ---------
    float row[kShadW];
#pragma unroll
    for (int k = 0; k < kShadW; ++k) row[k] = 0.0f;
    if (bi >= 0) {
      const float4* r4 = reinterpret_cast<const float4*>(shad + static_cast<size_t>(bi) * kShadW);
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
    const bool ok_r = ok_det && u_r >= eps && u_r <= 1.0f && v_r >= eps && u_r + v_r <= 1.0f &&
                      t_r >= eps;
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
      const float* s = sm.sph + bsi * kSphW;
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

    // ---- per light: draw, shadow any-hit, Phong --------------------------
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
        const float* c = sm.lc + (l * F + face) * 9;
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
      const int ns_chunks = chunk_cull(sm, G, smask, hp, ld, t_lim, true);
      for (int k = 0; k < ns_chunks; ++k) {
        const int len = load_chunk(sm, tcs, sm.list[k], n_tris);
        if (smask) {
          for (int i = 0; i < len && !occ; ++i)
            occ = plane_t(sm.tile + i * kTcsW, hp, ld, eps) < t_lim;
        }
        if (__syncthreads_and(occ || !smask)) break;  // the block's answer is final
      }
      if (smask) {
        for (int j = 0; j < S && !occ; ++j) occ = sphere_t(sm.sph + j * kSphW, hp, ld, eps) < t_lim;
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

    // ---- accumulate; the reflected ray for the next bounce --------------
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
        const Vec r{d.x - 2.0f * ddn * nrm.x, d.y - 2.0f * ddn * nrm.y, d.z - 2.0f * ddn * nrm.z};
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

}  // namespace

extern "C" {

int fused_frame(const float* o, const float* d, const int* ids, const float* tcs,
                const float* shad, const float* sph, const float* lc, const float* cab,
                const int* counts, const int* n_tris, float* out, int rays, int S, int L,
                int F, int G, int depth, unsigned int s0, float eps, float shadow_eps,
                void* stream) {
  if (S > kMaxS || L * F > kMaxLF || G > kMaxG || L < 1) return cudaErrorInvalidValue;
  if (rays > 0) {
    const int blocks = (rays + kThreads - 1) / kThreads;
    fused_frame_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, ids, tcs, shad, sph, lc, cab, counts, n_tris, out, rays, S, L, F, G, depth, s0,
        eps, shadow_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
