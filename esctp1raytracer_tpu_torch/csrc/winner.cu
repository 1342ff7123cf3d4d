// The winner-row fetch and its backward for Hopper (sm_90a).
//
// The frame step fetches each ray's winning triangle row from the packed
// [N, 32] table (core/intersect.py:packed_tri_table) and reads it as twelve
// fields: v0 v1 v2 n0 n1 n2 ka kd ks ke (3 floats each), ns and has_normals
// (1 each). Through index_select and slices, each field's gradient came back
// as a zero-filled [R, 32] tensor with its columns copied in, all of them
// added together and then scattered into the table with one float atomic per
// element: about 15 GB of traffic a 1080p step for a 265 MB gradient. Here:
//
//   * winner_gather_kernel: one block is 256 rays. It reads their rows'
//     indices once into shared memory and writes each field as its own
//     contiguous [R, w] tensor, field by field, so every store is coalesced.
//     A copy: the values equal index_select's bit for bit, and it writes no
//     more bytes than index_select's [R, 32] row.
//   * winner_scatter_kernel: one warp is 32 consecutive rays. Rays come in
//     image order, so neighbours mostly share a winner: the warp groups equal
//     rows (__match_any_sync), sums each group's field gradients in registers
//     (a tree over the group's lanes, one shuffle per column and level), and
//     the group's lowest lane adds the sums to the row with float4 atomics
//     (sm_90 has vector atomicAdd on global memory). A warp of distinct rows
//     does one add per ray, as index_add_ did; a warp on one row does one.
//     Fields whose gradient is absent are neither read nor added. Missed rays
//     carry row 0 (the caller's clamp) and are reduced there like any other.
//     With cnt_out, lane 0 of each warp writes the number of groups it added.
//
// What bounds the scatter: atomics on the few rows that win most rays (a
// ground plane, row 0 of the missed rays) serialise at their L2 addresses,
// one warp's add after another's. So warp w adds into copy w % copies of the
// table's gradient, and the caller sums the copies: with 8 copies the
// flagship's 1080p scatter took 0.14 ms instead of 0.48 (H100, 700 W; its
// bytes alone would take 0.08).
//
// A row index outside the table stops either kernel (__trap, as index_select's
// and index_add_'s device-side asserts do): nothing is read or added there.
//
// Both are capturable in a CUDA graph: no host synchronisation, and nothing
// allocated whose size depends on the data. Only the order of the float32
// additions differs from index_add_'s, whose atomics have no order either.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC. C interface, loaded with ctypes; each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;      // floats per packed row
constexpr int kFields = 12;    // v0 v1 v2 n0 n1 n2 ka kd ks ke ns has_normals
constexpr int kThreads = 256;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

// Field f's first column and width in the packed row.
__host__ __device__ constexpr int field_off(int f) { return f < 10 ? 3 * f : 20 + f; }
__host__ __device__ constexpr int field_width(int f) { return f < 10 ? 3 : 1; }

struct Outs {
  float* p[kFields];
};

struct Grads {
  const float* p[kFields];  // nullptr: the field has no gradient
};

__global__ void __launch_bounds__(kThreads)
winner_gather_kernel(const float* __restrict__ table, const int64_t* __restrict__ prim,
                     int rays, int rows, Outs out) {
  __shared__ int s_row[kThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int n = min(kThreads, static_cast<int>(rays - base));
  if (threadIdx.x < n) {
    const int64_t row = prim[base + threadIdx.x];
    if (row < 0 || row >= rows) __trap();  // as index_select's device-side assert
    s_row[threadIdx.x] = static_cast<int>(row);
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int w = field_width(f), off = field_off(f);
    float* __restrict__ dst = out.p[f] + base * w;
    for (int e = threadIdx.x; e < n * w; e += kThreads) {
      const int r = w == 3 ? e / 3 : e;
      dst[e] = __ldg(table + static_cast<int64_t>(s_row[r]) * kCols + off + (e - r * w));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
winner_scatter_kernel(Grads g, unsigned cols, const int64_t* __restrict__ prim, int rays,
                      int n, int copies, float* __restrict__ gtab, int* __restrict__ cnt_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (warp * 32 >= rays) return;  // whole warps only: the rays are consecutive
  const int64_t ray = warp * 32 + lane;
  const bool live = ray < rays;
  const int64_t row = live ? prim[ray] : -1;
  if (live && (row < 0 || row >= n)) __trap();  // as index_add_'s device-side assert
  const int key = static_cast<int>(row);
  const unsigned peers = __match_any_sync(kFull, key);
  const bool lead = live && lane == __ffs(peers) - 1;
  const unsigned leads = __ballot_sync(kFull, lead);
  if (cnt_out != nullptr && lane == 0) cnt_out[warp] = __popc(leads);

  float v[kCols];
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int w = field_width(f), off = field_off(f);
#pragma unroll
    for (int c = 0; c < w; ++c)
      v[off + c] = (g.p[f] != nullptr && live) ? __ldg(g.p[f] + ray * w + c) : 0.0f;
  }

  // The group's sum into its lowest lane: at level k each member whose rank
  // in the group is a multiple of 2^(k+1) adds the member 2^k ranks above it.
  // `above` holds the members above this lane not yet added in; a member is
  // taken out once it has been added (its rank's bit k is set).
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (cols & (1u << c)) {
        const float t = __shfl_sync(kFull, v[c], src);
        if (next) v[c] += t;
      }
    }
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }

  if (lead) {
    float* row = gtab + (warp % copies * n + key) * kCols;
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      if (cols & (0xfu << (4 * q))) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
        atomicAdd(reinterpret_cast<float4*>(row + 4 * q),
                  make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
#else
        for (int c = 0; c < 4; ++c) atomicAdd(row + 4 * q + c, v[4 * q + c]);
#endif
      }
    }
  }
}

}  // namespace

extern "C" {

// The fields of rows prim [rays] (int64, each in [0, rows)) of the table
// [rows, 32] into outs[0..11], each a contiguous float32 [rays, width].
int winner_gather(const float* table, const int64_t* prim, int rays, int rows,
                  float* const* outs, void* stream) {
  Outs o;
  for (int f = 0; f < kFields; ++f) o.p[f] = outs[f];
  if (rays > 0) {
    winner_gather_kernel<<<(rays + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(table, prim, rays, rows, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Add the fields' gradients grads[0..11] (contiguous float32 [rays, width],
// or nullptr) into rows prim [rays] (each in [0, n)) of gtab [copies, n, 32]
// (16-byte aligned), warp w into copy w % copies. With cnt_out (int32
// [ceil(rays / 32)]), each warp's number of groups.
int winner_scatter(const float* const* grads, const int64_t* prim, int rays, int n, int copies,
                   float* gtab, int* cnt_out, void* stream) {
  Grads g;
  unsigned cols = 0;
  for (int f = 0; f < kFields; ++f) {
    g.p[f] = grads[f];
    if (grads[f] != nullptr) cols |= ((1u << field_width(f)) - 1u) << field_off(f);
  }
  if (copies < 1) return cudaErrorInvalidValue;
  if (rays > 0) {
    winner_scatter_kernel<<<(rays + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, cols, prim, rays, n, copies,
                                                                 gtab, cnt_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* winner_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
