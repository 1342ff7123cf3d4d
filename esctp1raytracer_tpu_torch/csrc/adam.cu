// Adam's update of every float leaf of a scene in one launch, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package's update
// (esctp1raytracer_tpu/grad/optimize.py:40 adam_update) is eager jnp
// operations. The port ran them as about 14 eager tensor operations per leaf,
// some 300 launches a fit step over a scene's 21 float leaves, each a Python
// dispatch outside the step's CUDA graph, and the card waited on the host for
// them. Here one launch updates every leaf, up to kMaxLeaves (a multi-tensor
// apply):
//
//   * The leaves' pointers (p, g, m, v in; p, m, v out) and their cumulative
//     element counts go in by value as the kernel's parameter
//     (__grid_constant__: read where the launch put them, never copied per
//     thread), so no table is copied to the card before the launch.
//   * The threads walk the leaves' elements as one range, grid-stride; each
//     finds its element's leaf by scanning the cumulative counts on from the
//     leaf of its previous element.
//   * Each element reads p, g, m and v and writes the new p, m and v into
//     separate outputs. Nothing is updated in place: callers keep the old
//     parameters and moments.
//
// The arithmetic is JAX's formula term for term, in the order and with the
// float32 constants of the eager tensor operations on the card, each product,
// sum, quotient and root rounded on its own (the __f*_rn intrinsics are never
// contracted into FMAs, whatever the flags):
//
//   m = b1*m_ + (1-b1)*g        v = b2*v_ + ((1-b2)*g)*g
//   mh = m*(1/c1)               vh = v*(1/c2)
//   p_new = p - (lr*mh) / (sqrt(vh) + eps)
//
// 1/c1 and 1/c2 are float32 reciprocals taken on the host: PyTorch divides a
// CUDA tensor by a CPU scalar as a multiplication by the scalar's float32
// reciprocal. Divide and root are IEEE (div.rn, sqrt.rn); no fast math.
//
// Bound: bytes, 28 per element (four reads, three writes). The flagship's
// ~398k elements are ~11 MB, ~3.3 us at 3.35 TB/s; a small scene's few
// thousand take the launch's latency.
//
// Compile: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//          -Xcompiler -fPIC -fmad=false. C interface, loaded with ctypes; the
// entry point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;       // leaves one launch takes
constexpr int kThreads = 256;        // threads per block
constexpr int kMaxBlocks = 132 * 8;  // the grid-stride loop's grid: 8 blocks per SM

struct Leaves {
  const float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  float* p_out[kMaxLeaves];
  float* m_out[kMaxLeaves];
  float* v_out[kMaxLeaves];
  int64_t end[kMaxLeaves];  // leaf k holds elements [end[k-1], end[k]) of the range
};

struct Coef {
  float lr, b1, one_b1, b2, one_b2, eps, inv_c1, inv_c2;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Leaves L, const Coef c, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int k = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    while (i >= L.end[k]) ++k;  // i < total = end[n-1]: stops at a leaf that holds i
    const int64_t j = i - (k ? L.end[k - 1] : 0);
    const float g = L.g[k][j];
    const float m = __fadd_rn(__fmul_rn(c.b1, L.m[k][j]), __fmul_rn(c.one_b1, g));
    const float v =
        __fadd_rn(__fmul_rn(c.b2, L.v[k][j]), __fmul_rn(__fmul_rn(c.one_b2, g), g));
    const float mh = __fmul_rn(m, c.inv_c1);
    const float vh = __fmul_rn(v, c.inv_c2);
    L.p_out[k][j] = __fsub_rn(L.p[k][j], __fdiv_rn(__fmul_rn(c.lr, mh),
                                                     __fadd_rn(__fsqrt_rn(vh), c.eps)));
    L.m_out[k][j] = m;
    L.v_out[k][j] = v;
  }
}

}  // namespace

extern "C" {

int adam_max_leaves() { return kMaxLeaves; }

// One Adam step over n <= kMaxLeaves leaves. ptrs holds seven rows of n
// pointers, in the order p, g, m, v, p_out, m_out, v_out; leaf k is a
// contiguous float32 run of sizes[k] elements in each. The scalars are the
// float32 values of lr, b1, 1 - b1, b2, 1 - b2, eps, 1/c1 and 1/c2.
int adam_update(void* const* ptrs, const int64_t* sizes, int n, float lr, float b1,
                float one_b1, float b2, float one_b2, float eps, float inv_c1, float inv_c2,
                void* stream) {
  if (n < 0 || n > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Leaves L = {};
  int64_t total = 0;
  for (int k = 0; k < kMaxLeaves; ++k) {
    if (k < n) {
      L.p[k] = static_cast<const float*>(ptrs[k]);
      L.g[k] = static_cast<const float*>(ptrs[n + k]);
      L.m[k] = static_cast<const float*>(ptrs[2 * n + k]);
      L.v[k] = static_cast<const float*>(ptrs[3 * n + k]);
      L.p_out[k] = static_cast<float*>(ptrs[4 * n + k]);
      L.m_out[k] = static_cast<float*>(ptrs[5 * n + k]);
      L.v_out[k] = static_cast<float*>(ptrs[6 * n + k]);
      if (sizes[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
      total += sizes[k];
    }
    L.end[k] = total;
  }
  if (total > 0) {
    const int64_t want = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    const Coef c{lr, b1, one_b1, b2, one_b2, eps, inv_c1, inv_c2};
    adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(L, c, total);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
