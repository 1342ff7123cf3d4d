// Native median-split BVH builder for esctp1raytracer_tpu.
//
// The reference builds its BVH in C++ on the host (buildBVH,
// reference src/main.cpp:98-171); this keeps that capability native.
// Same algorithm as accel/bvh.py's numpy builder (widest-axis median
// split, stable ordering) so the two are interchangeable — parity is
// pinned by tests/test_accel.py.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh.cpp -o libescbvh.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Builder {
  int32_t n = 0;
  std::vector<float> tmin, tmax, centroid;      // [n*3]
  std::vector<int32_t> order;                   // [n]
  std::vector<float> bmin, bmax;                // [m*3]
  std::vector<int32_t> left, right, start, count;

  int32_t new_node() {
    bmin.insert(bmin.end(), 3, 0.f);
    bmax.insert(bmax.end(), 3, 0.f);
    left.push_back(-1);
    right.push_back(-1);
    start.push_back(0);
    count.push_back(0);
    return static_cast<int32_t>(left.size()) - 1;
  }
};

}  // namespace

extern "C" {

// verts: [n*9] floats (three corners per triangle). Returns a handle.
void* esc_bvh_build(const float* verts, int32_t n, int32_t leaf_size) {
  auto* b = new Builder();
  b->n = n;
  b->tmin.resize(n * 3);
  b->tmax.resize(n * 3);
  b->centroid.resize(n * 3);
  for (int32_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      float a = verts[i * 9 + 0 + k];
      float c = verts[i * 9 + 3 + k];
      float d = verts[i * 9 + 6 + k];
      float mn = std::min(a, std::min(c, d));
      float mx = std::max(a, std::max(c, d));
      b->tmin[i * 3 + k] = mn;
      b->tmax[i * 3 + k] = mx;
      b->centroid[i * 3 + k] = (a + c + d) / 3.0f;
    }
  }
  b->order.resize(n);
  std::iota(b->order.begin(), b->order.end(), 0);

  struct Item { int32_t node, begin, end; };
  std::vector<Item> stack;
  int32_t root = b->new_node();
  stack.push_back({root, 0, n});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    // bounds over the segment
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    float cmn[3] = {1e30f, 1e30f, 1e30f}, cmx[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t s = it.begin; s < it.end; ++s) {
      int32_t t = b->order[s];
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], b->tmin[t * 3 + k]);
        mx[k] = std::max(mx[k], b->tmax[t * 3 + k]);
        cmn[k] = std::min(cmn[k], b->centroid[t * 3 + k]);
        cmx[k] = std::max(cmx[k], b->centroid[t * 3 + k]);
      }
    }
    std::memcpy(&b->bmin[it.node * 3], mn, sizeof mn);
    std::memcpy(&b->bmax[it.node * 3], mx, sizeof mx);
    if (it.end - it.begin <= leaf_size) {
      b->left[it.node] = -1;
      b->right[it.node] = -1;
      b->start[it.node] = it.begin;
      b->count[it.node] = it.end - it.begin;
      continue;
    }
    int axis = 0;
    float widest = cmx[0] - cmn[0];
    for (int k = 1; k < 3; ++k) {
      if (cmx[k] - cmn[k] > widest) { widest = cmx[k] - cmn[k]; axis = k; }
    }
    const std::vector<float>& cen = b->centroid;
    std::stable_sort(
        b->order.begin() + it.begin, b->order.begin() + it.end,
        [&cen, axis](int32_t a, int32_t c) {
          return cen[a * 3 + axis] < cen[c * 3 + axis];
        });
    int32_t mid = it.begin + (it.end - it.begin) / 2;
    int32_t li = b->new_node();
    int32_t ri = b->new_node();
    b->left[it.node] = li;
    b->right[it.node] = ri;
    stack.push_back({ri, mid, it.end});
    stack.push_back({li, it.begin, mid});
  }
  return b;
}

int32_t esc_bvh_num_nodes(void* handle) {
  return static_cast<int32_t>(static_cast<Builder*>(handle)->left.size());
}

void esc_bvh_fetch(void* handle, float* bmin, float* bmax, int32_t* left,
                   int32_t* right, int32_t* start, int32_t* count,
                   int32_t* order) {
  auto* b = static_cast<Builder*>(handle);
  std::memcpy(bmin, b->bmin.data(), b->bmin.size() * sizeof(float));
  std::memcpy(bmax, b->bmax.data(), b->bmax.size() * sizeof(float));
  std::memcpy(left, b->left.data(), b->left.size() * sizeof(int32_t));
  std::memcpy(right, b->right.data(), b->right.size() * sizeof(int32_t));
  std::memcpy(start, b->start.data(), b->start.size() * sizeof(int32_t));
  std::memcpy(count, b->count.data(), b->count.size() * sizeof(int32_t));
  std::memcpy(order, b->order.data(), b->order.size() * sizeof(int32_t));
}

void esc_bvh_free(void* handle) { delete static_cast<Builder*>(handle); }

}  // extern "C"
