// Native OBJ/MTL loader for esctp1raytracer_tpu.
//
// Plays the role tinyobjloader plays in the reference (the vendored
// src/scene/tiny_obj_loader.h + the loadobj wrapper semantics of
// src/scene/sceneloader.cpp:14-106): parse OBJ + MTL into flat, de-indexed
// per-shape triangle arrays ready for the SoA scene tables. Exposed as a
// C ABI consumed from Python via ctypes (scene/native_loader.py); the
// observable semantics match the pure-Python loader in scene/objloader.py
// exactly (shape splits on o/g once faces exist, fan triangulation,
// first-face material per shape, negative indices, normalized normals,
// default gray material) and are pinned by tests/test_native_loader.py.
//
// Build: g++ -O3 -march=native -shared -fPIC objloader.cpp -o libescloader.so

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct Material {
  float ka[3] = {0, 0, 0};
  float kd[3] = {0, 0, 0};
  float ks[3] = {0, 0, 0};
  float ke[3] = {0, 0, 0};
  float ns = 1.0f;
};

struct Shape {
  std::string name;
  std::vector<float> corner_vertices;            // 9 per face
  std::vector<float> corner_normals;             // 9 per face (if all present)
  std::vector<float> corner_uvs;                 // 6 per face (if all present)
  bool all_normals = true;
  bool all_uvs = true;
  std::string material_name;
  bool material_set = false;
  size_t num_faces() const { return corner_vertices.size() / 9; }
};

struct LoadedScene {
  std::vector<Shape> shapes;
  std::unordered_map<std::string, Material> materials;
  std::string error;
};

const Material kDefaultMaterial = {
    {0.2f, 0.2f, 0.2f}, {0.6f, 0.6f, 0.6f}, {0, 0, 0}, {0, 0, 0}, 1.0f};

// --- tokenization -----------------------------------------------------------

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline bool next_token(const char*& p, std::string& out) {
  p = skip_ws(p);
  if (*p == '\0' || *p == '\n' || *p == '#') return false;
  const char* start = p;
  while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n' && *p != '#')
    ++p;
  out.assign(start, p - start);
  return true;
}

bool parse_mtl(const std::string& path,
               std::unordered_map<std::string, Material>& out) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return false;
  char line[4096];
  std::string current;
  Material mat;
  auto flush = [&]() {
    if (!current.empty()) out[current] = mat;
    current.clear();
    mat = Material();
  };
  auto read3 = [](const char* p, float* dst) {
    std::sscanf(p, "%f %f %f", dst, dst + 1, dst + 2);
  };
  while (std::fgets(line, sizeof line, f)) {
    const char* p = skip_ws(line);
    if (std::strncmp(p, "newmtl", 6) == 0 && std::isspace(p[6])) {
      flush();
      std::string tok;
      const char* q = p + 6;
      if (next_token(q, tok)) current = tok;
    } else if ((p[0] == 'K' || p[0] == 'k') && std::isspace(p[2])) {
      char which = std::tolower(p[1]);
      if (which == 'a') read3(p + 2, mat.ka);
      else if (which == 'd') read3(p + 2, mat.kd);
      else if (which == 's') read3(p + 2, mat.ks);
      else if (which == 'e') read3(p + 2, mat.ke);
    } else if ((p[0] == 'N' || p[0] == 'n') &&
               std::tolower(p[1]) == 's' && std::isspace(p[2])) {
      std::sscanf(p + 2, "%f", &mat.ns);
    }
  }
  flush();
  std::fclose(f);
  return true;
}

bool resolve_index(long idx, size_t count, size_t* out) {
  if (idx > 0) {
    if (static_cast<size_t>(idx) > count) return false;
    *out = static_cast<size_t>(idx - 1);
  } else if (idx < 0) {
    long r = static_cast<long>(count) + idx;
    if (r < 0) return false;
    *out = static_cast<size_t>(r);
  } else {
    return false;
  }
  return true;
}

LoadedScene* load_obj_impl(const char* path) {
  auto* scene = new LoadedScene();
  FILE* f = std::fopen(path, "r");
  if (!f) {
    scene->error = std::string("cannot open ") + path;
    return scene;
  }
  std::string dir(path);
  size_t slash = dir.rfind('/');
  dir = (slash == std::string::npos) ? std::string() : dir.substr(0, slash + 1);

  std::vector<Vec3> vertices, normals;
  std::vector<float> texcoords;  // 2 per vt
  Shape current;
  std::string current_material;
  bool have_material = false;

  auto new_shape = [&](const std::string& name) {
    if (current.num_faces() > 0) scene->shapes.push_back(std::move(current));
    current = Shape();
    current.name = name;
  };

  char line[65536];
  while (std::fgets(line, sizeof line, f)) {
    const char* p = skip_ws(line);
    if (*p == '#' || *p == '\n' || *p == '\0') continue;

    if (p[0] == 'v' && std::isspace(p[1])) {
      Vec3 v;
      std::sscanf(p + 1, "%f %f %f", &v.x, &v.y, &v.z);
      vertices.push_back(v);
    } else if (p[0] == 'v' && p[1] == 'n' && std::isspace(p[2])) {
      Vec3 v;
      std::sscanf(p + 2, "%f %f %f", &v.x, &v.y, &v.z);
      normals.push_back(v);
    } else if (p[0] == 'v' && p[1] == 't' && std::isspace(p[2])) {
      float u = 0, w = 0;
      std::sscanf(p + 2, "%f %f", &u, &w);
      texcoords.push_back(u);
      texcoords.push_back(w);
    } else if (std::strncmp(p, "mtllib", 6) == 0 && std::isspace(p[6])) {
      const char* q = p + 6;
      std::string tok;
      while (next_token(q, tok)) parse_mtl(dir + tok, scene->materials);
    } else if (std::strncmp(p, "usemtl", 6) == 0 && std::isspace(p[6])) {
      const char* q = p + 6;
      std::string tok;
      current_material = next_token(q, tok) ? tok : "";
      have_material = true;
    } else if ((p[0] == 'o' || p[0] == 'g') && (std::isspace(p[1]))) {
      const char* q = p + 1;
      std::string tok;
      new_shape(next_token(q, tok) ? tok : "");
    } else if (p[0] == 'f' && std::isspace(p[1])) {
      // Gather corner index triples.
      struct Corner { size_t v; long t; long n; };
      std::vector<Corner> corners;
      const char* q = p + 1;
      std::string tok;
      while (next_token(q, tok)) {
        long vi = 0, ti = 0, ni = 0;
        const char* c = tok.c_str();
        char* end;
        vi = std::strtol(c, &end, 10);
        bool has_t = false, has_n = false;
        if (*end == '/') {
          c = end + 1;
          if (*c == '/') {  // v//n
            ni = std::strtol(c + 1, &end, 10);
            has_n = true;
          } else {  // v/t or v/t/n
            ti = std::strtol(c, &end, 10);
            has_t = true;
            if (*end == '/') {
              ni = std::strtol(end + 1, &end, 10);
              has_n = true;
            }
          }
        }
        size_t rv;
        if (!resolve_index(vi, vertices.size(), &rv)) {
          scene->error = "bad vertex index in " + std::string(path);
          std::fclose(f);
          return scene;
        }
        Corner corner{rv, has_t ? ti : 0, has_n ? ni : 0};
        corners.push_back(corner);
      }
      if (corners.size() < 3) {
        scene->error = "face with <3 vertices in " + std::string(path);
        std::fclose(f);
        return scene;
      }
      // Fan triangulation around corner 0 (tinyobj triangulate=true).
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
        if (current.num_faces() == 0) {
          current.material_name = have_material ? current_material : "";
          current.material_set = have_material;
        }
        for (const Corner& c : tri) {
          const Vec3& v = vertices[c.v];
          current.corner_vertices.push_back(v.x);
          current.corner_vertices.push_back(v.y);
          current.corner_vertices.push_back(v.z);
          if (c.n != 0) {
            size_t rn;
            if (!resolve_index(c.n, normals.size(), &rn)) {
              scene->error = "bad normal index";
              std::fclose(f);
              return scene;
            }
            Vec3 n = normals[rn];
            float len = std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
            if (len < 1e-30f) len = 1e-30f;
            current.corner_normals.push_back(n.x / len);
            current.corner_normals.push_back(n.y / len);
            current.corner_normals.push_back(n.z / len);
          } else {
            current.all_normals = false;
          }
          if (c.t != 0) {
            size_t rt;
            if (!resolve_index(c.t, texcoords.size() / 2, &rt)) {
              scene->error = "bad texcoord index";
              std::fclose(f);
              return scene;
            }
            current.corner_uvs.push_back(texcoords[2 * rt]);
            current.corner_uvs.push_back(texcoords[2 * rt + 1]);
          } else {
            current.all_uvs = false;
          }
        }
      }
    }
  }
  std::fclose(f);
  if (current.num_faces() > 0) scene->shapes.push_back(std::move(current));
  if (scene->shapes.empty() && scene->error.empty())
    scene->error = "No triangles loaded from " + std::string(path);
  return scene;
}

}  // namespace

// --- C ABI ------------------------------------------------------------------

extern "C" {

void* esc_load_obj(const char* path) { return load_obj_impl(path); }

const char* esc_error(void* handle) {
  auto* s = static_cast<LoadedScene*>(handle);
  return s->error.empty() ? nullptr : s->error.c_str();
}

int32_t esc_num_shapes(void* handle) {
  return static_cast<int32_t>(static_cast<LoadedScene*>(handle)->shapes.size());
}

int32_t esc_shape_faces(void* handle, int32_t shape) {
  return static_cast<int32_t>(
      static_cast<LoadedScene*>(handle)->shapes[shape].num_faces());
}

const char* esc_shape_name(void* handle, int32_t shape) {
  return static_cast<LoadedScene*>(handle)->shapes[shape].name.c_str();
}

int32_t esc_shape_has_normals(void* handle, int32_t shape) {
  const Shape& s = static_cast<LoadedScene*>(handle)->shapes[shape];
  return (s.all_normals && s.num_faces() > 0) ? 1 : 0;
}

int32_t esc_shape_has_uvs(void* handle, int32_t shape) {
  const Shape& s = static_cast<LoadedScene*>(handle)->shapes[shape];
  return (s.all_uvs && s.num_faces() > 0) ? 1 : 0;
}

// dst sized faces*9 (vertices/normals) or faces*6 (uvs).
void esc_shape_vertices(void* handle, int32_t shape, float* dst) {
  const Shape& s = static_cast<LoadedScene*>(handle)->shapes[shape];
  std::memcpy(dst, s.corner_vertices.data(),
              s.corner_vertices.size() * sizeof(float));
}

void esc_shape_normals(void* handle, int32_t shape, float* dst) {
  const Shape& s = static_cast<LoadedScene*>(handle)->shapes[shape];
  std::memcpy(dst, s.corner_normals.data(),
              s.corner_normals.size() * sizeof(float));
}

void esc_shape_uvs(void* handle, int32_t shape, float* dst) {
  const Shape& s = static_cast<LoadedScene*>(handle)->shapes[shape];
  std::memcpy(dst, s.corner_uvs.data(), s.corner_uvs.size() * sizeof(float));
}

// dst: ka[3] kd[3] ks[3] ke[3] ns -> 13 floats. Returns 1 if the material
// was found, 0 if the default was used.
int32_t esc_shape_material(void* handle, int32_t shape, float* dst) {
  auto* sc = static_cast<LoadedScene*>(handle);
  const Shape& s = sc->shapes[shape];
  const Material* m = &kDefaultMaterial;
  int32_t found = 0;
  auto it = sc->materials.find(s.material_name);
  if (s.material_set && it != sc->materials.end()) {
    m = &it->second;
    found = 1;
  }
  std::memcpy(dst + 0, m->ka, 3 * sizeof(float));
  std::memcpy(dst + 3, m->kd, 3 * sizeof(float));
  std::memcpy(dst + 6, m->ks, 3 * sizeof(float));
  std::memcpy(dst + 9, m->ke, 3 * sizeof(float));
  dst[12] = m->ns;
  return found;
}

void esc_free(void* handle) { delete static_cast<LoadedScene*>(handle); }

}  // extern "C"
