// Wavefront OBJ geometry parser (C++17, no dependencies) for the PyTorch
// port's ``load_obj`` (utils/obj_io.py), in one pass over the file.
//
// Semantics identical to utils/obj_io.py's Python parser (reference
// load_obj.py:113-166): 'v' lines take the first 3 floats; 'f' lines are
// fan-triangulated; indices are the '/'-prefix part, 1-based.  strtof is
// correctly rounded, so vertex values match Python's float() bit for bit.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libnrobj.so objparse.cpp
// (utils/native_loader.py builds it at first use, into build/ at the
// repository root, and loads it through ctypes).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

typedef struct {
  float* vertices;   // [num_vertices * 3]
  long num_vertices;
  int* faces;        // [num_faces * 3], 0-based
  long num_faces;
  float* uvs;        // [num_uvs * 2] (vt lines), may be null
  long num_uvs;
  int* uv_faces;     // [num_faces * 3], 0-based uv ids (or -1), may be null
} NrObjMesh;

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

int nr_parse_obj(const char* path, NrObjMesh* out) {
  std::memset(out, 0, sizeof(*out));
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);
  buf[size] = '\n';
  const char* p = buf.data();
  const char* end = buf.data() + size;

  std::vector<float> verts;
  std::vector<float> uvs;
  std::vector<int> faces;
  std::vector<int> uv_faces;
  std::vector<long> poly_v;   // scratch per face line
  std::vector<long> poly_vt;
  bool any_vt_ref = false;

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = const_cast<char*>(p + 1);
      for (int i = 0; i < 3; i++) {
        float val = std::strtof(q, &q);
        verts.push_back(val);
      }
    } else if (p[0] == 'v' && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) {
      char* q = const_cast<char*>(p + 2);
      for (int i = 0; i < 2; i++) {
        float val = std::strtof(q, &q);
        uvs.push_back(val);
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      poly_v.clear();
      poly_vt.clear();
      const char* q = p + 1;
      const char* line_end = q;
      while (line_end < end && *line_end != '\n') line_end++;
      while (q < line_end) {
        q = skip_ws(q, line_end);
        if (q >= line_end) break;
        char* e;
        long vid = std::strtol(q, &e, 10);
        if (e == q) break;
        long vtid = 0;
        if (*e == '/') {
          const char* q2 = e + 1;
          char* e2;
          long t = std::strtol(q2, &e2, 10);
          if (e2 != q2) { vtid = t; any_vt_ref = true; }
          e = e2;
          if (*e == '/') {  // skip normal index
            char* e3;
            std::strtol(e + 1, &e3, 10);
            e = e3;
          }
        }
        poly_v.push_back(vid);
        poly_vt.push_back(vtid);
        q = e;
      }
      // fan triangulation (load_obj.py:135-141)
      for (size_t i = 0; i + 2 < poly_v.size(); i++) {
        faces.push_back((int)(poly_v[0] - 1));
        faces.push_back((int)(poly_v[i + 1] - 1));
        faces.push_back((int)(poly_v[i + 2] - 1));
        uv_faces.push_back((int)(poly_vt[0] - 1));
        uv_faces.push_back((int)(poly_vt[i + 1] - 1));
        uv_faces.push_back((int)(poly_vt[i + 2] - 1));
      }
    }
    p = next_line(p, end);
  }

  out->num_vertices = (long)(verts.size() / 3);
  out->num_faces = (long)(faces.size() / 3);
  out->num_uvs = (long)(uvs.size() / 2);
  if (!verts.empty()) {
    out->vertices = (float*)std::malloc(verts.size() * sizeof(float));
    std::memcpy(out->vertices, verts.data(), verts.size() * sizeof(float));
  }
  if (!faces.empty()) {
    out->faces = (int*)std::malloc(faces.size() * sizeof(int));
    std::memcpy(out->faces, faces.data(), faces.size() * sizeof(int));
  }
  if (!uvs.empty()) {
    out->uvs = (float*)std::malloc(uvs.size() * sizeof(float));
    std::memcpy(out->uvs, uvs.data(), uvs.size() * sizeof(float));
  }
  if (any_vt_ref && !uv_faces.empty()) {
    out->uv_faces = (int*)std::malloc(uv_faces.size() * sizeof(int));
    std::memcpy(out->uv_faces, uv_faces.data(), uv_faces.size() * sizeof(int));
  }
  return 0;
}

void nr_free_mesh(NrObjMesh* m) {
  std::free(m->vertices);
  std::free(m->faces);
  std::free(m->uvs);
  std::free(m->uv_faces);
  std::memset(m, 0, sizeof(*m));
}

}  // extern "C"
