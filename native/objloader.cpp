// Minimal fast Wavefront OBJ loader (vertices + triangulated faces).
//
// The reference ingests meshes through Julia's GeometryBasics; a production
// serving stack needs a native asset path. Exposed through a tiny C ABI
// consumed from Python with ctypes (no pybind11 in this image):
//
//   int obj_count(const char* path, long* n_vertices, long* n_faces);
//   int obj_parse(const char* path, float* vertices /*3*nv*/,
//                 int* faces /*3*nf*/, float* normals_or_null /*3*nv*/);
//
// Faces with more than 3 vertices are fan-triangulated; v/vt/vn index
// syntax and negative (relative) indices are handled. Returns 0 on
// success, nonzero errno-style codes otherwise.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
    std::vector<float> verts;
    std::vector<float> normals;
    std::vector<int> faces;
};

int parse_file(const char* path, Parsed& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 2;

    char line[8192];
    std::vector<long> fan;
    while (std::fgets(line, sizeof line, f)) {
        if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
            float x, y, z;
            if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                out.verts.push_back(x);
                out.verts.push_back(y);
                out.verts.push_back(z);
            }
        } else if (line[0] == 'v' && line[1] == 'n') {
            float x, y, z;
            if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
                out.normals.push_back(x);
                out.normals.push_back(y);
                out.normals.push_back(z);
            }
        } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
            fan.clear();
            char* p = line + 2;
            while (*p) {
                while (*p == ' ' || *p == '\t') ++p;
                if (*p == '\0' || *p == '\n' || *p == '\r') break;
                long idx = std::strtol(p, &p, 10);
                if (idx < 0) idx = (long)(out.verts.size() / 3) + idx + 1;
                fan.push_back(idx - 1);
                // Skip /vt/vn suffixes.
                while (*p && *p != ' ' && *p != '\t' && *p != '\n') ++p;
            }
            for (size_t k = 2; k < fan.size(); ++k) {
                out.faces.push_back((int)fan[0]);
                out.faces.push_back((int)fan[k - 1]);
                out.faces.push_back((int)fan[k]);
            }
        }
    }
    std::fclose(f);
    return 0;
}

}  // namespace

extern "C" {

int obj_count(const char* path, long* n_vertices, long* n_faces) {
    Parsed p;
    int rc = parse_file(path, p);
    if (rc) return rc;
    *n_vertices = (long)(p.verts.size() / 3);
    *n_faces = (long)(p.faces.size() / 3);
    return 0;
}

int obj_parse(const char* path, float* vertices, int* faces, float* normals) {
    Parsed p;
    int rc = parse_file(path, p);
    if (rc) return rc;
    std::memcpy(vertices, p.verts.data(), p.verts.size() * sizeof(float));
    std::memcpy(faces, p.faces.data(), p.faces.size() * sizeof(int));
    if (normals && p.normals.size() == p.verts.size()) {
        std::memcpy(normals, p.normals.data(),
                    p.normals.size() * sizeof(float));
    } else if (normals) {
        std::memset(normals, 0, p.verts.size() * sizeof(float));
    }
    return 0;
}

}  // extern "C"
