// Native marching-cubes core for mesh export.
//
// Counterpart of the reference's mc_lib (cpp/third/mesh/
// MarchingCubes.{h,cpp}, MarchingCubesNoColor.{h,cpp}): zero-isosurface
// extraction with edge-interpolated vertices/colors and the all-8-corner
// weight gate (MarchingCubes.cpp:528-535).  The triangle LUT is passed in
// from Python (psgradientsdf/ops/mc_tables.py derives it at import
// time), so the native and numpy paths produce identical topology.
//
// Exported C ABI (ctypes):
//   mc_extract(...)  -> fills malloc'd vertex/face/color buffers
//   mc_free(ptr)     -> frees a buffer returned by mc_extract
//
// Grid layout: phi[Z][Y][X] row-major (X fastest), inside = phi > level.
// Corner/edge numbering matches mc_tables.py (Lorensen/Bourke).

#include <cstdint>
#include <cstdio>
#include <clocale>
#include <locale.h>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

const int CORNERS[8][3] = {
    // (x, y, z)
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

const int EDGES[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0},
    {4, 5}, {5, 6}, {6, 7}, {7, 4},
    {0, 4}, {1, 5}, {2, 6}, {3, 7},
};

struct V3 { float x, y, z; };

}  // namespace


namespace {
// Pins LC_NUMERIC to "C" for the current thread so %g always prints a
// '.' decimal point regardless of the embedding process's locale (the
// Python fallback formatter is locale-independent; this keeps parity).
struct CNumericLocale {
  locale_t loc = (locale_t)0;
  locale_t old = (locale_t)0;
  CNumericLocale() {
    loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
    if (loc) old = uselocale(loc);
  }
  ~CNumericLocale() {
    if (loc) {
      uselocale(old);
      freelocale(loc);
    }
  }
};
}  // namespace

extern "C" {

// Returns 0 on success.  Caller frees out_* with mc_free.
int mc_extract(
    const float* phi,      // [Z*Y*X]
    const float* weight,   // [Z*Y*X] or nullptr (no gate)
    const float* color,    // [Z*Y*X*3] or nullptr
    const float* grad,     // [Z*Y*X*3] or nullptr: Gradient-MC placement
                           // (GradMarchingCubes.cpp:708-715, minus its
                           // color-channel index bug): vertex at the edge's
                           // low corner displaced by phi_lo/voxel along the
                           // corner's normalized gradient; colors from the
                           // low corner
    int64_t Z, int64_t Y, int64_t X,
    float level,
    const int8_t* tri_table,  // [256*16], -1 terminated triples
    float voxel, float ox, float oy, float oz,
    float** out_verts, int32_t** out_faces, float** out_colors,
    int64_t* n_verts, int64_t* n_faces) {
  *out_verts = nullptr;
  *out_faces = nullptr;
  *out_colors = nullptr;
  *n_verts = 0;
  *n_faces = 0;
  if (X < 2 || Y < 2 || Z < 2) return 0;

  const int64_t sy = X, sz = (int64_t)X * Y;
  std::vector<float> verts;     // xyz triples
  std::vector<float> cols;      // rgb triples
  std::vector<int32_t> faces;   // vertex-index triples
  // global edge key -> vertex index; key = ((z*Y + y)*X + x)*3 + axis
  std::unordered_map<int64_t, int32_t> edge_vertex;
  edge_vertex.reserve(1 << 16);

  for (int64_t z = 0; z + 1 < Z; ++z) {
    for (int64_t y = 0; y + 1 < Y; ++y) {
      const int64_t rowbase = z * sz + y * sy;
      for (int64_t x = 0; x + 1 < X; ++x) {
        const int64_t base = rowbase + x;
        float v[8];
        int cfg = 0;
        bool wok = true;
        for (int c = 0; c < 8; ++c) {
          const int64_t idx =
              base + CORNERS[c][0] + CORNERS[c][1] * sy + CORNERS[c][2] * sz;
          v[c] = phi[idx];
          if (v[c] > level) cfg |= 1 << c;
          if (weight && !(weight[idx] > 0.0f)) wok = false;
        }
        if (cfg == 0 || cfg == 255 || !wok) continue;

        const int8_t* tri = tri_table + cfg * 16;
        for (int t = 0; t < 16 && tri[t] >= 0; t += 3) {
          int32_t vid[3];
          for (int k = 0; k < 3; ++k) {
            const int e = tri[t + k];
            const int a = EDGES[e][0], b = EDGES[e][1];
            // canonical low corner + axis of the edge
            int pax = (int)x + CORNERS[a][0], pay = (int)y + CORNERS[a][1],
                paz = (int)z + CORNERS[a][2];
            int pbx = (int)x + CORNERS[b][0], pby = (int)y + CORNERS[b][1],
                pbz = (int)z + CORNERS[b][2];
            const int lx = pax < pbx ? pax : pbx;
            const int ly = pay < pby ? pay : pby;
            const int lz = paz < pbz ? paz : pbz;
            const int axis = (pax != pbx) ? 0 : (pay != pby ? 1 : 2);
            const int64_t key =
                (((int64_t)lz * Y + ly) * X + lx) * 3 + axis;
            auto it = edge_vertex.find(key);
            if (it != edge_vertex.end()) {
              vid[k] = it->second;
            } else {
              const float va = v[a], vb = v[b];
              float denom = vb - va;
              if (std::fabs(denom) < 1e-12f)
                denom = 1e-12f;
              float tt = (level - va) / denom;
              if (tt < 0.0f) tt = 0.0f;
              if (tt > 1.0f) tt = 1.0f;
              float fx, fy, fz;
              if (grad) {
                // Gradient-MC: low corner + (phi_lo/voxel) * ghat_lo
                // (double math matching the numpy path)
                const int64_t il = (int64_t)lz * sz + (int64_t)ly * sy + lx;
                double gx = grad[il * 3], gy = grad[il * 3 + 1],
                       gz = grad[il * 3 + 2];
                double gn = std::sqrt(gx * gx + gy * gy + gz * gz);
                if (gn < 1e-12) gn = 1e-12;
                const double step = (double)phi[il] / voxel;
                fx = (float)(lx + step * gx / gn);
                fy = (float)(ly + step * gy / gn);
                fz = (float)(lz + step * gz / gn);
                tt = 0.0f;      // colors from the low corner
              } else {
                fx = pax + tt * (pbx - pax);
                fy = pay + tt * (pby - pay);
                fz = paz + tt * (pbz - paz);
              }
              vid[k] = (int32_t)(verts.size() / 3);
              verts.push_back(ox + voxel * fx);
              verts.push_back(oy + voxel * fy);
              verts.push_back(oz + voxel * fz);
              if (color) {
                const int64_t ia = grad
                    ? (int64_t)lz * sz + (int64_t)ly * sy + lx
                    : (int64_t)paz * sz + (int64_t)pay * sy + pax;
                const int64_t ib = grad
                    ? ia
                    : (int64_t)pbz * sz + (int64_t)pby * sy + pbx;
                for (int ch = 0; ch < 3; ++ch) {
                  const float ca = color[ia * 3 + ch];
                  const float cb = color[ib * 3 + ch];
                  cols.push_back(ca + tt * (cb - ca));
                }
              }
              edge_vertex.emplace(key, vid[k]);
            }
          }
          faces.push_back(vid[0]);
          faces.push_back(vid[1]);
          faces.push_back(vid[2]);
        }
      }
    }
  }

  *n_verts = (int64_t)(verts.size() / 3);
  *n_faces = (int64_t)(faces.size() / 3);
  if (*n_verts) {
    *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
    std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    if (color) {
      *out_colors = (float*)std::malloc(cols.size() * sizeof(float));
      std::memcpy(*out_colors, cols.data(), cols.size() * sizeof(float));
    }
  }
  if (*n_faces) {
    *out_faces = (int32_t*)std::malloc(faces.size() * sizeof(int32_t));
    std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int32_t));
  }
  return 0;
}

void mc_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- PLY export
// ASCII PLY writers with the exact formats of the reference
// (MarchingCubes.cpp:659-697 mesh; VolumetricGradSdf.cpp:350-373 point
// cloud).  C printf "%g" matches Python's ":g" formatting, so the native
// and Python writers produce byte-identical bodies.

// Returns 0 on success.  colors nullable ([nv*3] uint8).
int ply_write_mesh(const char* path,
                   const float* verts, int64_t nv,
                   const int32_t* faces, int64_t nf,
                   const uint8_t* colors) {
  FILE* fh = std::fopen(path, "w");
  if (!fh) return 1;
  CNumericLocale numeric_guard;
  std::vector<char> buf(1 << 22);   // per-call: writers may run concurrently
  std::setvbuf(fh, buf.data(), _IOFBF, buf.size());
  std::fprintf(fh, "ply\nformat ascii 1.0\n");
  std::fprintf(fh, "element vertex %lld\n", (long long)nv);
  std::fprintf(fh, "property float x\nproperty float y\nproperty float z\n");
  if (colors)
    std::fprintf(fh,
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  std::fprintf(fh, "element face %lld\n", (long long)nf);
  std::fprintf(fh, "property list uchar int vertex_indices\n");
  std::fprintf(fh, "end_header\n");
  for (int64_t i = 0; i < nv; ++i) {
    const float* v = verts + 3 * i;
    if (colors) {
      const uint8_t* c = colors + 3 * i;
      std::fprintf(fh, "%g %g %g %d %d %d\n", v[0], v[1], v[2],
                   (int)c[0], (int)c[1], (int)c[2]);
    } else {
      std::fprintf(fh, "%g %g %g\n", v[0], v[1], v[2]);
    }
  }
  for (int64_t i = 0; i < nf; ++i) {
    const int32_t* f = faces + 3 * i;
    std::fprintf(fh, "3 %d %d %d\n", f[0], f[1], f[2]);
  }
  // the 4 MiB stdio buffer typically flushes inside fclose(): its return
  // value carries ENOSPC/EIO-style failures that ferror() cannot yet see
  const int rc = std::ferror(fh);
  const int crc = std::fclose(fh);
  return (rc || crc != 0) ? 1 : 0;
}

// Oriented point cloud: x y z nx ny nz r g b per line.
int ply_write_pointcloud(const char* path,
                         const float* pts, const float* normals,
                         const uint8_t* colors, int64_t n) {
  FILE* fh = std::fopen(path, "w");
  if (!fh) return 1;
  CNumericLocale numeric_guard;
  std::vector<char> buf(1 << 22);   // per-call: writers may run concurrently
  std::setvbuf(fh, buf.data(), _IOFBF, buf.size());
  std::fprintf(fh, "ply\nformat ascii 1.0\n");
  std::fprintf(fh, "element vertex %lld\n", (long long)n);
  std::fprintf(fh, "property float x\nproperty float y\nproperty float z\n");
  std::fprintf(fh, "property float nx\nproperty float ny\nproperty float nz\n");
  std::fprintf(fh,
               "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  std::fprintf(fh, "end_header\n");
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    const float* m = normals + 3 * i;
    const uint8_t* c = colors + 3 * i;
    std::fprintf(fh, "%g %g %g %g %g %g %d %d %d\n",
                 p[0], p[1], p[2], m[0], m[1], m[2],
                 (int)c[0], (int)c[1], (int)c[2]);
  }
  const int rc = std::ferror(fh);
  const int crc = std::fclose(fh);
  return (rc || crc != 0) ? 1 : 0;
}

}  // extern "C"
