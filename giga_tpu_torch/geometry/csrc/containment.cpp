// Point-in-mesh containment via 2D triangle hashing + z-ray stabbing.
//
// Native equivalent of the reference's libmesh/triangle_hash Cython extension
// (check_mesh_contains), used to label occupancy ground truth during data
// generation and geometry evaluation. For each query point, a vertical ray
// (+z) is stabbed through the mesh; an odd crossing count above the point
// means "inside". Triangles are bucketed into a uniform 2D grid over (x, y)
// so each query touches only a handful of candidates.
//
// Exposed through a C ABI for ctypes; all buffers are caller-allocated numpy
// arrays.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Grid {
    double minx, miny, inv_cw, inv_ch;
    int nx, ny;
    // CSR-style triangle lists per cell
    std::vector<int> cell_start;
    std::vector<int> tri_idx;
};

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

}  // namespace

extern "C" {

// Returns 0 on success. out[i] = 1 if points[i] is inside the mesh.
int mesh_contains(const double* verts, int64_t /*nv*/,
                  const int64_t* faces, int64_t nf,
                  const double* points, int64_t npts,
                  uint8_t* out) {
    if (nf == 0) {
        for (int64_t i = 0; i < npts; ++i) out[i] = 0;
        return 0;
    }

    // mesh xy bounds
    double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
    for (int64_t f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            const double* v = verts + 3 * faces[3 * f + k];
            minx = std::fmin(minx, v[0]);
            maxx = std::fmax(maxx, v[0]);
            miny = std::fmin(miny, v[1]);
            maxy = std::fmax(maxy, v[1]);
        }
    }

    Grid g;
    int res = (int)std::ceil(std::sqrt((double)nf));
    g.nx = clampi(res, 1, 1024);
    g.ny = clampi(res, 1, 1024);
    double w = std::fmax(maxx - minx, 1e-12), h = std::fmax(maxy - miny, 1e-12);
    g.minx = minx;
    g.miny = miny;
    g.inv_cw = g.nx / w;
    g.inv_ch = g.ny / h;

    // count triangles per cell, then fill (CSR)
    std::vector<int> counts(g.nx * g.ny, 0);
    std::vector<int> lo_x(nf), hi_x(nf), lo_y(nf), hi_y(nf);
    for (int64_t f = 0; f < nf; ++f) {
        double tminx = 1e300, tmaxx = -1e300, tminy = 1e300, tmaxy = -1e300;
        for (int k = 0; k < 3; ++k) {
            const double* v = verts + 3 * faces[3 * f + k];
            tminx = std::fmin(tminx, v[0]);
            tmaxx = std::fmax(tmaxx, v[0]);
            tminy = std::fmin(tminy, v[1]);
            tmaxy = std::fmax(tmaxy, v[1]);
        }
        lo_x[f] = clampi((int)((tminx - g.minx) * g.inv_cw), 0, g.nx - 1);
        hi_x[f] = clampi((int)((tmaxx - g.minx) * g.inv_cw), 0, g.nx - 1);
        lo_y[f] = clampi((int)((tminy - g.miny) * g.inv_ch), 0, g.ny - 1);
        hi_y[f] = clampi((int)((tmaxy - g.miny) * g.inv_ch), 0, g.ny - 1);
        for (int cy = lo_y[f]; cy <= hi_y[f]; ++cy)
            for (int cx = lo_x[f]; cx <= hi_x[f]; ++cx) counts[cy * g.nx + cx]++;
    }
    g.cell_start.assign(g.nx * g.ny + 1, 0);
    for (int c = 0; c < g.nx * g.ny; ++c) g.cell_start[c + 1] = g.cell_start[c] + counts[c];
    g.tri_idx.resize(g.cell_start.back());
    std::vector<int> fill(g.nx * g.ny, 0);
    for (int64_t f = 0; f < nf; ++f)
        for (int cy = lo_y[f]; cy <= hi_y[f]; ++cy)
            for (int cx = lo_x[f]; cx <= hi_x[f]; ++cx) {
                int c = cy * g.nx + cx;
                g.tri_idx[g.cell_start[c] + fill[c]++] = (int)f;
            }

    // stab a +z ray from each point
    for (int64_t i = 0; i < npts; ++i) {
        const double px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
        if (px < minx || px > maxx || py < miny || py > maxy) {
            out[i] = 0;
            continue;
        }
        int cx = clampi((int)((px - g.minx) * g.inv_cw), 0, g.nx - 1);
        int cy = clampi((int)((py - g.miny) * g.inv_ch), 0, g.ny - 1);
        int c = cy * g.nx + cx;
        int crossings = 0;
        for (int s = g.cell_start[c]; s < g.cell_start[c + 1]; ++s) {
            const int64_t* fc = faces + 3 * (int64_t)g.tri_idx[s];
            const double* a = verts + 3 * fc[0];
            const double* b = verts + 3 * fc[1];
            const double* d = verts + 3 * fc[2];
            // 2D barycentric test in (x, y)
            const double v0x = b[0] - a[0], v0y = b[1] - a[1];
            const double v1x = d[0] - a[0], v1y = d[1] - a[1];
            const double det = v0x * v1y - v0y * v1x;
            if (std::fabs(det) < 1e-300) continue;  // vertical triangle
            const double qx = px - a[0], qy = py - a[1];
            const double u = (qx * v1y - qy * v1x) / det;
            const double v = (v0x * qy - v0y * qx) / det;
            if (u < 0.0 || v < 0.0 || u + v > 1.0) continue;
            const double z = a[2] + u * (b[2] - a[2]) + v * (d[2] - a[2]);
            if (z > pz) crossings++;
        }
        out[i] = (uint8_t)(crossings & 1);
    }
    return 0;
}

}  // extern "C"
