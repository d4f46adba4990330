// Exact surface voxelization via triangle/AABB overlap (separating-axis
// test). Native equivalent of the reference's libvoxelize (tribox2.h):
// marks every voxel whose cell intersects any triangle of the mesh.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct V3 {
    double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// SAT triangle / axis-aligned box (box centered at origin, half-size h).
bool tri_box_overlap(const V3& h, V3 v0, V3 v1, V3 v2) {
    // 1) box face normals: AABB of triangle vs box
    auto minmax = [](double a, double b, double c, double& lo, double& hi) {
        lo = std::min(a, std::min(b, c));
        hi = std::max(a, std::max(b, c));
    };
    double lo, hi;
    minmax(v0.x, v1.x, v2.x, lo, hi);
    if (lo > h.x || hi < -h.x) return false;
    minmax(v0.y, v1.y, v2.y, lo, hi);
    if (lo > h.y || hi < -h.y) return false;
    minmax(v0.z, v1.z, v2.z, lo, hi);
    if (lo > h.z || hi < -h.z) return false;

    // 2) triangle plane vs box
    V3 e0 = sub(v1, v0), e1 = sub(v2, v1), e2 = sub(v0, v2);
    V3 n = cross(e0, e1);
    double d = -dot(n, v0);
    double r = h.x * std::fabs(n.x) + h.y * std::fabs(n.y) + h.z * std::fabs(n.z);
    if (std::fabs(d) > r) return false;  // plane distance at box center = d

    // 3) nine cross-product axes a = e_i x unit_j
    const V3 edges[3] = {e0, e1, e2};
    const V3 verts[3] = {v0, v1, v2};
    for (int i = 0; i < 3; ++i) {
        const V3& e = edges[i];
        const V3 axes[3] = {
            {0.0, -e.z, e.y},  // e x X
            {e.z, 0.0, -e.x},  // e x Y
            {-e.y, e.x, 0.0},  // e x Z
        };
        for (int j = 0; j < 3; ++j) {
            const V3& a = axes[j];
            double p0 = dot(a, verts[0]);
            double p1 = dot(a, verts[1]);
            double p2 = dot(a, verts[2]);
            double mn = std::min(p0, std::min(p1, p2));
            double mx = std::max(p0, std::max(p1, p2));
            double rad = h.x * std::fabs(a.x) + h.y * std::fabs(a.y) + h.z * std::fabs(a.z);
            if (mn > rad || mx < -rad) return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Marks out[ix, iy, iz] = 1 for every voxel of a (res, res, res) grid over
// [lo, hi]^3 intersected by the mesh surface.
int voxelize_surface_exact(const double* verts, int64_t /*nv*/,
                           const int64_t* faces, int64_t nf,
                           int64_t res,
                           const double* lo, const double* hi,
                           uint8_t* out) {
    const double cell[3] = {(hi[0] - lo[0]) / res, (hi[1] - lo[1]) / res, (hi[2] - lo[2]) / res};
    const V3 half = {cell[0] / 2, cell[1] / 2, cell[2] / 2};

    for (int64_t f = 0; f < nf; ++f) {
        const double* a = verts + 3 * faces[3 * f];
        const double* b = verts + 3 * faces[3 * f + 1];
        const double* c = verts + 3 * faces[3 * f + 2];
        // voxel index range of the triangle's AABB (clamped)
        int64_t i0[3], i1[3];
        for (int d = 0; d < 3; ++d) {
            double tmin = std::min(a[d], std::min(b[d], c[d]));
            double tmax = std::max(a[d], std::max(b[d], c[d]));
            i0[d] = std::max<int64_t>(0, (int64_t)std::floor((tmin - lo[d]) / cell[d]));
            i1[d] = std::min<int64_t>(res - 1, (int64_t)std::floor((tmax - lo[d]) / cell[d]));
        }
        for (int64_t ix = i0[0]; ix <= i1[0]; ++ix)
            for (int64_t iy = i0[1]; iy <= i1[1]; ++iy)
                for (int64_t iz = i0[2]; iz <= i1[2]; ++iz) {
                    uint8_t* cellp = out + (ix * res + iy) * res + iz;
                    if (*cellp) continue;
                    V3 center = {lo[0] + (ix + 0.5) * cell[0],
                                 lo[1] + (iy + 0.5) * cell[1],
                                 lo[2] + (iz + 0.5) * cell[2]};
                    V3 tv0 = {a[0] - center.x, a[1] - center.y, a[2] - center.z};
                    V3 tv1 = {b[0] - center.x, b[1] - center.y, b[2] - center.z};
                    V3 tv2 = {c[0] - center.x, c[1] - center.y, c[2] - center.z};
                    if (tri_box_overlap(half, tv0, tv1, tv2)) *cellp = 1;
                }
    }
    return 0;
}

}  // extern "C"
