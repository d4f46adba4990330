// Quadric-error-metric mesh decimation.
//
// Native equivalent of the reference's libsimplify extension
// (Fast-Quadric-Mesh-Simplification style, used by generation.py:417-420):
// per-vertex 4x4 error quadrics accumulated from incident face planes; edges
// are collapsed to the midpoint-optimal position in passes with a growing
// error threshold until the face budget is met. Collapses that would flip a
// neighboring face normal are rejected.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Quadric {
    // symmetric 4x4: stored as 10 coefficients
    double m[10];
    Quadric() { std::memset(m, 0, sizeof(m)); }
    void add_plane(double a, double b, double c, double d) {
        m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
        m[4] += b * b; m[5] += b * c; m[6] += b * d;
        m[7] += c * c; m[8] += c * d;
        m[9] += d * d;
    }
    void add(const Quadric& o) {
        for (int i = 0; i < 10; ++i) m[i] += o.m[i];
    }
    double eval(const double* v) const {
        const double x = v[0], y = v[1], z = v[2];
        return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x
             + m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y
             + m[7] * z * z + 2 * m[8] * z + m[9];
    }
};

struct V3 {
    double x, y, z;
};

inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

}  // namespace

extern "C" {

// In: mesh; Out: malloc'd simplified mesh with <= target_faces faces
// (best effort). agressiveness ~7 like the reference default.
int simplify_mesh(const double* in_verts, int64_t nv,
                  const int64_t* in_faces, int64_t nf,
                  int64_t target_faces, double aggressiveness,
                  double** out_verts, int64_t* out_nv,
                  int64_t** out_faces, int64_t* out_nf) {
    std::vector<V3> verts(nv);
    for (int64_t i = 0; i < nv; ++i)
        verts[i] = {in_verts[3 * i], in_verts[3 * i + 1], in_verts[3 * i + 2]};
    std::vector<int64_t> faces(in_faces, in_faces + 3 * nf);
    std::vector<bool> face_dead(nf, false);
    std::vector<int64_t> remap(nv);
    for (int64_t i = 0; i < nv; ++i) remap[i] = i;

    auto find = [&](int64_t v) {
        while (remap[v] != v) {
            remap[v] = remap[remap[v]];
            v = remap[v];
        }
        return v;
    };

    std::vector<Quadric> q(nv);
    auto face_plane_quadrics = [&]() {
        for (auto& qq : q) qq = Quadric();
        for (int64_t f = 0; f < nf; ++f) {
            if (face_dead[f]) continue;
            int64_t a = find(faces[3 * f]), b = find(faces[3 * f + 1]), c = find(faces[3 * f + 2]);
            V3 n = cross(sub(verts[b], verts[a]), sub(verts[c], verts[a]));
            double len = norm(n);
            if (len < 1e-300) continue;
            n = {n.x / len, n.y / len, n.z / len};
            double d = -dot(n, verts[a]);
            Quadric fq;
            fq.add_plane(n.x, n.y, n.z, d);
            q[a].add(fq);
            q[b].add(fq);
            q[c].add(fq);
        }
    };
    face_plane_quadrics();

    int64_t live_faces = nf;
    const int max_passes = 120;
    for (int pass = 0; pass < max_passes && live_faces > target_faces; ++pass) {
        double threshold = 1e-9 * std::pow((double)(pass + 3), aggressiveness);
        bool collapsed_any = false;

        // adjacency: for normal-flip checks, vertex -> incident faces
        std::vector<std::vector<int64_t>> vfaces(nv);
        for (int64_t f = 0; f < nf; ++f) {
            if (face_dead[f]) continue;
            for (int k = 0; k < 3; ++k) vfaces[find(faces[3 * f + k])].push_back(f);
        }

        for (int64_t f = 0; f < nf && live_faces > target_faces; ++f) {
            if (face_dead[f]) continue;
            for (int e = 0; e < 3; ++e) {
                int64_t v1 = find(faces[3 * f + e]);
                int64_t v2 = find(faces[3 * f + (e + 1) % 3]);
                if (v1 == v2) continue;

                // candidate position: best of v1, v2, midpoint under q1+q2
                Quadric qq = q[v1];
                qq.add(q[v2]);
                double mid[3] = {(verts[v1].x + verts[v2].x) / 2,
                                 (verts[v1].y + verts[v2].y) / 2,
                                 (verts[v1].z + verts[v2].z) / 2};
                double p1[3] = {verts[v1].x, verts[v1].y, verts[v1].z};
                double p2[3] = {verts[v2].x, verts[v2].y, verts[v2].z};
                double e1 = qq.eval(p1), e2 = qq.eval(p2), em = qq.eval(mid);
                const double* best = mid;
                double err = em;
                if (e1 < err) { err = e1; best = p1; }
                if (e2 < err) { err = e2; best = p2; }
                if (err > threshold) continue;

                V3 newpos = {best[0], best[1], best[2]};

                // reject if any surviving incident face flips its normal —
                // BOTH rings move: faces touching v1 move because v1 takes
                // newpos, faces touching only v2 move because v2 remaps
                // onto newpos too
                auto ring_flips = [&](int64_t moved) {
                    for (int64_t vf : vfaces[moved]) {
                        if (face_dead[vf]) continue;
                        int64_t a = find(faces[3 * vf]);
                        int64_t b = find(faces[3 * vf + 1]);
                        int64_t c = find(faces[3 * vf + 2]);
                        if ((a == v1 || b == v1 || c == v1) &&
                            (a == v2 || b == v2 || c == v2))
                            continue;  // face dies in the collapse
                        V3 pa = verts[a], pb = verts[b], pc = verts[c];
                        V3 n0 = cross(sub(pb, pa), sub(pc, pa));
                        V3 qa = a == moved ? newpos : pa;
                        V3 qb = b == moved ? newpos : pb;
                        V3 qc = c == moved ? newpos : pc;
                        V3 n1 = cross(sub(qb, qa), sub(qc, qa));
                        if (dot(n0, n1) < 0) return true;
                    }
                    return false;
                };
                if (ring_flips(v1) || ring_flips(v2)) continue;

                // collapse v2 -> v1 at newpos
                verts[v1] = newpos;
                remap[v2] = v1;
                q[v1] = qq;
                // kill degenerate faces
                for (int64_t vf : vfaces[v2]) {
                    if (face_dead[vf]) continue;
                    int64_t a = find(faces[3 * vf]), b = find(faces[3 * vf + 1]), c = find(faces[3 * vf + 2]);
                    if (a == b || b == c || a == c) {
                        face_dead[vf] = true;
                        --live_faces;
                    } else {
                        vfaces[v1].push_back(vf);
                    }
                }
                collapsed_any = true;
                break;  // one collapse per face per pass
            }
        }
        if (!collapsed_any && pass > 20) break;
    }

    // compact output
    std::vector<int64_t> vid(nv, -1);
    std::vector<double> overts;
    std::vector<int64_t> ofaces;
    for (int64_t f = 0; f < nf; ++f) {
        if (face_dead[f]) continue;
        int64_t tri[3];
        bool ok = true;
        for (int k = 0; k < 3; ++k) {
            int64_t v = find(faces[3 * f + k]);
            tri[k] = v;
        }
        if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2]) ok = false;
        if (!ok) continue;
        for (int k = 0; k < 3; ++k) {
            int64_t v = tri[k];
            if (vid[v] < 0) {
                vid[v] = (int64_t)(overts.size() / 3);
                overts.push_back(verts[v].x);
                overts.push_back(verts[v].y);
                overts.push_back(verts[v].z);
            }
            ofaces.push_back(vid[v]);
        }
    }

    *out_nv = (int64_t)(overts.size() / 3);
    *out_nf = (int64_t)(ofaces.size() / 3);
    *out_verts = (double*)malloc(overts.size() * sizeof(double));
    *out_faces = (int64_t*)malloc(ofaces.size() * sizeof(int64_t));
    if ((!*out_verts && !overts.empty()) || (!*out_faces && !ofaces.empty())) return 1;
    std::memcpy(*out_verts, overts.data(), overts.size() * sizeof(double));
    std::memcpy(*out_faces, ofaces.data(), ofaces.size() * sizeof(int64_t));
    return 0;
}

}  // extern "C"
