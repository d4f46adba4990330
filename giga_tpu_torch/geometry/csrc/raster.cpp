// Offscreen triangle rasterizer: z-buffered perspective projection with flat
// Lambertian shading over per-face RGBA colors.
//
// Native replacement for the reference's pyrender OffscreenRenderer usage
// (reference src/vgn/utils/visual.py feeding rendered affordance imagery into
// experiment reports) in environments without a GL stack: pinhole camera,
// camera-frame vertices in, RGB image out. Alpha blends translucent faces
// (e.g. gripper glyphs) over the opaque pass.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

static inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

static inline double dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

static inline Vec3 normalized(const Vec3& a) {
    double n = std::sqrt(dot(a, a));
    if (n < 1e-300) return {0, 0, 1};
    return {a.x / n, a.y / n, a.z / n};
}

}  // namespace

extern "C" {

// verts_cam: (nv, 3) camera-frame positions (+z into the scene).
// faces: (nf, 3); face_colors: (nf, 4) RGBA, alpha<255 = translucent.
// light: 3 camera-frame direction TOWARD the scene. out_rgb: (h, w, 3)
// pre-filled with the background. zbuf: (h, w) scratch (any contents).
int raster_mesh(const double* verts_cam, int64_t nv,
                const int64_t* faces, int64_t nf,
                const uint8_t* face_colors,
                double fx, double fy, double cx, double cy,
                int64_t w, int64_t h,
                double ambient, double znear,
                const double* light,
                uint8_t* out_rgb, double* zbuf) {
    (void)nv;
    for (int64_t i = 0; i < w * h; ++i) zbuf[i] = 1e300;
    Vec3 L = normalized({light[0], light[1], light[2]});

    // screen-space projections reused across passes
    std::vector<double> su(3), sv(3), sz(3);

    // two passes: opaque faces write depth; translucent faces then blend
    // against it (depth-tested, no depth write) so glyphs occlude correctly.
    for (int pass = 0; pass < 2; ++pass) {
        for (int64_t f = 0; f < nf; ++f) {
            uint8_t alpha = face_colors[4 * f + 3];
            bool translucent = alpha < 255;
            if ((pass == 0) == translucent) continue;

            const int64_t* tri = faces + 3 * f;
            Vec3 p[3];
            bool clipped = false;
            for (int k = 0; k < 3; ++k) {
                const double* v = verts_cam + 3 * tri[k];
                p[k] = {v[0], v[1], v[2]};
                if (p[k].z <= znear) clipped = true;  // no near-plane clipping: skip
            }
            if (clipped) continue;

            for (int k = 0; k < 3; ++k) {
                su[k] = fx * p[k].x / p[k].z + cx;
                sv[k] = fy * p[k].y / p[k].z + cy;
                sz[k] = 1.0 / p[k].z;  // screen-linear
            }

            double area = (su[1] - su[0]) * (sv[2] - sv[0]) -
                          (sv[1] - sv[0]) * (su[2] - su[0]);
            if (std::fabs(area) < 1e-12) continue;

            Vec3 n = normalized(cross({p[1].x - p[0].x, p[1].y - p[0].y, p[1].z - p[0].z},
                                      {p[2].x - p[0].x, p[2].y - p[0].y, p[2].z - p[0].z}));
            double lambert = std::fabs(dot(n, L));  // two-sided
            double shade = ambient + (1.0 - ambient) * lambert;

            double r = face_colors[4 * f + 0] * shade;
            double g = face_colors[4 * f + 1] * shade;
            double b = face_colors[4 * f + 2] * shade;
            double a01 = alpha / 255.0;

            int64_t x0 = (int64_t)std::floor(std::fmin(su[0], std::fmin(su[1], su[2])));
            int64_t x1 = (int64_t)std::ceil(std::fmax(su[0], std::fmax(su[1], su[2])));
            int64_t y0 = (int64_t)std::floor(std::fmin(sv[0], std::fmin(sv[1], sv[2])));
            int64_t y1 = (int64_t)std::ceil(std::fmax(sv[0], std::fmax(sv[1], sv[2])));
            if (x0 < 0) x0 = 0;
            if (y0 < 0) y0 = 0;
            if (x1 >= w) x1 = w - 1;
            if (y1 >= h) y1 = h - 1;

            double inv_area = 1.0 / area;
            for (int64_t y = y0; y <= y1; ++y) {
                for (int64_t x = x0; x <= x1; ++x) {
                    double px = x + 0.5, py = y + 0.5;
                    double w0 = ((su[1] - px) * (sv[2] - py) - (sv[1] - py) * (su[2] - px)) * inv_area;
                    double w1 = ((su[2] - px) * (sv[0] - py) - (sv[2] - py) * (su[0] - px)) * inv_area;
                    double w2 = 1.0 - w0 - w1;
                    if (w0 < 0 || w1 < 0 || w2 < 0) continue;
                    double invz = w0 * sz[0] + w1 * sz[1] + w2 * sz[2];
                    double z = 1.0 / invz;
                    int64_t pix = y * w + x;
                    if (pass == 0) {
                        if (z < zbuf[pix]) {
                            zbuf[pix] = z;
                            uint8_t* o = out_rgb + 3 * pix;
                            o[0] = (uint8_t)(r + 0.5);
                            o[1] = (uint8_t)(g + 0.5);
                            o[2] = (uint8_t)(b + 0.5);
                        }
                    } else if (z <= zbuf[pix]) {  // blend, keep depth
                        uint8_t* o = out_rgb + 3 * pix;
                        o[0] = (uint8_t)(a01 * r + (1 - a01) * o[0] + 0.5);
                        o[1] = (uint8_t)(a01 * g + (1 - a01) * o[1] + 0.5);
                        o[2] = (uint8_t)(a01 * b + (1 - a01) * o[2] + 0.5);
                    }
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
