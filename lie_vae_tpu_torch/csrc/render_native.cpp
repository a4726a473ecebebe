// Host C++ for the data path: the native sphere-cube renderer and the PNG
// row unfilter. Built with g++ into build/native/ and loaded with ctypes by
// data/_native.py; ctypes releases the GIL around each call, so the
// loader's threads overlap them.
//
// render_spherecube_native is a copy of the JAX package's
// data/_render_native.cpp, the C++ twin of the numpy ray-caster in
// data/render.py:
// - the numpy pipeline promotes to float64 at the ray-direction einsum
//   (linspace is float64), so everything here runs in double and only the
//   final image is float32;
// - ties in the slab argmax resolve to the FIRST max (numpy argmax).
//
// png_unfilter undoes PNG's five row filters (None, Sub, Up, Average,
// Paeth; PNG spec, section 9) in place of a per-byte Python loop.
//
// Build: g++ -O3 -shared -fPIC render_native.cpp -o librender_native.so
// (no -ffast-math: keeps IEEE semantics identical to numpy).
#include <cmath>
#include <cstdint>
#include <limits>

namespace {

const double FACE_COLORS[6][3] = {
    {0.85, 0.10, 0.10}, {0.10, 0.60, 0.85}, {0.10, 0.75, 0.20},
    {0.85, 0.65, 0.10}, {0.80, 0.15, 0.75}, {0.95, 0.95, 0.95},
};
const double HALF = 1.0;
const double SPHERE_R = 1.15;
const double CAM_DIST = 5.0;

struct Style {
    double fov, ambient, light[3];
};

inline double clip01(double x) { return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x); }

}  // namespace

extern "C" void render_spherecube_native(
    const float* R,      // (n, 3, 3) row-major world-from-object rotations
    int64_t n, int64_t size,
    int style_id,        // 0 = v1, 1 = v2
    float* out)          // (n, size, size, 3)
{
    Style style;
    if (style_id == 0) {
        style.fov = 0.45; style.ambient = 0.35;
        double l[3] = {0.5, 0.7, 0.6};
        double norm = std::sqrt(l[0]*l[0] + l[1]*l[1] + l[2]*l[2]);
        for (int k = 0; k < 3; ++k) style.light[k] = l[k] / norm;
    } else {
        style.fov = 0.33; style.ambient = 0.50;
        double l[3] = {0.4, -0.75, 0.55};
        double norm = std::sqrt(l[0]*l[0] + l[1]*l[1] + l[2]*l[2]);
        for (int k = 0; k < 3; ++k) style.light[k] = l[k] / norm;
    }
    const double eps = 1e-9;
    const double inf = std::numeric_limits<double>::infinity();

    for (int64_t im = 0; im < n; ++im) {
        // match numpy: R is float32; promote each entry to double once
        double Rt[3][3];  // R^T
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b)
                Rt[a][b] = (double)R[im * 9 + b * 3 + a];

        const double origin[3] = {0.0, -CAM_DIST, 0.0};
        double o[3], l[3];
        for (int a = 0; a < 3; ++a) {
            o[a] = Rt[a][0]*origin[0] + Rt[a][1]*origin[1] + Rt[a][2]*origin[2];
            l[a] = Rt[a][0]*style.light[0] + Rt[a][1]*style.light[1]
                 + Rt[a][2]*style.light[2];
        }
        const double oo = o[0]*o[0] + o[1]*o[1] + o[2]*o[2];

        for (int64_t i = 0; i < size; ++i) {
            // ys = linspace(1,-1,size) rows, xs = linspace(-1,1,size) cols
            double y = 1.0 - 2.0 * (double)i / (double)(size - 1);
            for (int64_t j = 0; j < size; ++j) {
                double x = -1.0 + 2.0 * (double)j / (double)(size - 1);
                double dw[3] = {x * style.fov, 1.0, y * style.fov};
                double dn = std::sqrt(dw[0]*dw[0] + dw[1]*dw[1] + dw[2]*dw[2]);
                for (int a = 0; a < 3; ++a) dw[a] /= dn;
                double d[3];
                for (int a = 0; a < 3; ++a)
                    d[a] = Rt[a][0]*dw[0] + Rt[a][1]*dw[1] + Rt[a][2]*dw[2];

                // cube slab test
                double tmin_ax[3], tmax_ax[3];
                for (int a = 0; a < 3; ++a) {
                    double da = d[a];
                    if (std::fabs(da) < eps) da = std::copysign(eps, da);
                    double inv = 1.0 / da;
                    double t1 = (-HALF - o[a]) * inv;
                    double t2 = ( HALF - o[a]) * inv;
                    tmin_ax[a] = t1 < t2 ? t1 : t2;
                    tmax_ax[a] = t1 < t2 ? t2 : t1;
                }
                double t_in_cube = tmin_ax[0];
                int face_axis = 0;
                for (int a = 1; a < 3; ++a)   // first-max tie rule (argmax)
                    if (tmin_ax[a] > t_in_cube) { t_in_cube = tmin_ax[a]; face_axis = a; }
                double t_out_cube = tmax_ax[0];
                for (int a = 1; a < 3; ++a)
                    if (tmax_ax[a] < t_out_cube) t_out_cube = tmax_ax[a];

                // sphere
                double b = o[0]*d[0] + o[1]*d[1] + o[2]*d[2];
                double c = oo - SPHERE_R * SPHERE_R;
                double disc = b*b - c;
                double sq = std::sqrt(disc > 0.0 ? disc : 0.0);
                double t_in_sph = -b - sq, t_out_sph = -b + sq;
                bool sph_ok = disc > 0.0;

                double t_enter = t_in_cube > t_in_sph ? t_in_cube : t_in_sph;
                double t_exit = t_out_cube < t_out_sph ? t_out_cube : t_out_sph;
                bool hit = sph_ok && (t_enter < t_exit) && (t_exit > 0.0)
                           && (t_enter > 0.0);

                float* px = out + ((im * size + i) * size + j) * 3;
                if (!hit) {
                    px[0] = px[1] = px[2] = 0.05f;
                    continue;
                }

                double p[3];
                for (int a = 0; a < 3; ++a) p[a] = o[a] + t_enter * d[a];

                bool cube_bounds = t_in_cube >= t_in_sph;
                double albedo[3], normal[3];
                if (cube_bounds) {
                    double sgn = d[face_axis] > 0.0 ? 1.0
                               : (d[face_axis] < 0.0 ? -1.0 : 0.0);
                    for (int a = 0; a < 3; ++a) normal[a] = 0.0;
                    normal[face_axis] = -sgn;
                    int face_idx = face_axis * 2 + (sgn > 0.0 ? 1 : 0);
                    for (int a = 0; a < 3; ++a)
                        albedo[a] = FACE_COLORS[face_idx][a];
                    if (style_id == 1) {
                        int u_ax = face_axis == 0 ? 1 : 0;
                        int v_ax = face_axis == 2 ? 1 : 2;
                        double u = p[u_ax], v = p[v_ax];
                        long cu = (long)std::floor((u + 1.0) * 2.0);
                        long cv = (long)std::floor((v + 1.0) * 2.0);
                        long checker = (((cu + cv) % 2) + 2) % 2;
                        if (checker == 0)
                            albedo[0] = albedo[1] = albedo[2] = 0.95;
                        double ramp = 0.55 + 0.45 * (u + 1.0) * 0.5;
                        for (int a = 0; a < 3; ++a) albedo[a] *= ramp;
                    }
                } else {
                    double pn = std::sqrt(p[0]*p[0] + p[1]*p[1] + p[2]*p[2]);
                    if (pn < 1e-9) pn = 1e-9;
                    for (int a = 0; a < 3; ++a) normal[a] = p[a] / pn;
                    for (int a = 0; a < 3; ++a)
                        albedo[a] = 0.5 + 0.45 * normal[a];
                    if (style_id == 1) {
                        double band = 0.5 + 0.5 * std::sin(
                            7.0 * std::atan2(normal[1], normal[0])
                            + 9.0 * normal[2]);
                        double m = 0.45 + 0.55 * band;
                        for (int a = 0; a < 3; ++a) albedo[a] *= m;
                    }
                }

                double lambert = clip01(normal[0]*l[0] + normal[1]*l[1]
                                        + normal[2]*l[2]);
                double shade = style.ambient + (1.0 - style.ambient) * lambert;
                for (int a = 0; a < 3; ++a)
                    px[a] = (float)(albedo[a] * shade);
            }
        }
    }
}

// Undo the row filters of a batch of decompressed PNG scanlines.
// src: rows * (1 + row_bytes) bytes, each row a filter-type byte then
// row_bytes filtered bytes; rows_per_image rows make one image (the row
// above an image's first row is zero); bpp: bytes per complete pixel.
// dst: rows * row_bytes unfiltered bytes. Returns 0, or 1 + the index of
// the first row whose filter type is not 0-4.
extern "C" int64_t png_unfilter(
    const uint8_t* src, int64_t rows, int64_t rows_per_image,
    int64_t row_bytes, int64_t bpp, uint8_t* dst)
{
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* in = src + r * (row_bytes + 1);
        const uint8_t type = in[0];
        ++in;
        uint8_t* out = dst + r * row_bytes;
        const uint8_t* up = (r % rows_per_image) ? out - row_bytes : nullptr;
        switch (type) {
        case 0:
            for (int64_t x = 0; x < row_bytes; ++x) out[x] = in[x];
            break;
        case 1:
            for (int64_t x = 0; x < row_bytes; ++x)
                out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < row_bytes; ++x)
                out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < row_bytes; ++x) {
                int a = x >= bpp ? out[x - bpp] : 0;
                int b = up ? up[x] : 0;
                out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < row_bytes; ++x) {
                int a = x >= bpp ? out[x - bpp] : 0;
                int b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            return r + 1;
        }
    }
    return 0;
}
