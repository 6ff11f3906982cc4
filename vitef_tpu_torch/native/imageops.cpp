// Native batched image ops for the host side of the data pipeline.
//
// The port's own copy of vitef_tpu/native/imageops.cpp (the port imports
// nothing of the JAX package); the two are held bit-equal by
// tests/test_torch_isolation.py.
//
// The reference's data pipeline gets its native speed from torchvision/PIL C
// code driven per sample from Python (reference src/vitef/data/images/*.py
// __getitem__ → PIL resize/crop). Here the whole *batch* is processed in one
// call with OpenMP across images, removing the per-sample Python overhead —
// and the resampling is bit-exact with Pillow's 8bpc bilinear path
// (Resample.c): fixed-point coefficients with PRECISION_BITS = 32-8-2,
// horizontal-then-vertical passes with a uint8 intermediate, so the eval
// transform stays bit-comparable to torchvision (SURVEY §7.3 hard part 1).
//
// Exposed C ABI (ctypes):
//   resize_bilinear_batch : (N,H,W,C) u8 → (N,OH,OW,C) u8, PIL BILINEAR
//   eval_transform_batch  : Resize(shorter→size) + CenterCrop(size), per batch
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 (vitef_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow Resample.c

inline double bilinear_filter(double x) {  // triangle filter, support 1
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

inline uint8_t clip8(int in) {
    if (in >= (255 << PRECISION_BITS)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

// Pillow precompute_coeffs for the BILINEAR filter over [0, in_size) → out_size.
// Returns bounds (xmin, xmax-count) and normalized fixed-point coefficients.
struct Coeffs {
    int ksize;
    std::vector<int> bounds;  // 2 * out_size: (xmin, count)
    std::vector<int> kk;      // out_size * ksize fixed-point coeffs
};

Coeffs precompute_coeffs(int in_size, int out_size) {
    Coeffs c;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // BILINEAR support = 1
    c.ksize = (int)ceil(support) * 2 + 1;
    c.bounds.resize(2 * out_size);
    c.kk.resize((size_t)out_size * c.ksize);
    std::vector<double> k(c.ksize);
    double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; x++) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        // Pillow zero-pads the remaining taps
        for (int x = xmax; x < c.ksize; x++) k[x] = 0.0;
        for (int x = 0; x < c.ksize; x++) {
            double v = k[x] * (1 << PRECISION_BITS);
            c.kk[(size_t)xx * c.ksize + x] =
                (int)(v < 0 ? v - 0.5 : v + 0.5);  // round half away from zero
        }
        c.bounds[xx * 2 + 0] = xmin;
        c.bounds[xx * 2 + 1] = xmax;
    }
    return c;
}

// Horizontal pass: (H, W, C) u8 → (H, OW, C) u8
void resample_horizontal(const uint8_t* src, uint8_t* dst, int h, int w, int c,
                         int out_w, const Coeffs& co) {
    for (int yy = 0; yy < h; yy++) {
        const uint8_t* row = src + (size_t)yy * w * c;
        uint8_t* orow = dst + (size_t)yy * out_w * c;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = co.bounds[xx * 2 + 0];
            int xmax = co.bounds[xx * 2 + 1];
            const int* k = &co.kk[(size_t)xx * co.ksize];
            for (int ch = 0; ch < c; ch++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++)
                    ss += row[(size_t)(x + xmin) * c + ch] * k[x];
                orow[(size_t)xx * c + ch] = clip8(ss);
            }
        }
    }
}

// Vertical pass: (H, W, C) u8 → (OH, W, C) u8
void resample_vertical(const uint8_t* src, uint8_t* dst, int h, int w, int c,
                       int out_h, const Coeffs& co) {
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = co.bounds[yy * 2 + 0];
        int ymax = co.bounds[yy * 2 + 1];
        const int* k = &co.kk[(size_t)yy * co.ksize];
        uint8_t* orow = dst + (size_t)yy * w * c;
        for (int xx = 0; xx < w * c; xx++) {
            int ss = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss += src[(size_t)(y + ymin) * w * c + xx] * k[y];
            orow[xx] = clip8(ss);
        }
    }
}

// One image: PIL-exact bilinear resize (H, W, C) → (OH, OW, C).
// Pillow resizes horizontal first (into an intermediate with the SOURCE
// height), then vertical.
void resize_one(const uint8_t* src, uint8_t* dst, int h, int w, int c,
                int out_h, int out_w, const Coeffs& ch_, const Coeffs& cv_,
                std::vector<uint8_t>& tmp) {
    if (out_w != w) {
        tmp.resize((size_t)h * out_w * c);
        resample_horizontal(src, tmp.data(), h, w, c, out_w, ch_);
        if (out_h != h) {
            resample_vertical(tmp.data(), dst, h, out_w, c, out_h, cv_);
        } else {
            std::memcpy(dst, tmp.data(), (size_t)h * out_w * c);
        }
    } else if (out_h != h) {
        resample_vertical(src, dst, h, w, c, out_h, cv_);
    } else {
        std::memcpy(dst, src, (size_t)h * w * c);
    }
}

}  // namespace

extern "C" {

// (N, H, W, C) u8 → (N, out_h, out_w, C) u8 — PIL BILINEAR parity.
void resize_bilinear_batch(const uint8_t* src, uint8_t* dst, int n, int h,
                           int w, int c, int out_h, int out_w) {
    Coeffs ch_ = precompute_coeffs(w, out_w);
    Coeffs cv_ = precompute_coeffs(h, out_h);
#pragma omp parallel
    {
        std::vector<uint8_t> tmp;
#pragma omp for schedule(dynamic)
        for (int i = 0; i < n; i++) {
            resize_one(src + (size_t)i * h * w * c,
                       dst + (size_t)i * out_h * out_w * c, h, w, c, out_h,
                       out_w, ch_, cv_, tmp);
        }
    }
}

// torchvision eval transform per batch: Resize(shorter side → size, aspect
// preserved, PIL BILINEAR) + CenterCrop(size). All images share (h, w).
void eval_transform_batch(const uint8_t* src, uint8_t* dst, int n, int h,
                          int w, int c, int size) {
    // Resize target (torchvision _compute_resized_output_size: the long side
    // is TRUNCATED, not rounded)
    int ow, oh;
    if (w <= h) {
        ow = size;
        oh = std::max(1, (int)((double)size * h / w));
    } else {
        oh = size;
        ow = std::max(1, (int)((double)size * w / h));
    }
    Coeffs ch_ = precompute_coeffs(w, ow);
    Coeffs cv_ = precompute_coeffs(h, oh);
    // CenterCrop offsets: torchvision uses Python round() = half-to-even
    int top = (int)nearbyint((oh - size) / 2.0);
    int left = (int)nearbyint((ow - size) / 2.0);
    if (top < 0) top = 0;
    if (left < 0) left = 0;

#pragma omp parallel
    {
        std::vector<uint8_t> tmp, resized;
#pragma omp for schedule(dynamic)
        for (int i = 0; i < n; i++) {
            resized.resize((size_t)oh * ow * c);
            resize_one(src + (size_t)i * h * w * c, resized.data(), h, w, c,
                       oh, ow, ch_, cv_, tmp);
            uint8_t* out = dst + (size_t)i * size * size * c;
            for (int y = 0; y < size; y++) {
                std::memcpy(out + (size_t)y * size * c,
                            resized.data() + ((size_t)(y + top) * ow + left) * c,
                            (size_t)size * c);
            }
        }
    }
}

}  // extern "C"
