// artdata — native JPEG decode and resize for the artgraph_tpu_torch loader.
//
// A copy of the JAX package's runtime (artgraph_tpu/runtime/csrc/artdata.cpp),
// kept in the port so that it depends on nothing of that package. The
// reference's input hot loop is PIL's C decode + torchvision's resize inside
// DataLoader workers (ref: src/data/data.py:38-49). This library decodes
// with libjpeg and resizes with a bit-exact reimplementation of PIL's
// bilinear resampling (separable triangle filter with the same fixed-point
// coefficient rounding, Pillow Resample.c semantics), over a std::thread
// pool for batches, behind a C ABI for ctypes.
//
// Built at first use by artgraph_tpu_torch/runtime/image_cpp.py:
//   g++ -O3 -march=native -fPIC -std=c++17 -Wall artdata.cpp
//       -o libartdata-<hash>.so -shared -ljpeg -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's fixed-point precision

inline uint8_t clip8(int in) {
    if (in >= (1 << kPrecisionBits << 8)) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Triangle (bilinear) filter, support 1.0 — Pillow's bilinear_filter.
inline double triangle(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// Precompute Pillow-style resampling coefficients for one axis.
// Returns ksize; fills bounds (xmin, xcount per output pixel) and int coeffs.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int>& kk) {
    const double scale = static_cast<double>(in_size) / out_size;
    const double filterscale = std::max(scale, 1.0);
    const double support = 1.0 * filterscale;  // bilinear support = 1
    const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    bounds.resize(out_size * 2);
    kk.resize(out_size * ksize);
    std::vector<double> w(ksize);

    for (int xx = 0; xx < out_size; ++xx) {
        const double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (int x = 0; x < xmax; ++x) {
            double wv = triangle((x + xmin - center + 0.5) / filterscale);
            w[x] = wv;
            ww += wv;
        }
        for (int x = 0; x < xmax; ++x) {
            if (ww != 0.0) w[x] /= ww;
            // Pillow rounds half away from zero here
            double v = w[x] * (1 << kPrecisionBits);
            kk[xx * ksize + x] = static_cast<int>(
                v < 0 ? v - 0.5 : v + 0.5);
        }
        for (int x = xmax; x < ksize; ++x) kk[xx * ksize + x] = 0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    return ksize;
}

// Horizontal resample pass: [h, in_w, 3] u8 -> [h, out_w, 3] u8.
void resample_horizontal(const uint8_t* in, int h, int in_w, uint8_t* out,
                         int out_w, const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
    const int half = 1 << (kPrecisionBits - 1);
    for (int yy = 0; yy < h; ++yy) {
        const uint8_t* row = in + static_cast<size_t>(yy) * in_w * 3;
        uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
        for (int xx = 0; xx < out_w; ++xx) {
            const int xmin = bounds[xx * 2 + 0];
            const int xcount = bounds[xx * 2 + 1];
            const int* k = &kk[xx * ksize];
            int ss0 = half, ss1 = half, ss2 = half;
            for (int x = 0; x < xcount; ++x) {
                const uint8_t* px = row + static_cast<size_t>(x + xmin) * 3;
                ss0 += px[0] * k[x];
                ss1 += px[1] * k[x];
                ss2 += px[2] * k[x];
            }
            orow[xx * 3 + 0] = clip8(ss0);
            orow[xx * 3 + 1] = clip8(ss1);
            orow[xx * 3 + 2] = clip8(ss2);
        }
    }
}

// Vertical resample pass: [in_h, w, 3] u8 -> [out_h, w, 3] u8.
void resample_vertical(const uint8_t* in, int in_h, int w, uint8_t* out,
                       int out_h, const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
    const int half = 1 << (kPrecisionBits - 1);
    for (int yy = 0; yy < out_h; ++yy) {
        const int ymin = bounds[yy * 2 + 0];
        const int ycount = bounds[yy * 2 + 1];
        const int* k = &kk[yy * ksize];
        uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
        for (int xx = 0; xx < w * 3; ++xx) {
            int ss = half;
            for (int y = 0; y < ycount; ++y) {
                ss += in[static_cast<size_t>(y + ymin) * w * 3 + xx] * k[y];
            }
            orow[xx] = clip8(ss);
        }
    }
}

// PIL-equivalent bilinear resize (horizontal pass, then vertical).
void pil_bilinear_resize(const uint8_t* in, int in_h, int in_w, uint8_t* out,
                         int out_h, int out_w) {
    std::vector<int> bounds, kk;
    std::vector<uint8_t> temp(static_cast<size_t>(in_h) * out_w * 3);
    int ksize = precompute_coeffs(in_w, out_w, bounds, kk);
    resample_horizontal(in, in_h, in_w, temp.data(), out_w, bounds, kk, ksize);
    ksize = precompute_coeffs(in_h, out_h, bounds, kk);
    resample_vertical(temp.data(), in_h, out_w, out, out_h, bounds, kk, ksize);
}

struct JpegErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG byte buffer to tightly-packed RGB u8. Returns 0 on success.
int decode_jpeg_rgb(const uint8_t* data, size_t len,
                    std::vector<uint8_t>& pixels, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *h = cinfo.output_height;
    *w = cinfo.output_width;
    pixels.resize(static_cast<size_t>(*h) * *w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = pixels.data() +
                       static_cast<size_t>(cinfo.output_scanline) * *w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    // tolerate truncated JPEGs (ref: data.py:9 LOAD_TRUNCATED_IMAGES)
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // namespace

extern "C" {

// Decode one JPEG buffer and resize to [out_h, out_w, 3] u8. Returns 0 ok.
int artdata_decode_resize(const uint8_t* jpeg, long jpeg_len, int out_h,
                          int out_w, uint8_t* out) {
    std::vector<uint8_t> pixels;
    int h = 0, w = 0;
    if (decode_jpeg_rgb(jpeg, static_cast<size_t>(jpeg_len), pixels, &h, &w))
        return 1;
    pil_bilinear_resize(pixels.data(), h, w, out, out_h, out_w);
    return 0;
}

// Resize a raw RGB u8 image (no decode). Returns 0.
int artdata_resize(const uint8_t* in, int in_h, int in_w, int out_h,
                   int out_w, uint8_t* out) {
    pil_bilinear_resize(in, in_h, in_w, out, out_h, out_w);
    return 0;
}

// Decode+resize a batch of JPEG files in parallel.
// paths: array of n C strings; out: [n, out_h, out_w, 3] u8;
// status: per-item 0 ok / nonzero error. Returns count of failures.
int artdata_decode_batch(const char** paths, int n, int out_h, int out_w,
                         int threads, uint8_t* out, int* status) {
    std::atomic<int> next(0);
    std::atomic<int> failures(0);
    const size_t item = static_cast<size_t>(out_h) * out_w * 3;

    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            FILE* f = fopen(paths[i], "rb");
            if (!f) { status[i] = 2; failures++; continue; }
            fseek(f, 0, SEEK_END);
            const long len = ftell(f);
            fseek(f, 0, SEEK_SET);
            std::vector<uint8_t> buf(static_cast<size_t>(len));
            const size_t got = fread(buf.data(), 1, buf.size(), f);
            fclose(f);
            status[i] = artdata_decode_resize(buf.data(),
                                              static_cast<long>(got), out_h,
                                              out_w, out + item * i);
            if (status[i]) failures++;
        }
    };

    if (threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return failures.load();
}

}  // extern "C"
