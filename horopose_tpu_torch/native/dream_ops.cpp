// Host kernels of the port's DREAM loader: the port's copy of
// horopose_tpu/native/dream_ops.cpp, the same extern "C" functions.
//
// The reference's crop path is: paste the bbox crop into a black square
// (a full intermediate allocation) then F.interpolate(bilinear,
// align_corners=False) to the network size. This kernel fuses both
// steps: each output pixel maps through (resize o square-pad) directly
// into the source image, one pass, no intermediates. Bilinear weights
// follow the align_corners=False convention (pixel centers at i + 0.5),
// matching the reference's interpolation — NOT PIL's antialiased resize.
//
// Exposed through ctypes (see horopose_tpu_torch/native/__init__.py);
// built with g++ -O3 -march=native, as the JAX package builds its copy.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// src: H x W x 3 uint8, row-major. bbox [wmin, hmin, wmax, hmax] in source
// pixels (the square side is max(bbox_w, bbox_h); the crop is centered in
// it). dst: S x S x 3 uint8.
void crop_resize_bilinear(const uint8_t* src, int H, int W,
                          int wmin, int hmin, int wmax, int hmax,
                          uint8_t* dst, int S) {
    const int cw = wmax - wmin;
    const int ch = hmax - hmin;
    const int square = std::max(cw, ch);
    if (square <= 0 || S <= 0) {
        std::memset(dst, 0, static_cast<size_t>(S) * S * 3);
        return;
    }
    const int x_off = (square - cw) / 2;
    const int y_off = (square - ch) / 2;
    const float scale = static_cast<float>(square) / static_cast<float>(S);

    for (int oy = 0; oy < S; ++oy) {
        // align_corners=False: output center -> input coordinate
        const float sy = (oy + 0.5f) * scale - 0.5f;   // square-space y
        const float fy = sy - y_off + hmin;            // source-space y
        const int y0 = static_cast<int>(std::floor(fy));
        const float wy1 = fy - y0;
        const float wy0 = 1.0f - wy1;
        uint8_t* out_row = dst + static_cast<size_t>(oy) * S * 3;
        for (int ox = 0; ox < S; ++ox) {
            const float sx = (ox + 0.5f) * scale - 0.5f;
            const float fx = sx - x_off + wmin;
            const int x0 = static_cast<int>(std::floor(fx));
            const float wx1 = fx - x0;
            const float wx0 = 1.0f - wx1;
            float acc[3] = {0.f, 0.f, 0.f};
            // 2x2 taps; taps outside the crop window contribute zero
            // (the pasted square is black outside the crop)
            for (int dy = 0; dy < 2; ++dy) {
                const int yy = y0 + dy;
                if (yy < hmin || yy >= hmax || yy < 0 || yy >= H) continue;
                const float wy = dy ? wy1 : wy0;
                const uint8_t* row = src + (static_cast<size_t>(yy) * W) * 3;
                for (int dx = 0; dx < 2; ++dx) {
                    const int xx = x0 + dx;
                    if (xx < wmin || xx >= wmax || xx < 0 || xx >= W)
                        continue;
                    const float wgt = wy * (dx ? wx1 : wx0);
                    const uint8_t* p = row + static_cast<size_t>(xx) * 3;
                    acc[0] += wgt * p[0];
                    acc[1] += wgt * p[1];
                    acc[2] += wgt * p[2];
                }
            }
            out_row[ox * 3 + 0] = static_cast<uint8_t>(
                std::min(255.f, std::max(0.f, acc[0] + 0.5f)));
            out_row[ox * 3 + 1] = static_cast<uint8_t>(
                std::min(255.f, std::max(0.f, acc[1] + 0.5f)));
            out_row[ox * 3 + 2] = static_cast<uint8_t>(
                std::min(255.f, std::max(0.f, acc[2] + 0.5f)));
        }
    }
}

// Batched variant: N sources with identical H x W, per-sample bboxes.
void crop_resize_bilinear_batch(const uint8_t* src, int N, int H, int W,
                                const int* bboxes,  // N x 4
                                uint8_t* dst, int S) {
    const size_t src_stride = static_cast<size_t>(H) * W * 3;
    const size_t dst_stride = static_cast<size_t>(S) * S * 3;
    for (int n = 0; n < N; ++n) {
        const int* b = bboxes + n * 4;
        crop_resize_bilinear(src + n * src_stride, H, W,
                             b[0], b[1], b[2], b[3],
                             dst + n * dst_stride, S);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
#ifndef HOROPOSE_NO_JPEG
// JPEG decode via the system libjpeg — the same library PIL wraps, with the
// same default DCT method (JDCT_ISLOW), so the decoded bytes match
// Image.open(...).convert("RGB") exactly (asserted by
// tests/test_torch_port_native.py, and once a process by the canary in
// native/__init__.py). The ctypes
// call releases the GIL, so thread-pool data workers decode truly in
// parallel, and the PIL object plumbing disappears from the hot loop.

#include <cstdio>   // jpeglib.h needs FILE declared first
#include <jpeglib.h>
#include <csetjmp>

namespace {
struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jb, 1);
}
}  // namespace

extern "C" {

// Parse the header only: fills (height, width). Returns 0 on success.
int jpeg_dims(const uint8_t* data, long len, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_calc_output_dimensions(&cinfo);
    *h = static_cast<int>(cinfo.output_height);
    *w = static_cast<int>(cinfo.output_width);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Full decode into caller-allocated dst (h*w*3). Returns 0 on success.
int jpeg_decode_rgb(const uint8_t* data, long len, uint8_t* dst,
                    int h, int w) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    cinfo.err = jpeg_std_error(&err.pub);
    err.pub.error_exit = on_error;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    cinfo.out_color_space = JCS_RGB;     // gray/YCbCr -> RGB like PIL
    cinfo.dct_method = JDCT_ISLOW;       // PIL's default
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != h ||
        static_cast<int>(cinfo.output_width) != w ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    const size_t stride = static_cast<size_t>(w) * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = dst + cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // extern "C"
#endif  // HOROPOSE_NO_JPEG
