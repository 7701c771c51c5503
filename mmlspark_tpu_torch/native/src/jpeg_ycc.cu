// C2: the nvJPEG decoder's chroma path, on the card.  nvJPEG decodes a
// colour JPEG into its component planes (NVJPEG_OUTPUT_YUV: each plane at
// its component's own, downsampled size, straight out of the IDCT); this
// kernel upsamples them and converts to interleaved BGR with libjpeg's own
// integer arithmetic, so that the decoder's pixels differ from libjpeg's
// only by nvJPEG's IDCT.  Built with jpeg_nvjpeg.cpp into one library by
// nvcc for sm_90a (mmlspark_tpu_torch/native/__init__.py).
//
// Replaces no TPU kernel: the JAX package decodes JPEGs on the host with
// libjpeg.  The arithmetic is the Independent JPEG Group's, as
// libjpeg-turbo keeps it (jdsample.c, jdcolor.c; IJG License, copyright
// Thomas G. Lane and Guido Vollbeding, and The libjpeg-turbo Project):
//  - upsampling by the ratio of the largest sampling factors to the
//    component's: 1x1 as is; 2x1 `h2v1_fancy_upsample` (3/4 nearer + 1/4
//    further sample, biases +1 / +2, >> 2); 1x2 `h1v2_fancy_upsample`
//    (the same down the rows, biases +1 above, +2 below); 2x2
//    `h2v2_fancy_upsample` (the triangle filter on column sums 3 * nearer
//    row + further row, biases +8 / +7, >> 4); any other integer ratio,
//    and 2x1 / 2x2 on a plane 2 samples wide or less, `int_upsample`
//    (box replication).  Edge rows and columns take their own sample as
//    the neighbour beyond the edge, as libjpeg's context rows and
//    special-cased end columns do; the plane's real size is
//    ceil(image size * factor / largest factor).
//  - colour: `build_ycc_rgb_table` / `ycc_rgb_convert` (16-bit fixed
//    point, ONE_HALF rounding, the G term shifted arithmetically after
//    the two products are summed; clamped to 0..255); an RGB stream (an
//    Adobe transform 0 or R/G/B component ids) is only upsampled.
//
// Bound: bytes (each output pixel reads one value of each plane, reused
// from L1/L2 by its neighbours, and writes three).  A thread computes one
// output pixel; a block covers 256 consecutive pixels of a row-major
// image, so the plane reads of a warp are neighbours.  A simple kernel
// that is right comes first.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "jpeg_ycc.h"

namespace {

std::atomic<int64_t> g_launches{0};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// The component's upsampled sample at output (x, y).
__device__ __forceinline__ int upsample(const YccPlane& p, int x, int y) {
    const uint8_t* s = p.data;
    const int w = p.width, h = p.height, pitch = p.pitch;
    if (p.hexp == 1 && p.vexp == 1) return s[y * pitch + x];
    if (p.hexp == 2 && p.vexp == 1 && w > 2) {  // h2v1_fancy_upsample
        const int i = x >> 1;
        const uint8_t* row = s + y * pitch;
        const int near3 = 3 * row[i];
        return (x & 1) ? (near3 + row[clampi(i + 1, 0, w - 1)] + 2) >> 2
                       : (near3 + row[clampi(i - 1, 0, w - 1)] + 1) >> 2;
    }
    if (p.hexp == 1 && p.vexp == 2) {  // h1v2_fancy_upsample
        const int r = y >> 1;
        const int o = clampi((y & 1) ? r + 1 : r - 1, 0, h - 1);
        const int bias = (y & 1) ? 2 : 1;
        return (3 * s[r * pitch + x] + s[o * pitch + x] + bias) >> 2;
    }
    if (p.hexp == 2 && p.vexp == 2 && w > 2) {  // h2v2_fancy_upsample
        const int r = y >> 1;
        const int o = clampi((y & 1) ? r + 1 : r - 1, 0, h - 1);
        const uint8_t* near_row = s + r * pitch;
        const uint8_t* far_row = s + o * pitch;
        const int i = x >> 1;
        const int j = clampi((x & 1) ? i + 1 : i - 1, 0, w - 1);
        const int this_sum = 3 * near_row[i] + far_row[i];
        const int other_sum = 3 * near_row[j] + far_row[j];
        return (x & 1) ? (3 * this_sum + other_sum + 7) >> 4
                       : (3 * this_sum + other_sum + 8) >> 4;
    }
    return s[(y / p.vexp) * pitch + x / p.hexp];  // int_upsample
}

__device__ __forceinline__ uint8_t clamp255(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(256)
ycc_to_bgr_kernel(YccPlane p0, YccPlane p1, YccPlane p2, int height,
                  int width, int rgb, uint8_t* __restrict__ out) {
    const int64_t n = static_cast<int64_t>(height) * width;
    for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
         k < n; k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int y = static_cast<int>(k / width);
        const int x = static_cast<int>(k - static_cast<int64_t>(y) * width);
        const int c0 = upsample(p0, x, y);
        const int c1 = upsample(p1, x, y);
        const int c2 = upsample(p2, x, y);
        uint8_t* o = out + 3 * k;
        if (rgb) {  // R, G, B components: no conversion
            o[0] = static_cast<uint8_t>(c2);
            o[1] = static_cast<uint8_t>(c1);
            o[2] = static_cast<uint8_t>(c0);
            continue;
        }
        // jdcolor.c: Cr_r_tab, Cb_b_tab (nearest ints), Cr_g_tab +
        // Cb_g_tab (scaled, ONE_HALF folded into Cb's), SCALEBITS 16
        const int cb = c1 - 128, cr = c2 - 128;
        const int r = (91881 * cr + 32768) >> 16;   // FIX(1.40200)
        const int b = (116130 * cb + 32768) >> 16;  // FIX(1.77200)
        const int g = (-46802 * cr + -22554 * cb + 32768) >> 16;
        o[0] = clamp255(c0 + b);
        o[1] = clamp255(c0 + g);
        o[2] = clamp255(c0 + r);
    }
}

}  // namespace

extern "C" {

cudaError_t mml_ycc_launch(const YccPlane* planes, int32_t height,
                           int32_t width, int32_t rgb, uint8_t* out,
                           cudaStream_t stream) {
    const int64_t n = static_cast<int64_t>(height) * width;
    if (n <= 0) return cudaErrorInvalidValue;
    const int64_t want = (n + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
    ycc_to_bgr_kernel<<<blocks, 256, 0, stream>>>(
        planes[0], planes[1], planes[2], height, width, rgb, out);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) g_launches.fetch_add(1);
    return err;
}

// The kernel on device planes given by the caller (PyTorch tensors): each
// plane c packed at `ptrs[c]` with rows of `dims[2c + 1]` samples and
// `dims[2c]` rows, expanded by `expand[2c]` across and `expand[2c + 1]`
// down; returns the CUDA error code (0 ok).
int32_t mml_ycc_to_bgr(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                       const int32_t* dims, const int32_t* expand,
                       int32_t height, int32_t width, int32_t rgb,
                       uint8_t* out, void* stream) {
    const uint8_t* ptrs[3] = {y, cb, cr};
    YccPlane planes[3];
    for (int c = 0; c < 3; ++c) {
        planes[c] = YccPlane{ptrs[c], dims[2 * c + 1], dims[2 * c + 1],
                             dims[2 * c], expand[2 * c], expand[2 * c + 1]};
        if (planes[c].hexp < 1 || planes[c].vexp < 1) {
            return static_cast<int32_t>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int32_t>(mml_ycc_launch(
        planes, height, width, rgb, out, static_cast<cudaStream_t>(stream)));
}

int64_t mml_ycc_launches(void) { return g_launches.load(); }

void mml_ycc_reset_launches(void) { g_launches.store(0); }

}  // extern "C"
