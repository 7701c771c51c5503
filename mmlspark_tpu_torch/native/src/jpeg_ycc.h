// The C2 kernel's interface between jpeg_ycc.cu and jpeg_nvjpeg.cpp.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// One component plane on the card: `height` rows of `width` samples,
// `pitch` bytes apart, expanded by `hexp` across and `vexp` down to the
// image size.
struct YccPlane {
    const uint8_t* data;
    int32_t pitch;
    int32_t width;
    int32_t height;
    int32_t hexp;
    int32_t vexp;
};

extern "C" {
// Upsample three planes and convert to interleaved BGR (height x width x
// 3 uint8 at `out`) on `stream`; counts the launch.  `rgb` != 0 for an
// RGB stream (no colour conversion).  Returns cudaGetLastError().
cudaError_t mml_ycc_launch(const YccPlane* planes, int32_t height,
                           int32_t width, int32_t rgb, uint8_t* out,
                           cudaStream_t stream);
}
