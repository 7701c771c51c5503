// The port's host JPEG decoder on nvJPEG, for a machine with the CUDA
// toolkit and no libjpeg headers: the same C entries as jpeg_libjpeg.cpp
// (the JAX package's libjpeg entries, and the component planes), so the
// Python side and the featurizer see one contract.
// mmlspark_tpu_torch/native builds this file, with the kernel of
// jpeg_ycc.cu, by nvcc only where jpeglib.h is missing and nvjpeg.h exists.
//
// A decode parses the stream and runs the Huffman stage on the calling
// thread and the IDCT on the card (nvJPEG's default backend), into the
// component planes at their own sizes (NVJPEG_OUTPUT_YUV; gray:
// NVJPEG_OUTPUT_Y straight into the output); then the C2 kernel
// (jpeg_ycc.cu) upsamples the planes and converts them to interleaved BGR
// with libjpeg's arithmetic on the same stream, and the pixels are copied
// into the caller's host buffer and waited for.  Threads decode in
// parallel: each call borrows a decoder state, a stream and device
// buffers from a pool and gives them back.
//
// Differences from libjpeg: nvJPEG's IDCT is not libjpeg's, so a sample
// may differ by a level (measured by the card tests against the libjpeg
// digests of tests/jpeg_fixtures/); there is no DCT-domain scaling
// (scale_denom other than 1 returns -4); a stream whose data ends before
// its last scan, which libjpeg reports as a warning and the libjpeg entry
// rejects, is rejected here when it has no end-of-image marker.
//
// Return codes: -1 is kept for a stream that is refused (not a JPEG,
// truncated, CMYK, non-integer sampling ratios, a format nvJPEG does not
// decode, a progressive stream with a restart interval, a frame other
// than 8-bit Huffman-coded DCT: SOF0, SOF1 and SOF2 only), which the caller
// may hand to another decoder as it would a stream libjpeg refuses.
// nvJPEG decodes a progressive stream whose scans carry restart markers
// into wrong pixels without an error (fault C3, seen on an H100 80GB HBM3
// with the CUDA 12.9 toolkit's nvJPEG: noise images with a restart every
// 2 MCUs came out far past the IDCT's differences from libjpeg), so such
// streams are refused before the decode; baseline streams with restart
// markers and progressive ones without decode to libjpeg's pixels but
// for the IDCT, like any baseline stream.  Every failure of the card or of nvJPEG itself
// gives -5 (no nvJPEG handle, no decoder state or stream, a failed
// cudaMalloc, an nvJPEG status other than a bad or unsupported stream, a
// refused launch, a fault), and nvJPEG's view of a stream disagreeing with
// the header's (size, components, plane sizes) gives -6.  The Python side
// raises for both: no other route decodes instead.
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_ycc.h"

namespace {

struct Slot {
    nvjpegJpegState_t state = nullptr;
    cudaStream_t stream = nullptr;
    unsigned char* buf = nullptr;     // the output pixels
    size_t cap = 0;
    unsigned char* planes = nullptr;  // the component planes
    size_t planes_cap = 0;
};

constexpr int32_t kRefused = -1;      // the stream is refused
constexpr int32_t kDeviceFailure = -5;  // the card or nvJPEG failed
constexpr int32_t kDisagreement = -6;   // nvJPEG's geometry is not libjpeg's

std::mutex g_mu;
std::vector<Slot*> g_free;  // guarded by g_mu

nvjpegHandle_t handle() {
    static nvjpegHandle_t h = [] {
        nvjpegHandle_t x = nullptr;
        return nvjpegCreateSimple(&x) == NVJPEG_STATUS_SUCCESS ? x : nullptr;
    }();
    return h;
}

Slot* acquire(nvjpegHandle_t h) {
    {
        std::lock_guard<std::mutex> lock(g_mu);
        if (!g_free.empty()) {
            Slot* s = g_free.back();
            g_free.pop_back();
            return s;
        }
    }
    Slot* s = new Slot();
    if (nvjpegJpegStateCreate(h, &s->state) != NVJPEG_STATUS_SUCCESS ||
        cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) !=
            cudaSuccess) {
        if (s->state) nvjpegJpegStateDestroy(s->state);
        delete s;
        return nullptr;
    }
    return s;
}

void release(Slot* s) {
    std::lock_guard<std::mutex> lock(g_mu);
    g_free.push_back(s);
}

// Grow a slot's device buffer to `bytes`; false when cudaMalloc fails.
bool reserve(unsigned char** buf, size_t* cap, size_t bytes) {
    if (*cap >= bytes) return true;
    cudaFree(*buf);
    *buf = nullptr;
    *cap = 0;
    if (cudaMalloc(buf, bytes) != cudaSuccess) return false;
    *cap = bytes;
    return true;
}

// A decode's status as an entry's return code: a stream nvJPEG cannot
// decode is refused; any other failure is the decoder's or the card's.
int32_t decode_status(nvjpegStatus_t st) {
    switch (st) {
        case NVJPEG_STATUS_SUCCESS:
            return 0;
        case NVJPEG_STATUS_BAD_JPEG:
        case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
        case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
            return kRefused;
        default:
            return kDeviceFailure;
    }
}

// An entry's return code after its work: a failure leaves the calling
// thread's last CUDA error cleared (a failed cudaMalloc records one), so
// that it does not surface at the caller's next, unrelated CUDA check.
int32_t finish(int32_t rc) {
    if (rc != 0) cudaGetLastError();
    return rc;
}

// What libjpeg reads from a stream's header to decode it: the first
// frame's size and components, and its colour space by libjpeg-turbo's
// rule (jdapimin.c default_decompress_parms).
struct Layout {
    bool progressive = false;  // SOF2 (the only progressive frame kept)
    int ncomp = 0;
    int height = 0;
    int width = 0;
    int color = -1;  // 0 gray, 1 YCbCr, 2 RGB, -1 anything else
    int h[4] = {0, 0, 0, 0};
    int v[4] = {0, 0, 0, 0};
    int hmax = 0;
    int vmax = 0;
};

bool parse_layout(const uint8_t* d, int64_t n, Layout* L) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return false;
    bool jfif = false, adobe = false, sof = false;
    int transform = -1, ids[4] = {0, 0, 0, 0};
    int64_t i = 2;
    while (i + 4 <= n) {
        if (d[i] != 0xFF) return false;
        const uint8_t m = d[i + 1];
        if (m == 0xFF) {  // fill byte
            ++i;
            continue;
        }
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD8)) {  // no length
            i += 2;
            continue;
        }
        if (m == 0xD9 || m == 0xDA) break;  // the header ends at a scan
        const int len = (d[i + 2] << 8) | d[i + 3];
        if (len < 2 || i + 2 + len > n) return false;
        const uint8_t* p = d + i + 4;
        const int plen = len - 2;
        if (m == 0xE0 && plen >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) {
            jfif = true;
        } else if (m == 0xEE && plen >= 12 &&
                   std::memcmp(p, "Adobe", 5) == 0) {
            adobe = true;
            transform = p[11];
        } else if (!sof && m >= 0xC0 && m <= 0xCF && m != 0xC4 &&
                   m != 0xC8 && m != 0xCC) {
            // only 8-bit Huffman-coded DCT frames (SOF0 baseline, SOF1
            // extended, SOF2 progressive) go to nvJPEG: a lossless
            // (SOF3/7/11/15), arithmetic-coded (SOF9-11, 13-15) or
            // hierarchical (SOF5-7) frame, or a precision other than 8
            // bits, is refused, and the caller takes PIL's pixels
            if (plen < 6 || m > 0xC2 || p[0] != 8) return false;
            L->progressive = m == 0xC2;
            L->height = (p[1] << 8) | p[2];
            L->width = (p[3] << 8) | p[4];
            L->ncomp = p[5];
            if (L->ncomp < 1 || plen < 6 + 3 * L->ncomp) return false;
            for (int c = 0; c < L->ncomp && c < 4; ++c) {
                ids[c] = p[6 + 3 * c];
                L->h[c] = p[7 + 3 * c] >> 4;
                L->v[c] = p[7 + 3 * c] & 15;
                if (L->h[c] < 1 || L->h[c] > 4 || L->v[c] < 1 || L->v[c] > 4)
                    return false;
                L->hmax = L->h[c] > L->hmax ? L->h[c] : L->hmax;
                L->vmax = L->v[c] > L->vmax ? L->v[c] : L->vmax;
            }
            sof = true;
        }
        i += 2 + len;
    }
    if (!sof || L->height <= 0 || L->width <= 0) return false;
    if (L->ncomp == 1) {
        L->color = 0;
    } else if (L->ncomp == 3) {
        if (jfif) {
            L->color = 1;
        } else if (adobe) {
            L->color = transform == 0 ? 2 : 1;
        } else {
            L->color = (ids[0] == 82 && ids[1] == 71 && ids[2] == 66) ? 2 : 1;
        }
    }
    return true;
}

// A plane's real size (libjpeg's downsampled_width / _height).
int plane_size(int image, int factor, int largest) {
    return static_cast<int>(
        (static_cast<int64_t>(image) * factor + largest - 1) / largest);
}

// (h, w, c) of the stream's output: 0 ok, -1 bad stream or a component
// count other than 1 or 3 (c is 3 then, as libjpeg's probe says for CMYK).
// nvjpegGetImageInfo parses the header on the host and touches no device,
// so any failure of it is a refusal of the stream.
int32_t info(nvjpegHandle_t h, const uint8_t* data, int64_t len,
             int32_t* H, int32_t* W, int32_t* C, int* ncomp, int* ws,
             int* hs) {
    nvjpegChromaSubsampling_t ss;
    if (len < 4 || nvjpegGetImageInfo(h, data, static_cast<size_t>(len),
                                      ncomp, &ss, ws, hs) !=
                       NVJPEG_STATUS_SUCCESS ||
        ws[0] <= 0 || hs[0] <= 0) {
        return kRefused;
    }
    *H = hs[0];
    *W = ws[0];
    *C = *ncomp == 1 ? 1 : 3;
    return 0;
}

// True when the stream holds an end-of-image marker (FF D9): the last
// one is searched from the end, past any trailing padding.
bool has_eoi(const uint8_t* data, int64_t len) {
    for (int64_t i = len - 2; i >= 2; --i) {
        if (data[i] == 0xFF && data[i + 1] == 0xD9) return true;
        if (len - i > 4096) break;
    }
    return false;
}

// The planes of a colour stream decoded on the card into the slot: each
// plane c at s->planes + off[c], `pitch[c]` bytes a row, its real size
// (rows[c], cols[c]) libjpeg's.  0 ok, -1 a stream nvJPEG refuses, -5 a
// failure of the card or nvJPEG, -6 nvJPEG's plane sizes not libjpeg's.
int32_t decode_planes_on_card(nvjpegHandle_t hd, Slot* s,
                              const uint8_t* data, int64_t len,
                              const Layout& L, const int* ws, const int* hs,
                              YccPlane* planes) {
    size_t off[3], total = 0;
    int pitch[3];
    for (int c = 0; c < 3; ++c) {
        const int cols = plane_size(L.width, L.h[c], L.hmax);
        const int rows = plane_size(L.height, L.v[c], L.vmax);
        // nvJPEG's own plane size must cover libjpeg's, or a sample the
        // upsampling reads would be missing
        if (ws[c] < cols || hs[c] < rows) return kDisagreement;
        pitch[c] = ws[c];
        off[c] = total;
        total += static_cast<size_t>(pitch[c]) * hs[c];
        planes[c] = YccPlane{nullptr, pitch[c], cols, rows, L.hmax / L.h[c],
                             L.vmax / L.v[c]};
    }
    if (!reserve(&s->planes, &s->planes_cap, total)) return kDeviceFailure;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    for (int c = 0; c < 3; ++c) {
        img.channel[c] = s->planes + off[c];
        img.pitch[c] = static_cast<size_t>(pitch[c]);
        planes[c].data = s->planes + off[c];
    }
    return decode_status(nvjpegDecode(hd, s->state, data,
                                      static_cast<size_t>(len),
                                      NVJPEG_OUTPUT_YUV, &img, s->stream));
}

// True when the stream defines a non-zero restart interval anywhere: a
// progressive stream may define one between its scans, so the whole
// stream is searched.  FF DD cannot occur inside entropy-coded data (an
// FF there is followed by 00 or a restart marker); a match inside a
// marker segment's payload (an embedded thumbnail) only refuses a stream
// that nvJPEG might have decoded.
bool has_restart_interval(const uint8_t* d, int64_t n) {
    for (int64_t i = 2; i + 5 < n; ++i) {
        if (d[i] == 0xFF && d[i + 1] == 0xDD && d[i + 2] == 0 &&
            d[i + 3] == 4 && (d[i + 4] | d[i + 5]) != 0) {
            return true;
        }
    }
    return false;
}

// Checks shared by the decode entries: the stream's layout, nvJPEG's
// view of it, an end-of-image marker, 1 or 3 components in a colour
// space libjpeg converts to BGR, integer sampling ratios and no restart
// interval in a progressive stream (else -1); then nvJPEG's size and
// component count against the header's (else -6).
int32_t check_stream(nvjpegHandle_t hd, const uint8_t* data, int64_t len,
                     Layout* L, int* ws, int* hs) {
    int32_t H = 0, W = 0, C = 0;
    int ncomp = 0;
    if (info(hd, data, len, &H, &W, &C, &ncomp, ws, hs) != 0 ||
        (ncomp != 1 && ncomp != 3) || !has_eoi(data, len) ||
        !parse_layout(data, len, L) || L->color < 0 ||
        (L->progressive && has_restart_interval(data, len))) {
        return kRefused;
    }
    if (L->ncomp != ncomp || L->height != H || L->width != W) {
        return kDisagreement;
    }
    for (int c = 0; c < ncomp; ++c) {
        if (L->hmax % L->h[c] != 0 || L->vmax % L->v[c] != 0) return kRefused;
    }
    return 0;
}

}  // namespace

extern "C" {

// Output dims/channels; 0 ok, -1 bad stream, -4 scale_denom other than 1,
// -5 no nvJPEG handle.
int32_t mml_jpeg_probe(const uint8_t* data, int64_t len, int32_t scale_denom,
                       int32_t* h, int32_t* w, int32_t* c) {
    if (scale_denom > 1) return -4;
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return finish(kDeviceFailure);
    int ncomp = 0;
    int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
    return info(hd, data, len, h, w, c, &ncomp, ws, hs);
}

// The stream's layout into out[10]: components, height, width, colour
// space (0 gray, 1 YCbCr, 2 RGB, -1 other), then (h, v) sampling factors
// of the first three components.  0 ok, -1 bad stream.
int32_t mml_jpeg_layout(const uint8_t* data, int64_t len, int32_t* out) {
    Layout L;
    if (!parse_layout(data, len, &L)) return -1;
    out[0] = L.ncomp;
    out[1] = L.height;
    out[2] = L.width;
    out[3] = (L.ncomp == 1 || L.ncomp == 3) ? L.color : -1;
    for (int c = 0; c < 3; ++c) {
        out[4 + 2 * c] = L.h[c];
        out[5 + 2 * c] = L.v[c];
    }
    return 0;
}

// Decode to HWC uint8, BGR channel order (gray stays 1 channel).
// 0 ok; -1 bad stream; -3 out buffer too small; -4 scale_denom other than
// 1; -5 a failure of the card or nvJPEG; -6 nvJPEG disagrees with the
// header.
int32_t mml_jpeg_decode_bgr(const uint8_t* data, int64_t len,
                            int32_t scale_denom, uint8_t* out,
                            int64_t out_cap, int32_t* h, int32_t* w,
                            int32_t* c) {
    if (scale_denom > 1) return -4;
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return finish(kDeviceFailure);
    Layout L;
    int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
    int32_t rc = check_stream(hd, data, len, &L, ws, hs);
    if (rc != 0) return rc;
    const int32_t H = L.height, W = L.width, C = L.ncomp == 1 ? 1 : 3;
    const int64_t bytes = static_cast<int64_t>(W) * H * C;
    if (bytes > out_cap) return -3;
    Slot* s = acquire(hd);
    if (s == nullptr) return finish(kDeviceFailure);
    rc = reserve(&s->buf, &s->cap, static_cast<size_t>(bytes))
             ? 0
             : kDeviceFailure;
    if (rc == 0 && C == 1) {
        nvjpegImage_t img;
        std::memset(&img, 0, sizeof(img));
        img.channel[0] = s->buf;
        img.pitch[0] = static_cast<size_t>(W);
        rc = decode_status(nvjpegDecode(hd, s->state, data,
                                        static_cast<size_t>(len),
                                        NVJPEG_OUTPUT_Y, &img, s->stream));
    } else if (rc == 0) {
        YccPlane planes[3];
        rc = decode_planes_on_card(hd, s, data, len, L, ws, hs, planes);
        if (rc == 0 && mml_ycc_launch(planes, H, W, L.color == 2, s->buf,
                                      s->stream) != cudaSuccess) {
            rc = kDeviceFailure;
        }
    }
    if (rc == 0 &&
        (cudaMemcpyAsync(out, s->buf, static_cast<size_t>(bytes),
                         cudaMemcpyDeviceToHost, s->stream) != cudaSuccess ||
         cudaStreamSynchronize(s->stream) != cudaSuccess)) {
        rc = kDeviceFailure;
    }
    release(s);
    if (rc == 0) {
        *h = H;
        *w = W;
        *c = C;
    }
    return finish(rc);
}

// Decode to the component planes, packed one after another into `out`,
// each at its real size (ceil(size * factor / largest factor)), as IDCT
// output: the input of the upsampling and colour conversion.  0 ok; -1
// bad stream; -3 out buffer too small; -5 a failure of the card or
// nvJPEG; -6 nvJPEG disagrees with the header.
int32_t mml_jpeg_decode_planes(const uint8_t* data, int64_t len,
                               uint8_t* out, int64_t out_cap) {
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return finish(kDeviceFailure);
    Layout L;
    int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
    const int32_t checked = check_stream(hd, data, len, &L, ws, hs);
    if (checked != 0) return checked;
    int64_t bytes = 0;
    for (int c = 0; c < L.ncomp; ++c) {
        bytes += static_cast<int64_t>(plane_size(L.width, L.h[c], L.hmax)) *
                 plane_size(L.height, L.v[c], L.vmax);
    }
    if (bytes > out_cap) return -3;
    Slot* s = acquire(hd);
    if (s == nullptr) return finish(kDeviceFailure);
    YccPlane planes[3];
    int32_t rc = 0;
    if (L.ncomp == 1) {
        const size_t n = static_cast<size_t>(L.width) * L.height;
        planes[0] = YccPlane{nullptr, L.width, L.width, L.height, 1, 1};
        if (!reserve(&s->planes, &s->planes_cap, n)) {
            rc = kDeviceFailure;
        } else {
            nvjpegImage_t img;
            std::memset(&img, 0, sizeof(img));
            img.channel[0] = s->planes;
            img.pitch[0] = static_cast<size_t>(L.width);
            planes[0].data = s->planes;
            rc = decode_status(nvjpegDecode(hd, s->state, data,
                                            static_cast<size_t>(len),
                                            NVJPEG_OUTPUT_Y, &img,
                                            s->stream));
        }
    } else {
        rc = decode_planes_on_card(hd, s, data, len, L, ws, hs, planes);
    }
    uint8_t* dst = out;
    for (int c = 0; rc == 0 && c < L.ncomp; ++c) {
        const YccPlane& p = planes[c];
        if (cudaMemcpy2DAsync(dst, static_cast<size_t>(p.width), p.data,
                              static_cast<size_t>(p.pitch),
                              static_cast<size_t>(p.width),
                              static_cast<size_t>(p.height),
                              cudaMemcpyDeviceToHost, s->stream) !=
            cudaSuccess) {
            rc = kDeviceFailure;
        }
        dst += static_cast<int64_t>(p.width) * p.height;
    }
    if (rc == 0 && cudaStreamSynchronize(s->stream) != cudaSuccess) {
        rc = kDeviceFailure;
    }
    release(s);
    return finish(rc);
}

}  // extern "C"
