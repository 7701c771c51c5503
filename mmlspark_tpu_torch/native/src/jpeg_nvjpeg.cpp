// The port's host JPEG decoder on nvJPEG, for a machine with the CUDA
// toolkit and no libjpeg headers: the same two C entries as
// jpeg_libjpeg.cpp (the JAX package's libjpeg entries), so the Python
// side and the featurizer see one contract.  mmlspark_tpu_torch/native
// builds this file only where jpeglib.h is missing and nvjpeg.h exists.
//
// A decode parses the stream and runs the Huffman stage on the calling
// thread, the IDCT and colour conversion on the card (nvJPEG's default
// backend), into a device buffer as interleaved BGR (gray: Y), then
// copies the pixels into the caller's host buffer and waits for them.
// Threads decode in parallel: each call borrows a decoder state, a
// stream and a device buffer from a pool and gives them back.
//
// Differences from libjpeg: nvJPEG's IDCT and chroma upsampling are not
// libjpeg's, so pixels may differ by a few levels (measured and bounded
// by the card tests against the libjpeg digests of tests/jpeg_fixtures/);
// there is no DCT-domain scaling (scale_denom other than 1 returns -4);
// a stream whose data ends before its last scan, which libjpeg reports
// as a warning and the libjpeg entry rejects, is rejected here when it
// has no end-of-image marker.
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Slot {
    nvjpegJpegState_t state = nullptr;
    cudaStream_t stream = nullptr;
    unsigned char* buf = nullptr;
    size_t cap = 0;
};

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

// (h, w, c) of the stream's output: 0 ok, -1 bad stream or a component
// count other than 1 or 3 (c is 3 then, as libjpeg's probe says for CMYK).
int32_t info(nvjpegHandle_t h, const uint8_t* data, int64_t len,
             int32_t* H, int32_t* W, int32_t* C, int* ncomp) {
    nvjpegChromaSubsampling_t ss;
    int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
    if (len < 4 || nvjpegGetImageInfo(h, data, static_cast<size_t>(len),
                                      ncomp, &ss, ws, hs) !=
                       NVJPEG_STATUS_SUCCESS ||
        ws[0] <= 0 || hs[0] <= 0) {
        return -1;
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

}  // namespace

extern "C" {

// Output dims/channels; 0 ok, -1 bad stream, -2 no nvJPEG, -4 scale_denom
// other than 1.
int32_t mml_jpeg_probe(const uint8_t* data, int64_t len, int32_t scale_denom,
                       int32_t* h, int32_t* w, int32_t* c) {
    if (scale_denom > 1) return -4;
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return -2;
    int ncomp = 0;
    return info(hd, data, len, h, w, c, &ncomp);
}

// Decode to HWC uint8, BGR channel order (gray stays 1 channel).
// 0 ok; -1 bad stream; -2 no nvJPEG or no device memory; -3 out buffer
// too small; -4 scale_denom other than 1.
int32_t mml_jpeg_decode_bgr(const uint8_t* data, int64_t len,
                            int32_t scale_denom, uint8_t* out,
                            int64_t out_cap, int32_t* h, int32_t* w,
                            int32_t* c) {
    if (scale_denom > 1) return -4;
    nvjpegHandle_t hd = handle();
    if (hd == nullptr) return -2;
    int32_t H = 0, W = 0, C = 0;
    int ncomp = 0;
    if (info(hd, data, len, &H, &W, &C, &ncomp) != 0 ||
        (ncomp != 1 && ncomp != 3) || !has_eoi(data, len)) {
        return -1;
    }
    const int64_t bytes = static_cast<int64_t>(W) * H * C;
    if (bytes > out_cap) return -3;
    Slot* s = acquire(hd);
    if (s == nullptr) return -2;
    int32_t rc = 0;
    if (s->cap < static_cast<size_t>(bytes)) {
        cudaFree(s->buf);
        s->buf = nullptr;
        s->cap = 0;
        if (cudaMalloc(&s->buf, static_cast<size_t>(bytes)) != cudaSuccess) {
            rc = -2;
        } else {
            s->cap = static_cast<size_t>(bytes);
        }
    }
    if (rc == 0) {
        nvjpegImage_t img;
        std::memset(&img, 0, sizeof(img));
        img.channel[0] = s->buf;
        img.pitch[0] = static_cast<size_t>(W) * C;
        if (nvjpegDecode(hd, s->state, data, static_cast<size_t>(len),
                         C == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &img,
                         s->stream) != NVJPEG_STATUS_SUCCESS ||
            cudaMemcpyAsync(out, s->buf, static_cast<size_t>(bytes),
                            cudaMemcpyDeviceToHost, s->stream) != cudaSuccess ||
            cudaStreamSynchronize(s->stream) != cudaSuccess) {
            rc = -1;
        }
    }
    release(s);
    if (rc == 0) {
        *h = H;
        *w = W;
        *c = C;
    }
    return rc;
}

}  // extern "C"
