// The port's host JPEG decoder on libjpeg(-turbo): a copy of the JPEG
// entries of the JAX package's native runtime
// (mmlspark_tpu/native/src/native.cpp, "JPEG decode").  Built where
// jpeglib.h exists (mmlspark_tpu_torch/native/__init__.py); the other
// backend, jpeg_nvjpeg.cpp, has the same two C entries.
//
// Plain C ABI consumed via ctypes.  scale_denom gives the 1/2, 1/4, 1/8
// DCT-domain decodes.
#include <cstdint>
#include <csetjmp>
#include <cstdio>

#include <jpeglib.h>
#include <jerror.h>

namespace {
struct MmlJpegErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
    bool truncated;
};

void mml_jpeg_error_exit(j_common_ptr cinfo) {
    longjmp(reinterpret_cast<MmlJpegErr*>(cinfo->err)->jb, 1);
}

void mml_jpeg_emit(j_common_ptr cinfo, int msg_level) {
    // no stderr spam; PIL-parity: only truncation (premature EOF) rejects
    // the image — benign warnings (extraneous marker bytes etc.) decode
    // fine everywhere and must not force a PIL re-decode
    if (msg_level == -1 && cinfo->err->msg_code == JWRN_JPEG_EOF) {
        reinterpret_cast<MmlJpegErr*>(cinfo->err)->truncated = true;
    }
}

void mml_jpeg_silence(j_common_ptr) {}

void mml_jpeg_init_err(jpeg_decompress_struct* cinfo, MmlJpegErr* jerr) {
    cinfo->err = jpeg_std_error(&jerr->pub);
    jerr->pub.error_exit = mml_jpeg_error_exit;
    jerr->pub.emit_message = mml_jpeg_emit;
    jerr->pub.output_message = mml_jpeg_silence;
    jerr->truncated = false;
}
}  // namespace

extern "C" {

// Output dims/channels after scaling; 0 ok, -1 bad stream.
int32_t mml_jpeg_probe(const uint8_t* data, int64_t len, int32_t scale_denom,
                       int32_t* h, int32_t* w, int32_t* c) {
    jpeg_decompress_struct cinfo;
    MmlJpegErr jerr;
    mml_jpeg_init_err(&cinfo, &jerr);
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
    jpeg_calc_output_dimensions(&cinfo);
    *h = static_cast<int32_t>(cinfo.output_height);
    *w = static_cast<int32_t>(cinfo.output_width);
    *c = cinfo.jpeg_color_space == JCS_GRAYSCALE ? 1 : 3;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode to HWC uint8, BGR channel order (gray stays 1 channel).
// 0 ok; -1 bad stream; -3 out buffer too small.
int32_t mml_jpeg_decode_bgr(const uint8_t* data, int64_t len,
                            int32_t scale_denom, uint8_t* out,
                            int64_t out_cap, int32_t* h, int32_t* w,
                            int32_t* c) {
    jpeg_decompress_struct cinfo;
    MmlJpegErr jerr;
    mml_jpeg_init_err(&cinfo, &jerr);
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
    bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
    bool native_bgr = false;
    if (gray) {
        cinfo.out_color_space = JCS_GRAYSCALE;
    } else {
#ifdef JCS_EXTENSIONS
        cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo: free swizzle
        native_bgr = true;
#else
        cinfo.out_color_space = JCS_RGB;
#endif
    }
    jpeg_start_decompress(&cinfo);
    const int32_t W = cinfo.output_width, H = cinfo.output_height;
    const int32_t C = gray ? 1 : 3;
    if (static_cast<int64_t>(W) * H * C > out_cap) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    const int64_t stride = static_cast<int64_t>(W) * C;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
        JSAMPROW rows[1] = {row};
        jpeg_read_scanlines(&cinfo, rows, 1);
        if (!gray && !native_bgr) {
            for (int64_t x = 0; x < W; x++) {  // RGB -> BGR in place
                uint8_t t = row[3 * x];
                row[3 * x] = row[3 * x + 2];
                row[3 * x + 2] = t;
            }
        }
    }
    *h = H;
    *w = W;
    *c = C;
    jpeg_finish_decompress(&cinfo);
    // libjpeg treats truncated data as a recoverable warning and pads
    // gray: reject it like PIL does, or garbage rows would silently enter
    // training data (benign warnings still decode)
    bool corrupt = jerr.truncated;
    jpeg_destroy_decompress(&cinfo);
    return corrupt ? -1 : 0;
}

}  // extern "C"
