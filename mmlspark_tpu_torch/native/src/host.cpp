// The port's host library: the plain-C part of the JAX package's native
// host runtime (native/src/native.cpp), built apart from the JPEG decoder
// so that it needs no jpeglib.h.
//
//  - murmur3 batch hashing        <- VW murmur feature hashing
//    (vw/VowpalWabbitMurmurWithPrefix.scala bridges to native VW murmur)
//  - GBDT histogram accumulation  <- LightGBM's C++ histogram kernels
//    (a host-side histogram beside the device one)
//  - numeric CSV parsing          <- fast columnar ingestion for the
//    data-loader path (BinaryFileFormat/CSV ingestion is JVM-side there)
//
// Exposed as a plain C ABI consumed via ctypes.
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

extern "C" {

// ----------------------------------------------------------- murmur3 x86_32
static inline uint32_t rotl32(uint32_t x, int8_t r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16; h *= 0x85ebca6b;
    h ^= h >> 13; h *= 0xc2b2ae35;
    h ^= h >> 16;
    return h;
}

uint32_t murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
    const int64_t nblocks = len / 4;
    uint32_t h1 = seed;
    const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
    for (int64_t i = 0; i < nblocks; i++) {
        uint32_t k1;
        std::memcpy(&k1, data + 4 * i, 4);
        k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
        h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64;
    }
    const uint8_t* tail = data + nblocks * 4;
    uint32_t k1 = 0;
    switch (len & 3) {
        case 3: k1 ^= tail[2] << 16; [[fallthrough]];
        case 2: k1 ^= tail[1] << 8;  [[fallthrough]];
        case 1: k1 ^= tail[0];
                k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint32_t)len;
    return fmix32(h1);
}

// Hash n strings packed into `data` with prefix-sum `offsets` (n+1 entries).
void murmur3_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                   uint32_t seed, uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = murmur3_32(data + offsets[i], offsets[i + 1] - offsets[i],
                            seed);
    }
}

// ------------------------------------------------- GBDT histogram building
// bins: (n_rows, n_features) uint8 pre-binned features (row-major)
// grad/hess: (n_rows,); node_idx: (n_rows,) int32 leaf assignment (-1 skip)
// out: (n_nodes, n_features, n_bins, 2) float64 accumulating (grad, hess)
void histogram_f64(const uint8_t* bins, const float* grad, const float* hess,
                   const int32_t* node_idx, int64_t n_rows,
                   int64_t n_features, int64_t n_bins, int64_t n_nodes,
                   double* out) {
    const int64_t node_stride = n_features * n_bins * 2;
    for (int64_t r = 0; r < n_rows; r++) {
        const int32_t node = node_idx[r];
        if (node < 0 || node >= n_nodes) continue;
        const double g = grad[r], h = hess[r];
        const uint8_t* row = bins + r * n_features;
        double* base = out + node * node_stride;
        for (int64_t f = 0; f < n_features; f++) {
            double* cell = base + (f * n_bins + row[f]) * 2;
            cell[0] += g;
            cell[1] += h;
        }
    }
}

// ------------------------------------------------------ numeric CSV parser
// Parse a CSV of doubles (no quoting) into a row-major buffer.
// Returns rows parsed, or -1 on open failure, -2 on column mismatch.
// First call with out=NULL to count rows/cols (returned via n_rows/n_cols).
int64_t csv_count(const char* path, int64_t* n_rows, int64_t* n_cols,
                  int has_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t rows = 0, cols = 0;
    int c, line_cols = 1, in_line = 0, line_no = 0;
    while ((c = std::fgetc(f)) != EOF) {
        if (c == '\n') {
            if (in_line) {
                if (line_no >= has_header) {
                    if (cols == 0) cols = line_cols;
                    else if (line_cols != cols) { std::fclose(f); return -2; }
                    rows++;
                }
                line_no++;
            }
            line_cols = 1; in_line = 0;
        } else {
            in_line = 1;
            if (c == ',') line_cols++;
        }
    }
    if (in_line) {
        if (line_no >= has_header) {
            if (cols == 0) cols = line_cols;
            rows++;
        }
    }
    std::fclose(f);
    *n_rows = rows; *n_cols = cols;
    return rows;
}

int64_t csv_parse(const char* path, int has_header, double* out,
                  int64_t max_vals) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char* line = nullptr;
    size_t cap = 0;  // getline grows the buffer: arbitrary line width
    int64_t written = 0, line_no = 0;
    while (getline(&line, &cap, f) != -1) {
        if (line_no++ < has_header) continue;
        char* p = line;
        if (*p == '\n' || *p == '\0') continue;
        while (true) {
            char* end = nullptr;
            double v = std::strtod(p, &end);
            if (written >= max_vals) { std::free(line); std::fclose(f); return -3; }
            if (end == p) { std::free(line); std::fclose(f); return -4; }
            out[written++] = v;
            p = end;
            while (*p && *p != ',' && *p != '\n') p++;
            if (*p != ',') break;
            p++;
        }
    }
    std::free(line);
    std::fclose(f);
    return written;
}

}  // extern "C"
