// Fused affine resample + normalize for NHWC images: the Hopper port of
// the JAX package's Pallas kernel
// mmlspark_tpu/ops/pallas_kernels.py::_fused_resize_normalize_run.
//
// Computes, for every image b, output row y, output column x and output
// channel co:
//
//   u[co] = sum_ci cmix[ci][co] * sum_i a_h[y][i] * sum_j a_w[x][j] * X[b][i][j][ci]
//   out[b][y][x][co] = (u[co] - mean[co]) * inv[co]
//
// with X uint8 or f32 and the output f32.  Resize + normalize is the
// case cmix = identity; any separable linear chain (crop, flip, blur,
// colour mix) fits the same contract.
//
// What bounds it on an H100: bytes.  Each output pixel reads a few input
// pixels (a 256->224 downscale touches about 3x3 taps per pixel) and
// does a few dozen FMAs; the work per byte moved is far below the card's
// FMA/byte balance, so the least time is one read of the input plus one
// f32 write of the output at 3.35 TB/s, and the f32 output is most of
// those bytes (three quarters of them for a uint8 RGB 256->224 resize).
//
// Design.  The TPU kernel ran the resize as two dense matmuls on the
// MXU, padded to the (8, 128) tile grid.  None of that is a rule here.
// The host computes each output row's and column's [lo, hi) range of
// non-zero taps, and two routes of one C entry use them.
//
// The tile route (affine_resample_tile_kernel): one block of 256
// threads per (image, tile of TY output rows).  The host gives each tile
// the span [lo, hi) of input rows its output rows read (the min and max
// of their tap ranges, so crops and flips work) and the width taps
// compacted to k_w weights a column from x_lo[x] on.
//   1. Staging: the span's input rows, one contiguous run of span * w_in
//      * c_in elements of NHWC, go to shared memory by cp.async in
//      16-byte pieces, at the same address modulo 16 as in device memory
//      (so both ends of every piece are aligned), with an unaligned head
//      and tail copied byte by byte; beside them the channel mix, the
//      epilogue's mean and inv of every value of an output row, and each
//      tile row's height taps.
//   2. Width pass: a thread takes one output column, its k_w weights in
//      registers, over the span's rows, sums the taps of every channel
//      and applies the channel mix (skipped when it is the identity),
//      into an f32 intermediate [span, w_out * c_out] in shared memory.
//   3. Height pass: each thread takes 4 consecutive values of the tile's
//      output [rows, w_out * c_out] (contiguous in NHWC), sums their
//      height taps from the intermediate (16-byte shared loads), applies
//      (u - mean) * inv and writes them with one 16-byte store.  A row
//      width w_out * c_out that is not a multiple of 4 takes one value a
//      thread from shared memory, still with 16-byte stores where the
//      output is aligned and scalar stores at the ragged head and tail.
//   The width taps are summed before the height taps, as in the per-pixel
//   kernel; the channel mix comes between them (a reordering of linear
//   maps: the sums differ in their last f32 bits).  What bounds this
//   route on the H100 (leave-one-out times at the featurizers' chunk
//   shapes, PERF.md): the f32 output's writes and the width pass's
//   instructions (a shared-memory byte load, two ALU ops and an FMA a
//   tap and channel), which overlap only across the blocks of an SM, so
//   the rule below keeps three of them there.
// The host's rule for TY (ops/image_kernels.py::AffinePlan.tiling): the
// fewest tiles an image, each of ceil(h_out / tiles) rows, whose shared
// memory (tile_layout) leaves three blocks on an SM, at most 76,800
// bytes, with at least 132 blocks (or one a row) to give every SM one.
//
// The pixel route (affine_resample_pixel_kernel), the first design: one
// thread per output pixel (all of its channels) walks its taps through the
// read-only cache and writes its channels with scalar stores; no shared
// memory, so any size.  The rule (AffinePlan.route): a plan takes the
// tile route for an input type when a column's width taps fit the
// registers (k_w <= 16) and one output row's span fits the three-block
// budget at TY = 1, else this route (a very large downscale, or a wide
// f32 input).  Both routes are chosen by that rule alone, never on a
// failure.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // what one block may opt in to on sm_90

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// X as f32, exactly: for uint8 the byte v under the exponent of 2^23 is
// 2^23 + v, less 2^23 is v (full-rate ALU ops in place of the
// quarter-rate integer-to-float conversion).
__device__ __forceinline__ float to_f32(uint8_t v) {
  return __uint_as_float(0x4b000000u | v) - 8388608.f;
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ float load_px(const T* p) {
  return to_f32(__ldg(p));
}

// ---- the pixel route -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
affine_resample_pixel_kernel(const T* __restrict__ x,
                             float* __restrict__ out, int n_batch, int h_in,
                             int w_in, int c_in, int h_out, int w_out,
                             int c_out, const float* __restrict__ a_h,
                             const float* __restrict__ a_w,
                             const int* __restrict__ y_rng,
                             const int* __restrict__ x_rng,
                             const float* __restrict__ cmix,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv) {
  const int64_t n_pix = static_cast<int64_t>(n_batch) * h_out * w_out;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n_pix; p += stride) {
    const int ox = static_cast<int>(p % w_out);
    const int64_t q = p / w_out;
    const int oy = static_cast<int>(q % h_out);
    const int64_t b = q / h_out;
    const int y0 = __ldg(y_rng + 2 * oy), y1 = __ldg(y_rng + 2 * oy + 1);
    const int x0 = __ldg(x_rng + 2 * ox), x1 = __ldg(x_rng + 2 * ox + 1);
    const T* img = x + b * h_in * static_cast<int64_t>(w_in) * c_in;
    const float* wy_row = a_h + static_cast<int64_t>(oy) * h_in;
    const float* wx_row = a_w + static_cast<int64_t>(ox) * w_in;

    float acc[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
    for (int i = y0; i < y1; ++i) {
      const T* row = img + static_cast<int64_t>(i) * w_in * c_in;
      float racc[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
      for (int j = x0; j < x1; ++j) {
        const float wx = __ldg(wx_row + j);
        const T* px = row + static_cast<int64_t>(j) * c_in;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < c_in) racc[c] = fmaf(wx, load_px(px + c), racc[c]);
        }
      }
      const float wy = __ldg(wy_row + i);
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) acc[c] = fmaf(wy, racc[c], acc[c]);
    }

    float* o = out + p * c_out;
#pragma unroll
    for (int co = 0; co < kMaxChannels; ++co) {
      if (co < c_out) {
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < c_in) u = fmaf(__ldg(cmix + c * c_out + co), acc[c], u);
        }
        o[co] = (u - __ldg(mean + co)) * __ldg(inv + co);
      }
    }
  }
}

// ---- the tile route ------------------------------------------------------

constexpr int kMaxTaps = 16;  // width taps a column the tile route holds

struct TileArgs {
  const void* x;        // [B, h_in, w_in, c_in] uint8 or f32, contiguous
  float* out;           // [B, h_out, w_out, c_out] f32, contiguous
  int h_in, w_in, h_out, w_out, c_out;
  const float* a_h;     // [h_out, h_in]
  const int* y_rng;     // [h_out, 2] each row's [lo, hi) of taps
  const int* tiles;     // [n_tiles, 2] each tile's input-row span [lo, hi)
  const float* w_taps;  // [w_out, k_w] column x's weights from x_lo[x] on
  const int* x_lo;      // [w_out]
  const float* cmix;    // [c_in, c_out]
  const float* mean;    // [c_out]
  const float* inv;     // [c_out]
  int ty, n_tiles, max_span, k_w, k_h, mix;
};

// Byte offsets of the dynamic shared memory: the channel mix (16 f32);
// the epilogue's mean and inv of every value of an output row [r_pad]
// f32 each (r_pad = w_out * c_out rounded up to 4: 16-byte rows); each
// tile row's first tap (relative to the span) and tap count [ty] int32
// each, and its height weights [ty, k_h] f32; the intermediate
// [max_span, r_pad] f32; then the staged rows with 16 bytes of slack for
// their offset modulo 16.
struct TileLayout {
  size_t ep_mean, ep_inv, h_start, h_count, h_w, t, stage, total;
  int r_pad;
};

__host__ __device__ inline TileLayout tile_layout(int w_in, int c_in,
                                                  int itemsize, int w_out,
                                                  int c_out, int ty, int k_h,
                                                  int span) {
  TileLayout L;
  L.r_pad = (w_out * c_out + 3) & ~3;
  size_t o = 16 * 4;
  L.ep_mean = o;
  o += static_cast<size_t>(L.r_pad) * 4;
  L.ep_inv = o;
  o += static_cast<size_t>(L.r_pad) * 4;
  L.h_start = o;
  o = align16(o + static_cast<size_t>(ty) * 4);
  L.h_count = o;
  o = align16(o + static_cast<size_t>(ty) * 4);
  L.h_w = o;
  o = align16(o + static_cast<size_t>(ty) * k_h * 4);
  L.t = o;
  o += static_cast<size_t>(span) * L.r_pad * 4;
  L.stage = o;
  o = align16(o + static_cast<size_t>(span) * w_in * c_in * itemsize + 16);
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// C_IN: the input's channels; KW: at least the plan's width taps a column
// (k_w), whose weights each thread keeps in registers.
template <typename T, int C_IN, int KW>
__global__ void __launch_bounds__(kTileThreads, 3)
affine_resample_tile_kernel(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.n_tiles;
  const int tile = blockIdx.x - b * a.n_tiles;
  const int lo = a.tiles[2 * tile], hi = a.tiles[2 * tile + 1];
  const int span = hi - lo;
  const int y0 = tile * a.ty;
  const int rows = min(a.ty, a.h_out - y0);
  const int c_out = a.c_out, w_out = a.w_out, k_w = a.k_w, k_h = a.k_h;
  const TileLayout L = tile_layout(a.w_in, C_IN, sizeof(T), w_out, c_out,
                                   a.ty, k_h, a.max_span);
  const int r_pad = L.r_pad;
  float* cm = reinterpret_cast<float*>(smem);
  float* ep_mean = reinterpret_cast<float*>(smem + L.ep_mean);
  float* ep_inv = reinterpret_cast<float*>(smem + L.ep_inv);
  int* h_start = reinterpret_cast<int*>(smem + L.h_start);
  int* h_count = reinterpret_cast<int*>(smem + L.h_count);
  float* h_w = reinterpret_cast<float*>(smem + L.h_w);
  float* t = reinterpret_cast<float*>(smem + L.t);

  // 1. staging: the span's rows (cp.async); the mix, the epilogue of
  //    every value of a row, and the tile rows' height taps
  const size_t row_bytes = static_cast<size_t>(a.w_in) * C_IN * sizeof(T);
  const unsigned char* src = static_cast<const unsigned char*>(a.x) +
                             (static_cast<size_t>(b) * a.h_in + lo) * row_bytes;
  const size_t n = static_cast<size_t>(span) * row_bytes;
  const int pre = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = smem + L.stage + pre;  // dst == src modulo 16
  const size_t head = n < static_cast<size_t>((16 - pre) & 15)
                          ? n : static_cast<size_t>((16 - pre) & 15);
  const size_t pieces = (n - head) / 16;
  for (size_t i = tid; i < pieces; i += kTileThreads) {
    cp_async16(dst + head + 16 * i, src + head + 16 * i);
  }
  for (size_t i = tid; i < head; i += kTileThreads) dst[i] = __ldg(src + i);
  for (size_t i = head + 16 * pieces + tid; i < n; i += kTileThreads) {
    dst[i] = __ldg(src + i);
  }
  if (tid < C_IN * c_out) cm[tid] = __ldg(a.cmix + tid);
  for (int e = tid; e < r_pad; e += kTileThreads) {
    const int co = e % c_out;
    ep_mean[e] = __ldg(a.mean + co);
    ep_inv[e] = __ldg(a.inv + co);
  }
  for (int i = tid; i < rows * k_h; i += kTileThreads) {
    const int yr = i / k_h, k = i - yr * k_h;
    const int y = y0 + yr;
    const int y_lo = __ldg(a.y_rng + 2 * y), y_hi = __ldg(a.y_rng + 2 * y + 1);
    h_w[i] = y_lo + k < y_hi
                 ? __ldg(a.a_h + static_cast<size_t>(y) * a.h_in + y_lo + k)
                 : 0.f;
    if (k == 0) {
      h_start[yr] = y_lo - lo;
      h_count[yr] = y_hi - y_lo;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. width pass: a thread takes one output column (its taps in
  //    registers) over every RG-th row of the span: t[i][x * c_out + co]
  //    = the mix of sum_k w[k] * X[lo + i][x_lo[x] + k][..]
  const T* sx = reinterpret_cast<const T*>(dst);
  const int row_elems = a.w_in * C_IN;
  const int rg = w_out >= kTileThreads ? 1 : kTileThreads / w_out;
  for (int u = tid; u < w_out * rg; u += kTileThreads) {
    const int x = u % w_out;
    float wr[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      wr[k] = k < k_w ? __ldg(a.w_taps + x * k_w + k) : 0.f;
    }
    const T* col = sx + __ldg(a.x_lo + x) * C_IN;
    float* tcol = t + x * c_out;
    for (int i = u / w_out; i < span; i += rg) {
      const T* px = col + i * row_elems;
      float racc[C_IN];
#pragma unroll
      for (int c = 0; c < C_IN; ++c) racc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        if (k >= k_w) break;
#pragma unroll
        for (int c = 0; c < C_IN; ++c) {
          racc[c] = fmaf(wr[k], to_f32(px[k * C_IN + c]), racc[c]);
        }
      }
      float* tr = tcol + i * r_pad;
      if (a.mix) {
#pragma unroll
        for (int co = 0; co < kMaxChannels; ++co) {
          if (co < c_out) {
            float v = 0.f;
#pragma unroll
            for (int c = 0; c < C_IN; ++c) v = fmaf(cm[c * c_out + co], racc[c], v);
            tr[co] = v;
          }
        }
      } else {  // the identity mix: c_out == C_IN
#pragma unroll
        for (int c = 0; c < C_IN; ++c) tr[c] = racc[c];
      }
    }
  }
  __syncthreads();

  // 3. height pass and the epilogue over the tile's contiguous output
  const int R = w_out * c_out;
  float* out = a.out + (static_cast<size_t>(b) * a.h_out + y0) * R;
  if ((R & 3) == 0) {
    // 4 values a thread: (tile row yr, group g of the row), stepped
    // through the tile without a division
    const int G4 = R / 4;
    const int step_r = kTileThreads / G4, step_g = kTileThreads % G4;
    float4* out4 = reinterpret_cast<float4*>(out);
    int yr = tid / G4, g = tid % G4;
    while (yr < rows) {
      const int e = 4 * g;
      const float* tb = t + h_start[yr] * r_pad + e;
      const float* w = h_w + yr * k_h;
      const int cnt = h_count[yr];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < cnt; ++k) {
        const float wy = w[k];
        const float4 v = *reinterpret_cast<const float4*>(tb + k * r_pad);
        acc.x = fmaf(wy, v.x, acc.x);
        acc.y = fmaf(wy, v.y, acc.y);
        acc.z = fmaf(wy, v.z, acc.z);
        acc.w = fmaf(wy, v.w, acc.w);
      }
      const float4 m = *reinterpret_cast<const float4*>(ep_mean + e);
      const float4 iv = *reinterpret_cast<const float4*>(ep_inv + e);
      out4[yr * G4 + g] = make_float4((acc.x - m.x) * iv.x,
                                      (acc.y - m.y) * iv.y,
                                      (acc.z - m.z) * iv.z,
                                      (acc.w - m.w) * iv.w);
      yr += step_r;
      g += step_g;
      if (g >= G4) {
        g -= G4;
        ++yr;
      }
    }
  } else {
    // one value at a time: f is the value's index in the tile's output
    auto value = [&](int f) {
      const int yr = f / R;
      const int e = f - yr * R;
      const float* tb = t + h_start[yr] * r_pad + e;
      const float* w = h_w + yr * k_h;
      float acc = 0.f;
      for (int k = 0; k < h_count[yr]; ++k) acc = fmaf(w[k], tb[k * r_pad], acc);
      return (acc - ep_mean[e]) * ep_inv[e];
    };
    // the tile's values [0, nf); [h0, h1) the ones whose 16-byte groups
    // of the output lie wholly inside it
    const int nf = rows * R;
    const int mis = static_cast<int>(
        (reinterpret_cast<uintptr_t>(out) >> 2) & 3);  // values past a group
    const int h0 = min(nf, (4 - mis) & 3);
    const int h1 = h0 + (nf - h0) / 4 * 4;
    for (int f = tid; f < h0; f += kTileThreads) out[f] = value(f);
    for (int f = h1 + tid; f < nf; f += kTileThreads) out[f] = value(f);
    float4* out4 = reinterpret_cast<float4*>(out + h0);
    for (int g = tid; g < (h1 - h0) / 4; g += kTileThreads) {
      const int f = h0 + 4 * g;
      out4[g] = make_float4(value(f), value(f + 1), value(f + 2),
                            value(f + 3));
    }
  }
}

template <typename T, int C_IN, int KW>
int launch_tile(const TileArgs& a, int n_batch, cudaStream_t stream) {
  const TileLayout L = tile_layout(a.w_in, C_IN, sizeof(T), a.w_out,
                                   a.c_out, a.ty, a.k_h, a.max_span);
  if (L.total > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = affine_resample_tile_kernel<T, C_IN, KW>;
  if (L.total > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(n_batch) * a.n_tiles;
  kernel<<<static_cast<unsigned>(blocks), kTileThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C_IN>
int launch_tile_k(const TileArgs& a, int n_batch, cudaStream_t stream) {
  if (a.k_w <= 4) return launch_tile<T, C_IN, 4>(a, n_batch, stream);
  return launch_tile<T, C_IN, kMaxTaps>(a, n_batch, stream);
}

template <typename T>
int launch_tile_c(const TileArgs& a, int c_in, int n_batch,
                  cudaStream_t stream) {
  switch (c_in) {
    case 1: return launch_tile_k<T, 1>(a, n_batch, stream);
    case 2: return launch_tile_k<T, 2>(a, n_batch, stream);
    case 3: return launch_tile_k<T, 3>(a, n_batch, stream);
    default: return launch_tile_k<T, 4>(a, n_batch, stream);
  }
}

}  // namespace

// Shared memory in bytes a tile-route block takes for the plan's sizes,
// `ty` rows a tile, at most `k_h` height taps a row and a span of `span`
// input rows (the host's rule for TY reads the same formula;
// chip_smoke.py checks that they agree).
extern "C" int mmk_affine_resample_smem(int w_in, int c_in, int itemsize,
                                        int w_out, int c_out, int ty,
                                        int k_h, int span) {
  return static_cast<int>(
      tile_layout(w_in, c_in, itemsize, w_out, c_out, ty, k_h, span).total);
}

// Plain C entry, loaded with ctypes.  Pointers are device pointers, the
// batch and the output contiguous NHWC (the output's base 16-byte
// aligned); y_rng / x_rng are each output
// row's / column's [lo, hi) of non-zero taps.  `tile_rows` 0 takes the
// pixel route (tiles, w_taps, x_lo, k_w, k_h and mix unused); else the
// tile route with TY = tile_rows: `tiles` is [ceil(h_out / TY), 2]
// input-row spans of which the widest is `max_span` rows, and every
// non-zero height tap of a tile's rows lies in its span; k_h is at least
// any row's y_rng range; w_taps [w_out, k_w] and x_lo [w_out] the
// compacted width taps (x_lo[x] + k_w <= w_in, k_w <= 16); `mix` 0 when
// cmix is the identity (c_out == c_in).  The launch goes on
// `stream` and does not synchronise.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int mmk_affine_resample(const void* x, int x_is_u8, void* out,
                                   int n_batch, int h_in, int w_in, int c_in,
                                   int h_out, int w_out, int c_out,
                                   const void* a_h, const void* a_w,
                                   const void* y_rng, const void* x_rng,
                                   const void* cmix, const void* mean,
                                   const void* inv, int tile_rows,
                                   const void* tiles, int max_span,
                                   const void* w_taps, const void* x_lo,
                                   int k_w, int k_h, int mix, void* stream) {
  if (c_in < 1 || c_in > kMaxChannels || c_out < 1 || c_out > kMaxChannels ||
      tile_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_pix = static_cast<int64_t>(n_batch) * h_out * w_out;
  if (n_pix == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows > 0) {
    TileArgs a;
    a.x = x;
    a.out = static_cast<float*>(out);
    a.h_in = h_in;
    a.w_in = w_in;
    a.h_out = h_out;
    a.w_out = w_out;
    a.c_out = c_out;
    a.a_h = static_cast<const float*>(a_h);
    a.y_rng = static_cast<const int*>(y_rng);
    a.tiles = static_cast<const int*>(tiles);
    a.w_taps = static_cast<const float*>(w_taps);
    a.x_lo = static_cast<const int*>(x_lo);
    a.cmix = static_cast<const float*>(cmix);
    a.mean = static_cast<const float*>(mean);
    a.inv = static_cast<const float*>(inv);
    a.ty = tile_rows;
    a.n_tiles = (h_out + tile_rows - 1) / tile_rows;
    a.max_span = max_span;
    a.k_w = k_w;
    a.k_h = k_h;
    a.mix = mix;
    if (max_span < 0 || k_w < 1 || k_w > w_in || k_w > kMaxTaps || k_h < 1 ||
        (!mix && c_out != c_in) ||
        static_cast<long long>(n_batch) * a.n_tiles > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (x_is_u8) return launch_tile_c<uint8_t>(a, c_in, n_batch, s);
    return launch_tile_c<float>(a, c_in, n_batch, s);
  }
  int64_t blocks = (n_pix + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (x_is_u8) {
    affine_resample_pixel_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(out), n_batch,
        h_in, w_in, c_in, h_out, w_out, c_out,
        static_cast<const float*>(a_h), static_cast<const float*>(a_w),
        static_cast<const int*>(y_rng), static_cast<const int*>(x_rng),
        static_cast<const float*>(cmix), static_cast<const float*>(mean),
        static_cast<const float*>(inv));
  } else {
    affine_resample_pixel_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_batch,
        h_in, w_in, c_in, h_out, w_out, c_out,
        static_cast<const float*>(a_h), static_cast<const float*>(a_w),
        static_cast<const int*>(y_rng), static_cast<const int*>(x_rng),
        static_cast<const float*>(cmix), static_cast<const float*>(mean),
        static_cast<const float*>(inv));
  }
  return static_cast<int>(cudaGetLastError());
}
