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
// does about a hundred FMAs; the work per byte moved is far below the
// card's FMA/byte balance, so the least time is one uint8 read of the
// input plus one f32 write of the output at 3.35 TB/s.
//
// Design.  The TPU kernel ran the resize as two dense matmuls on the
// MXU, padded to the (8, 128) tile grid, with the width weights
// interleaved per channel into one [W*C, w*C] matrix (768x672 for
// 256->224, almost all zeros).  None of that is a rule here.  The host
// computes, per output row and per output column, the [lo, hi) range of
// the non-zero taps (a few entries each).  One thread computes one
// output pixel (all of its channels): it walks only those taps, reading
// the input through the read-only cache (__ldg; neighbouring threads
// read neighbouring columns, and the overlapping taps of neighbouring
// pixels hit in L1/L2), sums in f32 with FMAs, mixes channels and
// applies the normalize epilogue before its single store.  No shared
// memory and no size gate: any image size works, identity sizes take
// one tap per axis.  Making it fast (a tile of output rows per block,
// the input rows staged in shared memory, 16-byte stores) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load_px(const T* p) {
  return static_cast<float>(__ldg(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
affine_resample_kernel(const T* __restrict__ x, float* __restrict__ out,
                       int n_batch, int h_in, int w_in, int c_in,
                       int h_out, int w_out, int c_out,
                       const float* __restrict__ a_h,
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

}  // namespace

// Plain C entry, loaded with ctypes.  Pointers are device pointers; the
// launch goes on `stream` and does not synchronise.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mmk_affine_resample(const void* x, int x_is_u8, void* out,
                                   int n_batch, int h_in, int w_in, int c_in,
                                   int h_out, int w_out, int c_out,
                                   const void* a_h, const void* a_w,
                                   const void* y_rng, const void* x_rng,
                                   const void* cmix, const void* mean,
                                   const void* inv, void* stream) {
  if (c_in < 1 || c_in > kMaxChannels || c_out < 1 || c_out > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_pix = static_cast<int64_t>(n_batch) * h_out * w_out;
  if (n_pix == 0) return 0;
  int64_t blocks = (n_pix + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (x_is_u8) {
    affine_resample_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), static_cast<float*>(out), n_batch,
        h_in, w_in, c_in, h_out, w_out, c_out,
        static_cast<const float*>(a_h), static_cast<const float*>(a_w),
        static_cast<const int*>(y_rng), static_cast<const int*>(x_rng),
        static_cast<const float*>(cmix), static_cast<const float*>(mean),
        static_cast<const float*>(inv));
  } else {
    affine_resample_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_batch,
        h_in, w_in, c_in, h_out, w_out, c_out,
        static_cast<const float*>(a_h), static_cast<const float*>(a_w),
        static_cast<const int*>(y_rng), static_cast<const int*>(x_rng),
        static_cast<const float*>(cmix), static_cast<const float*>(mean),
        static_cast<const float*>(inv));
  }
  return static_cast<int>(cudaGetLastError());
}
