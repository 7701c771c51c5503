// Fused per-channel normalize + HWC->CHW unroll: the Hopper port of the
// JAX package's Pallas kernel
// mmlspark_tpu/ops/pallas_kernels.py::_fused_normalize_unroll_pallas.
//
// Computes, for every image b, pixel p (row-major over H x W) and
// channel c < C <= 4:
//
//   out[b][c * HW + p] = (x[b][p][c] - mean[c]) * inv[c]
//
// in f32, with x an NHWC f32 batch and out its CHW-flat rows (the
// UnrollImage layout).  The subtraction and the product round one at a
// time (__fsub_rn, __fmul_rn), so no FMA contraction changes a bit
// against the plain version's two separate f32 ops.
//
// What bounds it on an H100: bytes.  One f32 read and one f32 write per
// element and two flops between them; at 3.35 TB/s the least time is
// 8 bytes an element.
//
// Design.  The TPU kernel took one whole image per grid step into VMEM
// and transposed it there.  Here the transpose is a de-interleave of C
// channels through shared memory: a block takes a tile of kTile
// consecutive pixels of one image, reads its kTile*C floats with
// coalesced loads (neighbouring threads, neighbouring addresses) into
// shared memory, and then writes C contiguous runs of kTile floats, one
// into each output plane [b, c, :], again coalesced.  Reading channel c
// of pixel p from shared memory strides by C words: conflict-free for
// C = 1 and 3, 2- and 4-way bank conflicts for C = 2 and 4.  The grid is
// flat over (image, tile), so any batch size and image size work; the
// last tile of an image is ragged.  mean and inv travel by value in the
// kernel's arguments.  Making it fast (16-byte loads and stores, several
// tiles per block) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kThreads = 256;
constexpr int kTile = 1024;  // pixels per block: 16 KB of shared memory at C = 4

struct Consts {
  float mean[kMaxChannels];
  float inv[kMaxChannels];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
normalize_unroll_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int64_t hw, int64_t tiles_per_image, Consts k) {
  __shared__ float tile[kTile * C];
  const int64_t b = blockIdx.x / tiles_per_image;
  const int64_t p0 = (blockIdx.x % tiles_per_image) * kTile;
  const int n = static_cast<int>(hw - p0 < kTile ? hw - p0 : kTile);

  const float* src = x + (b * hw + p0) * C;
  for (int i = threadIdx.x; i < n * C; i += kThreads) tile[i] = __ldg(src + i);
  __syncthreads();

#pragma unroll
  for (int c = 0; c < C; ++c) {
    float* dst = out + (b * C + c) * hw + p0;
    const float m = k.mean[c], s = k.inv[c];
    for (int p = threadIdx.x; p < n; p += kThreads) {
      dst[p] = __fmul_rn(__fsub_rn(tile[p * C + c], m), s);
    }
  }
}

template <int C>
void launch(const float* x, float* out, int64_t n_batch, int64_t hw,
            const Consts& k, cudaStream_t s) {
  const int64_t tiles = (hw + kTile - 1) / kTile;
  normalize_unroll_kernel<C><<<static_cast<unsigned>(n_batch * tiles),
                               kThreads, 0, s>>>(x, out, hw, tiles, k);
}

}  // namespace

// Plain C entry, loaded with ctypes.  x and out are device pointers;
// mean and inv are HOST arrays of c floats, passed to the kernel by
// value.  The launch goes on `stream` and does not synchronise.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int mmk_normalize_unroll(const void* x, void* out,
                                    long long n_batch, long long hw, int c,
                                    const float* mean, const float* inv,
                                    void* stream) {
  if (c < 1 || c > kMaxChannels || n_batch < 0 || hw < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_batch == 0 || hw == 0) return 0;
  const int64_t blocks = n_batch * ((hw + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Consts k{};
  for (int i = 0; i < c; ++i) {
    k.mean[i] = mean[i];
    k.inv[i] = inv[i];
  }
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch<1>(xf, of, n_batch, hw, k, s); break;
    case 2: launch<2>(xf, of, n_batch, hw, k, s); break;
    case 3: launch<3>(xf, of, n_batch, hw, k, s); break;
    default: launch<4>(xf, of, n_batch, hw, k, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
