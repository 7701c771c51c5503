// On-device decode of the compressed (RLE) wire: the Hopper port of the
// JAX package's Pallas kernel
// mmlspark_tpu/ops/wire_codec.py::_pallas_decode.
//
// Computes, for every output position p < n_pad:
//
//   out[p] = values[r],  r = the first run with ends[r] > p
//
// (upper_bound over the cumulative run ends), with values uint8[R] and
// ends int32[R] non-decreasing, ends[R-1] == n_pad.  That is the host
// decode (values repeated by the run lengths ends[r] - ends[r-1]) and
// the Pallas kernel's "count of ends <= p" within its two run windows.
// Zero-length runs — the power-of-two padding runs and the terminal pad
// run when the chunk already fills a 128-byte block — share their end
// with the run before them, so the upper bound never lands on them.
//
// What bounds it on an H100: bytes.  Each run entry is read (5 bytes)
// and each output byte written once, with a few integer compares per
// byte; at 3.35 TB/s the least time is (5 R + n_pad) bytes.
//
// Design.  The TPU kernel walked 128-byte output blocks, each fetching
// two 128-run windows picked by a host-built scalar-prefetch table
// (`first_run`) and resolving every byte against all 256 ends of the
// window.  Here no table is needed: one thread owns 16 consecutive
// output bytes, finds the run of its first byte by a binary search over
// `ends` (the top levels of the search hit in L1/L2, shared by the whole
// block), walks forward through the following runs for the other 15
// bytes, packs them into registers and writes them with one 16-byte
// store; neighbouring threads write neighbouring 16-byte words.  The
// walk never passes the last run, so a malformed table cannot read out
// of bounds.  Making it fast (staging a block's run window in shared
// memory, skipping the search for threads inside one long run) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytes = 16;  // output bytes per thread: one 16-byte store

__global__ void __launch_bounds__(kThreads)
rle_decode_kernel(const uint8_t* __restrict__ values,
                  const int* __restrict__ ends, int r,
                  uint8_t* __restrict__ out, int64_t n_words) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_words) return;
  const int p0 = static_cast<int>(t * kBytes);

  // upper bound of p0 in ends[0, r-1]; the last run catches the rest
  int lo = 0, hi = r - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > p0) hi = mid; else lo = mid + 1;
  }
  int run = lo;
  int end = __ldg(ends + run);
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    while (end <= p0 + k && run < r - 1) end = __ldg(ends + ++run);
    word[k >> 2] |= static_cast<uint32_t>(__ldg(values + run)) << (8 * (k & 3));
  }
  reinterpret_cast<uint4*>(out)[t] = make_uint4(word[0], word[1], word[2], word[3]);
}

}  // namespace

// Plain C entry, loaded with ctypes.  Pointers are device pointers; `out`
// is 16-byte aligned and n_pad a multiple of 16 (the wire pads to 128).
// The launch goes on `stream` and does not synchronise.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mmk_rle_decode(const void* values, const void* ends, int r,
                              void* out, long long n_pad, void* stream) {
  if (r < 1 || n_pad < 0 || n_pad % kBytes != 0 || n_pad > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ends) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_words = n_pad / kBytes;
  if (n_words == 0) return 0;
  const int64_t blocks = (n_words + kThreads - 1) / kThreads;
  rle_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int*>(ends), r,
      static_cast<uint8_t*>(out), n_words);
  return static_cast<int>(cudaGetLastError());
}
