// On-device decode of the compressed (RLE) wire: the Hopper port of the
// JAX package's Pallas kernel
// mmlspark_tpu/ops/wire_codec.py::_pallas_decode.
//
// Computes, for every output position p < n_pad:
//
//   out[p] = values[r],  r = the first run with ends[r] > p
//
// (upper_bound over the cumulative run ends, the last run catching
// anything past them), with values uint8[R] and ends int32[R]
// non-decreasing, ends[R-1] == n_pad.  That is the host decode (values
// repeated by the run lengths ends[r] - ends[r-1]) and the Pallas
// kernel's "count of ends <= p" within its two run windows.  Run r
// covers the bytes [ends[r-1], ends[r]) (run 0 from 0, run R-1 to the
// end).  Zero-length runs — the power-of-two padding runs and the
// terminal pad run when the chunk already fills a 128-byte block —
// share their end with the run before them and cover nothing.
//
// What bounds it on an H100: bytes.  Each run the chunk needs is read
// (5 bytes) and each output byte written once; at 3.35 TB/s the least
// time is (5 R_used + n_pad) bytes, R_used the runs up to the one that
// holds byte n_pad - 1.  A first design (one thread per 16 output
// bytes, each binary-searching all of `ends` in global memory: 17
// dependent loads at R = 2^17) was bound by the latency of those
// searches instead, at 0.15 of the byte bound.
//
// Design.  One block per output tile of kTile bytes, decoded in shared
// memory.
// - Two warps find the block's run window — the runs of the tile's first
//   and last byte — one byte each, by a 64-way search of `ends`: each
//   lane loads two probes and a ballot counts the probes at or below the
//   byte, which narrows its run to 1/65 of the range a round.  Two rounds
//   at R = 2^17 (the first round's probes are the same for every block
//   and hit L2), three at R = 2^24, stopping within kSlack runs.
// - The block reads the window once, coalesced, and each run writes its
//   value over its bytes of the tile in shared memory: one byte for a
//   run of one, else single bytes to a 4-byte boundary and 4-byte words
//   inside.  How the runs are dealt out follows the window's size, which
//   the block knows: a window of at most kFew * kThreads runs (long runs,
//   as in flat image regions) goes a run a thread, so the fills spread
//   over the most threads; a larger one (short runs, as in noise) goes
//   four runs a thread at a time, from one 16-byte load of ends and one
//   4-byte load of values, the end before them from the left neighbour
//   by a shuffle, which needs a third of the instructions a run.  A tile
//   inside one run is written by one thread with no search of its bytes
//   at all.  Staging the window's ends in shared memory and resolving
//   each output word by a search of them (tried first) took a search and
//   a walk a word and was slower.
// - The block writes the tile out with 16-byte stores, neighbouring
//   threads on neighbouring words.
// - A malformed table (zero-length runs inside the tile, ends out of
//   order, ends short of n_pad) never reads or writes out of bounds:
//   every index stays in [0, R-1], every write is clamped to the tile,
//   and the window, however large, is read in pieces of 4 * kThreads
//   runs.  Bytes that no run covers read as 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;                       // output bytes a block
constexpr int kWords = kTile / 16 / kThreads;     // 16-byte stores a thread
constexpr int kWays = 64;                         // probes a search round
constexpr int kSlack = 256;                       // runs a search stops within
constexpr int kFew = 4;                           // runs a thread, few-run route

// The m-th of kWays probes, m in [1, kWays], spread over [lo, hi - 1].
__device__ __forceinline__ int probe(int lo, int hi, int m) {
  return lo + static_cast<int>(static_cast<long long>(m) * (hi - lo) /
                               (kWays + 1));
}

// A warp's search for the run of byte p: the count of runs i < R-1 with
// ends[i] <= p lies in [lo, hi]; narrow it until it is at most kSlack
// wide.  Warp-uniform.
__device__ __forceinline__ void warp_search(const int* __restrict__ ends,
                                            int& lo, int& hi, int p) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > kSlack) {
    const bool le_a = __ldg(ends + probe(lo, hi, 2 * lane + 1)) <= p;
    const bool le_b = __ldg(ends + probe(lo, hi, 2 * lane + 2)) <= p;
    const int c = __popc(__ballot_sync(0xffffffffu, le_a)) +
                  __popc(__ballot_sync(0xffffffffu, le_b));
    const int nlo = c > 0 ? probe(lo, hi, c) + 1 : lo;
    const int nhi = c < kWays ? probe(lo, hi, c + 1) : hi;
    lo = min(nlo, nhi);  // min: out-of-order ends cannot invert the range
    hi = nhi;
  }
}

// value v over the tile's bytes [a, b)
__device__ __forceinline__ void fill(uint8_t* tile, int a, int b,
                                     uint32_t v) {
  if (b - a == 1) {  // most runs of noisy data
    tile[a] = static_cast<uint8_t>(v);
    return;
  }
  for (; a < b && (a & 3); ++a) tile[a] = static_cast<uint8_t>(v);
  const uint32_t v4 = v * 0x01010101u;
  for (; a + 4 <= b; a += 4) *reinterpret_cast<uint32_t*>(tile + a) = v4;
  for (; a < b; ++a) tile[a] = static_cast<uint8_t>(v);
}

__global__ void __launch_bounds__(kThreads)
rle_decode_kernel(const uint8_t* __restrict__ values,
                  const int* __restrict__ ends, int r,
                  uint8_t* __restrict__ out, int n_pad) {
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ int win[4];

  const int t0 = blockIdx.x * kTile;
  const int len = static_cast<int>(
      min(static_cast<long long>(kTile), static_cast<long long>(n_pad) - t0));
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    reinterpret_cast<uint4*>(tile)[k * kThreads + threadIdx.x] = zero;

  // the run window: warp 0 searches the run of byte t0, warp 1 that of
  // the tile's last byte
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    int lo = 0, hi = r - 1;
    warp_search(ends, lo, hi, warp == 0 ? t0 : t0 + len - 1);
    if ((threadIdx.x & 31) == 0) {
      win[2 * warp] = lo;
      win[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const int q_begin = win[0], q_end = max(win[3], win[0]) + 1;

  // each run of the window over its bytes of the tile
  const int t1 = t0 + len;
  if (q_end - q_begin <= kThreads * kFew) {
    // few runs, so long ones: a run a thread spreads the fills widest
    int s[kFew], e[kFew];
    uint32_t v[kFew];
#pragma unroll
    for (int u = 0; u < kFew; ++u) {
      const int i = q_begin + u * kThreads + threadIdx.x;
      s[u] = e[u] = 0;
      v[u] = 0u;
      if (i < q_end) {
        s[u] = i > 0 ? min(max(__ldg(ends + i - 1), t0), t1) - t0 : 0;
        e[u] = i < r - 1 ? min(max(__ldg(ends + i), t0), t1) - t0 : len;
        v[u] = __ldg(values + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kFew; ++u) fill(tile, s[u], e[u], v[u]);
  } else {
    // many runs, so short ones: four a thread at a time, from one 16-byte
    // load of ends and one 4-byte load of values (the window read from a
    // multiple of four), the end before them from the left neighbour
    const int lane = threadIdx.x & 31;
    for (int base = q_begin & ~3; base < q_end;
         base += min(q_end - base, 4 * kThreads)) {
      const long long q = static_cast<long long>(base) + 4 * threadIdx.x;
      int4 e4 = make_int4(t0, t0, t0, t0);
      uint32_t v4 = 0u;
      if (q + 3 < r) {
        e4 = __ldg(reinterpret_cast<const int4*>(ends + q));
        v4 = __ldg(reinterpret_cast<const uint32_t*>(values + q));
      } else if (q < r) {  // the table's last runs
        const int i = static_cast<int>(q);
        e4.x = __ldg(ends + i);
        e4.y = i + 1 < r ? __ldg(ends + i + 1) : e4.x;
        e4.z = i + 2 < r ? __ldg(ends + i + 2) : e4.y;
        for (int k = 0; k < 3 && i + k < r; ++k)
          v4 |= static_cast<uint32_t>(__ldg(values + i + k)) << (8 * k);
      }
      int prev = __shfl_up_sync(0xffffffffu, e4.w, 1);
      if (lane == 0) prev = q > 0 && q - 1 < r ? __ldg(ends + q - 1) : 0;
      // clamped tile offsets of the five ends; run R-1 runs to the end
      int c[5] = {prev, e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int k = 0; k < 5; ++k) c[k] = min(max(c[k], t0), t1) - t0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = q + k;
        if (i < q_begin || i >= q_end) continue;
        fill(tile, c[k], i == r - 1 ? len : c[k + 1],
             (v4 >> (8 * k)) & 0xffu);
      }
    }
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + t0);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int w = k * kThreads + threadIdx.x;
    if (w < len / 16) dst[w] = reinterpret_cast<const uint4*>(tile)[w];
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  Pointers are device pointers; `out`
// and `ends` are 16-byte aligned, `values` 4-byte aligned, and n_pad a
// multiple of 16 (the wire pads to 128).
// The launch goes on `stream` and does not synchronise.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int mmk_rle_decode(const void* values, const void* ends, int r,
                              void* out, long long n_pad, void* stream) {
  if (r < 1 || n_pad < 0 || n_pad % 16 != 0 || n_pad > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ends) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(values) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pad == 0) return 0;
  const long long blocks = (n_pad + kTile - 1) / kTile;
  rle_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(values), static_cast<const int*>(ends), r,
      static_cast<uint8_t*>(out), static_cast<int>(n_pad));
  return static_cast<int>(cudaGetLastError());
}
