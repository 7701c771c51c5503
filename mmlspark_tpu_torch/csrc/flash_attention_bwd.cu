// Flash-attention backward for (B, S, H, D) q/k/v/dO: the Hopper port of
// the JAX package's two Pallas kernels
//   B5  mmlspark_tpu/ops/attention_kernels.py::_attention_bwd_dkdv
//   B6  mmlspark_tpu/ops/attention_kernels.py::_attention_bwd_dq
// which its custom VJP (`_flash_bwd`) runs after the forward
// (csrc/flash_attention_fwd.cu, B4).
//
// Computes, for every batch row b and head h, from the forward's
// logsumexp lse[i] and delta[i] = sum_d dO[i][d] * O[i][d] (computed
// outside, as the JAX package does):
//
//   p[i][j]  = exp(scale * q[i].k[j] - lse[i])     for visible (i, j), else 0
//   dp[i][j] = dO[i].v[j]                                          (f32)
//   ds[i][j] = p[i][j] * (dp[i][j] - delta[i]) * scale
//   dV[j]   += round(p[i][j]) * dO[i]      dK[j] += round(ds[i][j]) * q[i]
//   dQ[i]   += round(ds[i][j]) * k[j]
//
// with scale = 1/sqrt(D), "visible" meaning i, j < S and, when causal,
// j <= i, and round() the cast to the input dtype before the product
// (bf16 inputs; a no-op for f32), as the TPU kernels cast p and ds.  p is
// recomputed exactly from lse: no renormalisation pass.  dK, dV and dQ
// are f32 in the (B, S, H, D) layout; lse and delta are f32 [B*H, S].
// An invisible (i, j) contributes nothing, so a row with no visible
// column gets a zero gradient, never NaN.
//
// What bounds it on an H100: at the LM train shape (16, 1024, 12, 64)
// bf16 causal, bytes — q, k, v and dO read once and the f32 gradients
// written once take a little longer at 3.35 TB/s than the visible half
// of the 4 (B5: 8, B6: 6) * S * S * D operations per head take at the
// bf16 tensor-core peak.  Both need every score block to stay on chip:
// no [S, S] tensor is ever written to device memory.
//
// Two kernels, as on the TPU: each output element is summed by exactly
// one thread, in a fixed order — deterministic, no atomics (dQ keeps its
// own pass instead of being folded into B5's with atomics, so gradients
// are reproducible bit for bit).  Routes, by dtype and D alone (a fixed
// shape rule; each raises on a launch error, neither gives way to the
// other):
//   * bf16, D <= 128 — every main path (the LM train layer, D = 64): B5
//     flash_bwd_dkdv_hopper_kernel and B6 flash_bwd_dq_hopper_kernel,
//     below.
//   * bf16, 128 < D <= 256: the mma.sync kernels
//     flash_bwd_dkdv_bf16_kernel / flash_bwd_dq_bf16_kernel.
//   * f32, both: four threads per row, f32 FMAs (the f32 tolerance leaves
//     no room for bf16 or TF32 products); 64-row tiles up to D = 128,
//     32-row tiles for D = 256 (227 KB of shared memory a block).
// The mma.sync kernels: one block of four warps per (b*h, 64-row tile[,
// 64-column chunk of D]), 16 rows a warp.  B5's block holds its keys'
// K and V and streams the visible query tiles; B6's holds its queries' Q
// and dO and streams the visible key tiles (the forward's walk).  The
// score fragments of mma.sync m16n8k16 are, rounded to bf16, the A
// fragments of the next products; B fragments come with ldmatrix.trans.
//
// B5 on Hopper (TMA, mbarriers, wgmma, setmaxnreg; sm_90a).  One block of
// two warpgroups per (b*h, 64-key tile[, 64-column chunk of D]), two
// blocks an SM; key tile 0, which sees the most query tiles under the
// causal mask, launches first.
//   * Warpgroup 0 is the consumer, 64 keys.  Its K and V tiles arrive
//     once, by TMA, and stay in shared memory for the whole query loop:
//     wgmma reads them there as the A operand of the score products, so
//     no thread ever reloads them.
//   * Warpgroup 1 is the producer: it gives up registers (setmaxnreg) and
//     its first warp streams the queries — one thread issues TMA loads of
//     each 64-query tile of Q and dO into a ring of shared-memory stages
//     (4 at D <= 64, 2 at D <= 128), and the warp's lanes copy the tile's
//     lse (as base 2) and delta beside them (plain loads: any S); the
//     stage completes on an mbarrier ("full") and the consumer releases
//     it on another ("empty").  Tensor maps read the (B, S, H, D) strided
//     views directly with 128-byte swizzle; rows past S and columns past
//     D arrive as zeros.  Under the causal mask the stream starts at the
//     block's diagonal tile.
//   * Per query tile, on the transposed scores as before: s^T = K Q^T and
//     dp^T = V dO^T are wgmma products with Q or dO as B, K-major; p (one
//     FFMA and one MUFU a score) and ds come from the accumulators in f32
//     registers; dV += round(P^T) dO and dK += round(dS^T) Q are wgmma
//     products with A from registers (the accumulator rows 16w.. of warp
//     w, packed to bf16) and B = dO or Q, MN-major; p is computed while
//     dp^T runs.  (Overlapping a tile's dV and dK products with the next
//     tile's score products measured slower on the card.)  dK and dV
//     accumulate in f32 registers (64 columns a
//     block; D = 128 walks two column chunks over the grid's z axis, each
//     recomputing the scores) and leave through shared memory (the idle
//     Q/dO ring) with 16-byte stores.
//
// B6 on Hopper: B4's kernel (csrc/flash_attention_fwd.cu) with a second
// score product and no online softmax, since lse is given.  One block of
// two warpgroups per (b*h, query tile), two blocks an SM; under the
// causal mask the last query tiles, which visit the most key tiles,
// launch first.
//   * The producer warpgroup gives up registers; one thread TMA-loads the
//     block's Q and dO once, then streams 64-key K and V tiles through a
//     ring of stages (4 at D <= 64, 2 at D <= 128) on full/empty
//     mbarriers, from the same strided tensor maps as B5.
//   * The consumer warpgroup owns two 64-row halves at D <= 64 (each K/V
//     tile that crosses from L2 serves 128 query rows; the halves run one
//     after the other, so their score registers are shared) and one at
//     D <= 128.  Per key tile and half: s = Q K^T and dp = dO V^T (SS,
//     both K-major, one commit group each, p computed while dp runs);
//     p = 2^(s scale log2e - lse log2e) on the f32 accumulators (one FFMA
//     and one MUFU), masked entries 0; ds = p (dp - delta) scale, rounded
//     to bf16 in registers as the A operand of dQ += ds K, with K MN-major
//     from the same stage.  Each row's lse and delta are read once into
//     registers; key tiles wholly above a half's diagonal are skipped.
//   * dQ accumulates in f32 registers and leaves through the idle K/V
//     ring with 16-byte stores.
// Rows past S and columns past D are masked; any S, no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;  // rows of a bf16 tile (queries or keys)
constexpr int kChunk = 64; // columns of D a bf16 block writes
constexpr int kThreadsBf16 = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) view; d is 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, S]
  const float* delta;  // [B*H, S]
  float* dq;           // (B, S, H, D) contiguous, B6
  float* dk;           // (B, S, H, D) contiguous, B5
  float* dv;           // (B, S, H, D) contiguous, B5
  int B, S, H, D;
  Strides sq, sk, sv, sdo;
  int causal;
  float scale;       // 1/sqrt(D)
  float scale_log2;  // scale * log2(e): p is exp2(s * scale_log2 - lse2)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for a 16x16 (row) bf16 A, a 16x8 (col) bf16 B, f32 C.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Rows row0..row0+63 of one (b, h) slice into dst [64][DP + 8], 16 bytes
// a thread at a time; zeros past S and past D (D is a multiple of 8).
template <int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride,
                                               int row0, int S, int D) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += blockDim.x) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && ch * 8 < D) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + ch * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + ch * 8) = val;
  }
}

// acc[16 rows of this warp x 64 columns] = A[rows] . B[64 rows]^T over DP:
// A's rows start at a_rows (this warp's 16), B's at b (64 rows), both
// [.][DP + 8] bf16 tiles in shared memory.
template <int DP>
__device__ __forceinline__ void warp_abt(float (&acc)[8][4],
                                         const __nv_bfloat16* a_rows,
                                         const __nv_bfloat16* b, int g,
                                         int t) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* ar = a_rows + g * LD + kk * 16 + t * 2;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * LD);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* br = b + (nt * 8 + g) * LD + kk * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
      mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// acc[16 x DC] += round_bf16(X)[16 x 64] . T[64 rows][c0 : c0 + DC]: X is
// a warp's score-shaped fragment (the C layout of warp_abt), T a
// [64][DP + 8] bf16 tile in shared memory.
template <int DP, int DC>
__device__ __forceinline__ void warp_xt(float (&acc)[DC / 8][4],
                                        const float (&x)[8][4],
                                        const __nv_bfloat16* tile, int c0,
                                        int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DC / 8; dt += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        tile + (kk * 16 + (lane & 15)) * LD + c0 + dt * 8 +
                            (lane >> 4) * 8);
      mma_bf16(acc[dt], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[dt + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// Rows row_a and row_a + 8 of acc (the C layout) into the f32
// (B, S, H, D) buffer out, columns c0 + dt * 8 + 2t.
template <int DC>
__device__ __forceinline__ void store_rows(float* out, const Args& a, int b,
                                           int h, int row_a, int c0, int t,
                                           const float (&acc)[DC / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= a.S) continue;
    float* orow =
        out + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int dt = 0; dt < DC / 8; ++dt) {
      const int col = c0 + dt * 8 + t * 2;
      if (col < a.D) {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      }
    }
  }
}

// B5, bf16.  Warp w holds keys n0 + 16w .. + 15 of the block's tile and
// works on the transposed scores s^T[key][query].
template <int DP, int DC>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dkdv_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* vs = ks + kTile * LD;
  __nv_bfloat16* qs = vs + kTile * LD;
  __nv_bfloat16* dos = qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * LD);  // base 2
  float* dl_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * kTile;
  const int c0 = blockIdx.z * DC;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.sdo.b + h * a.sdo.h;
  load_tile_bf16<DP>(ks, kg, a.sk.s, n0, a.S, a.D);
  load_tile_bf16<DP>(vs, vg, a.sv.s, n0, a.S, a.D);

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  const int key_a = n0 + warp * 16 + g;  // this thread's keys: key_a, +8
  const long long row_base = static_cast<long long>(bh) * a.S;

  // under the causal mask, query tiles before the diagonal see no key here
  for (int m0 = a.causal ? n0 : 0; m0 < a.S; m0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(qs, qg, a.sq.s, m0, a.S, a.D);
    load_tile_bf16<DP>(dos, dog, a.sdo.s, m0, a.S, a.D);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = m0 + i < a.S;
      lse_s[i] = in ? a.lse[row_base + m0 + i] * kLog2e : 0.f;
      dl_s[i] = in ? a.delta[row_base + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    warp_abt<DP>(s, ks + warp * 16 * LD, qs, g, t);    // s^T = K Q^T
    warp_abt<DP>(dp, vs + warp * 16 * LD, dos, g, t);  // dp^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + (e >> 1) * 8;
        const int qi = nt * 8 + t * 2 + (e & 1);
        const int query = m0 + qi;
        const bool vis =
            key < a.S && query < a.S && !(a.causal && key > query);
        const float p =
            vis ? exp2f(s[nt][e] * a.scale_log2 - lse_s[qi]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dl_s[qi]) * a.scale;
      }
    }
    warp_xt<DP, DC>(dv, s, dos, c0, lane);  // dV += round(P^T) dO
    warp_xt<DP, DC>(dk, dp, qs, c0, lane);  // dK += round(dS^T) Q
  }
  store_rows<DC>(a.dk, a, b, h, key_a, c0, t, dk);
  store_rows<DC>(a.dv, a, b, h, key_a, c0, t, dv);
}

// B6, bf16.  Warp w holds queries m0 + 16w .. + 15: the forward's walk.
template <int DP, int DC>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* dos = qs + kTile * LD;
  __nv_bfloat16* ks = dos + kTile * LD;
  __nv_bfloat16* vs = ks + kTile * LD;

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * kTile;
  const int c0 = blockIdx.z * DC;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.sdo.b + h * a.sdo.h;
  load_tile_bf16<DP>(qs, qg, a.sq.s, m0, a.S, a.D);
  load_tile_bf16<DP>(dos, dog, a.sdo.s, m0, a.S, a.D);

  const int row_a = m0 + warp * 16 + g;  // this thread's rows: row_a, +8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    const long long i = static_cast<long long>(bh) * a.S + row;
    lse2[r] = row < a.S ? a.lse[i] * kLog2e : 0.f;
    dlt[r] = row < a.S ? a.delta[i] : 0.f;
  }
  float dq[DC / 8][4];
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
  }
  const int n_end = a.causal ? min(a.S, m0 + kTile) : a.S;

  for (int n0 = 0; n0 < n_end; n0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(ks, kg, a.sk.s, n0, a.S, a.D);
    load_tile_bf16<DP>(vs, vg, a.sv.s, n0, a.S, a.D);
    __syncthreads();

    float s[8][4], dp[8][4];
    warp_abt<DP>(s, qs + warp * 16 * LD, ks, g, t);    // s = Q K^T
    warp_abt<DP>(dp, dos + warp * 16 * LD, vs, g, t);  // dp = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e >> 1) * 8;
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        const bool vis = col < a.S && row < a.S && !(a.causal && col > row);
        const float p =
            vis ? exp2f(s[nt][e] * a.scale_log2 - lse2[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dlt[e >> 1]) * a.scale;
      }
    }
    warp_xt<DP, DC>(dq, dp, ks, c0, lane);  // dQ += round(dS) K
  }
  store_rows<DC>(a.dq, a, b, h, row_a, c0, t, dq);
}

// f32: rows row0..row0+R-1 of one (b, h) slice into dst [R][DP + 1] (odd
// row pitch: conflict-free column walks); zeros past S and D.
template <int DP, int R>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride,
                                              int row0, int S, int D) {
  for (int c = threadIdx.x; c < R * DP; c += blockDim.x) {
    const int r = c / DP, d = c % DP;
    float val = 0.f;
    if (row0 + r < S && d < D) {
      val = src[static_cast<long long>(row0 + r) * row_stride + d];
    }
    dst[r * (DP + 1) + d] = val;
  }
}

// B5, f32: R keys a block, four threads a key (thread sub owns the
// queries sub, sub + 4, ... of a tile and the columns sub, sub + 4, ...
// of dK and dV).
template <int DP, int R>
__global__ void __launch_bounds__(4 * R) flash_bwd_dkdv_f32_kernel(Args a) {
  constexpr int LD = DP + 1;
  constexpr int LP = R + 1;
  extern __shared__ float smem_f32[];
  float* ks = smem_f32;
  float* vs = ks + R * LD;
  float* qs = vs + R * LD;
  float* dos = qs + R * LD;
  float* ps = dos + R * LD;  // [R keys][R queries] p
  float* dss = ps + R * LP;  // [R keys][R queries] ds
  float* lse_s = dss + R * LP;
  float* dl_s = lse_s + R;

  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * R;
  const int b = bh / a.H, h = bh % a.H;
  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int key = n0 + r;
  const long long row_base = static_cast<long long>(bh) * a.S;

  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dog =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  load_tile_f32<DP, R>(ks, kg, a.sk.s, n0, a.S, a.D);
  load_tile_f32<DP, R>(vs, vg, a.sv.s, n0, a.S, a.D);

  float dk[DP / 4], dv[DP / 4];
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) dk[c] = dv[c] = 0.f;

  for (int m0 = a.causal ? n0 : 0; m0 < a.S; m0 += R) {
    __syncthreads();
    load_tile_f32<DP, R>(qs, qg, a.sq.s, m0, a.S, a.D);
    load_tile_f32<DP, R>(dos, dog, a.sdo.s, m0, a.S, a.D);
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      const bool in = m0 + i < a.S;
      lse_s[i] = in ? a.lse[row_base + m0 + i] * kLog2e : 0.f;
      dl_s[i] = in ? a.delta[row_base + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[R / 4], dp[R / 4];
#pragma unroll
    for (int c = 0; c < R / 4; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float kv = ks[r * LD + d], vv = vs[r * LD + d];
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        s[c] = fmaf(kv, qs[(sub + 4 * c) * LD + d], s[c]);
        dp[c] = fmaf(vv, dos[(sub + 4 * c) * LD + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int j = sub + 4 * c;
      const int query = m0 + j;
      const bool vis = key < a.S && query < a.S && !(a.causal && key > query);
      const float p = vis ? exp2f(s[c] * a.scale_log2 - lse_s[j]) : 0.f;
      ps[r * LP + j] = p;
      dss[r * LP + j] = p * (dp[c] - dl_s[j]) * a.scale;
    }
    __syncwarp();  // the key's four threads share its p and ds rows
    for (int j = 0; j < R; ++j) {
      const float p = ps[r * LP + j], ds = dss[r * LP + j];
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        dv[c] = fmaf(p, dos[j * LD + sub + 4 * c], dv[c]);
        dk[c] = fmaf(ds, qs[j * LD + sub + 4 * c], dk[c]);
      }
    }
    __syncwarp();
  }
  if (key < a.S) {
    const long long o = ((static_cast<long long>(b) * a.S + key) * a.H + h) *
                        a.D;
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      const int d = sub + 4 * c;
      if (d < a.D) {
        a.dk[o + d] = dk[c];
        a.dv[o + d] = dv[c];
      }
    }
  }
}

// B6, f32: R queries a block, four threads a query.
template <int DP, int R>
__global__ void __launch_bounds__(4 * R) flash_bwd_dq_f32_kernel(Args a) {
  constexpr int LD = DP + 1;
  constexpr int LP = R + 1;
  extern __shared__ float smem_f32[];
  float* qs = smem_f32;
  float* dos = qs + R * LD;
  float* ks = dos + R * LD;
  float* vs = ks + R * LD;
  float* dss = vs + R * LD;  // [R queries][R keys] ds

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * R;
  const int b = bh / a.H, h = bh % a.H;
  const int r = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int row = m0 + r;

  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dog =
      static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  load_tile_f32<DP, R>(qs, qg, a.sq.s, m0, a.S, a.D);
  load_tile_f32<DP, R>(dos, dog, a.sdo.s, m0, a.S, a.D);
  const long long i_row = static_cast<long long>(bh) * a.S + row;
  const float lse2 = row < a.S ? a.lse[i_row] * kLog2e : 0.f;
  const float dlt = row < a.S ? a.delta[i_row] : 0.f;

  float dq[DP / 4];
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) dq[c] = 0.f;
  const int n_end = a.causal ? min(a.S, m0 + R) : a.S;

  for (int n0 = 0; n0 < n_end; n0 += R) {
    __syncthreads();
    load_tile_f32<DP, R>(ks, kg, a.sk.s, n0, a.S, a.D);
    load_tile_f32<DP, R>(vs, vg, a.sv.s, n0, a.S, a.D);
    __syncthreads();

    float s[R / 4], dp[R / 4];
#pragma unroll
    for (int c = 0; c < R / 4; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float qv = qs[r * LD + d], gv = dos[r * LD + d];
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        s[c] = fmaf(qv, ks[(sub + 4 * c) * LD + d], s[c]);
        dp[c] = fmaf(gv, vs[(sub + 4 * c) * LD + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const int j = sub + 4 * c;
      const int col = n0 + j;
      const bool vis = col < a.S && row < a.S && !(a.causal && col > row);
      const float p = vis ? exp2f(s[c] * a.scale_log2 - lse2) : 0.f;
      dss[r * LP + j] = p * (dp[c] - dlt) * a.scale;
    }
    __syncwarp();  // the query's four threads share its ds row
    for (int j = 0; j < R; ++j) {
      const float ds = dss[r * LP + j];
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        dq[c] = fmaf(ds, ks[j * LD + sub + 4 * c], dq[c]);
      }
    }
    __syncwarp();
  }
  if (row < a.S) {
    const long long o = ((static_cast<long long>(b) * a.S + row) * a.H + h) *
                        a.D;
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      const int d = sub + 4 * c;
      if (d < a.D) a.dq[o + d] = dq[c];
    }
  }
}

// ---- B5 on Hopper (bf16, D <= 128) ------------------------------------

// One consumer warpgroup and one producer warpgroup a block
// (hopper::kThreads), two blocks an SM: one block's first loads and
// epilogue overlap the other's products.
constexpr int kHopperKeys = 64;  // keys per block
constexpr int kHopperQ = 64;     // queries per streamed tile

template <int DP>
struct HopperDkdvCfg {
  static constexpr int kSub = DP / 64;               // 64-column boxes
  static constexpr int kStages = DP <= 64 ? 4 : 2;
  static constexpr int kKVBox = kHopperKeys * 128;   // bytes of a K/V box
  static constexpr int kQBox = kHopperQ * 128;       // bytes of a Q/dO box
  static constexpr int kKVBytes = kSub * kKVBox;
  static constexpr int kQStage = kSub * kQBox;
  static constexpr int kOPitch = 64 + 8;             // f32 staging pitch
  // the epilogue stages dK and dV in the Q/dO ring, free after the loop
  static_assert(64 * kOPitch * 4 <= 2 * kStages * kQStage, "");
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes + 2 * kStages * kQStage +
                                  2 * kStages * kHopperQ * 4 +
                                  (1 + 2 * kStages) * 8;
};

// 64 rows x 64 f32 columns of this warpgroup's accumulator (the wgmma C
// layout) to rows row0.., columns c0.. of the contiguous (B, S, H, D) out,
// through the warpgroup's staging buffer: 16-byte stores along each row.
__device__ __forceinline__ void store_tile_hopper(float* out, const Args& a,
                                                  int b, int h, int row0,
                                                  int c0, float* st,
                                                  const float (&acc)[32],
                                                  int tid) {
  constexpr int P = HopperDkdvCfg<64>::kOPitch;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int rl = warp * 16 + g + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + t * 2;
    *reinterpret_cast<float2*>(st + rl * P + col) =
        make_float2(acc[i], acc[i + 1]);
  }
  hopper::named_sync(1, 128);
  for (int idx = tid; idx < 64 * 16; idx += 128) {
    const int rl = idx >> 4, col = (idx & 15) * 4;
    const int row = row0 + rl;
    if (row < a.S && c0 + col < a.D) {
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D +
          c0 + col) = *reinterpret_cast<const float4*>(st + rl * P + col);
    }
  }
  hopper::named_sync(1, 128);  // the buffer is read before reuse
}

// Warpgroup 0 of a block holds keys n0 .. n0 + 63 and works on the
// transposed scores s^T[key][query], as the mma.sync kernel does.
template <int DP>
__global__ void __launch_bounds__(hopper::kThreads, 2)
flash_bwd_dkdv_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             Args a) {
  using C = HopperDkdvCfg<DP>;
  constexpr int ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = hopper::align1024(smem_raw);
  unsigned char* vs = ks + C::kKVBytes;
  unsigned char* qs = vs + C::kKVBytes;
  unsigned char* dos = qs + ST * C::kQStage;
  float* lse_s = reinterpret_cast<float*>(dos + ST * C::kQStage);  // base 2
  float* dl_s = lse_s + ST * kHopperQ;
  float* ostage = reinterpret_cast<float*>(qs);  // after the query loop
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + ST * kHopperQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // key tile 0 (the most query tiles under the causal mask) launches first
  const int n0 = blockIdx.y * kHopperKeys;
  const int c0 = blockIdx.z * 64;  // the columns of dK and dV written
  // under the causal mask, query tiles before the diagonal see no key here
  const int m_start = a.causal ? n0 : 0;
  const int n_q = (a.S - m_start + kHopperQ - 1) / kHopperQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[i], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: warpgroup 1; its first warp streams Q, dO, lse and
    // delta ----
    hopper::setmaxnreg_dec<hopper::kProducerRegs>();
    if (threadIdx.x < 160) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::prefetch_map(&tq);
        hopper::prefetch_map(&tdo);
        hopper::prefetch_map(&tk);
        hopper::prefetch_map(&tv);
        hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) {
          hopper::tma_load_4d(ks + j * C::kKVBox, &tk, kv_full, 64 * j, n0,
                              h, b);
          hopper::tma_load_4d(vs + j * C::kKVBox, &tv, kv_full, 64 * j, n0,
                              h, b);
        }
      }
      const long long row_base = static_cast<long long>(bh) * a.S;
      int stage = 0, phase = 0;
      for (int it = 0; it < n_q; ++it) {
        const int m0 = m_start + it * kHopperQ;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        for (int i = lane; i < kHopperQ; i += 32) {
          const bool in = m0 + i < a.S;
          lse_s[stage * kHopperQ + i] =
              in ? a.lse[row_base + m0 + i] * kLog2e : 0.f;
          dl_s[stage * kHopperQ + i] =
              in ? a.delta[row_base + m0 + i] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * C::kQStage);
#pragma unroll
          for (int j = 0; j < C::kSub; ++j) {
            hopper::tma_load_4d(qs + stage * C::kQStage + j * C::kQBox, &tq,
                                &full[stage], 64 * j, m0, h, b);
            hopper::tma_load_4d(dos + stage * C::kQStage + j * C::kQBox,
                                &tdo, &full[stage], 64 * j, m0, h, b);
          }
        } else {
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer ----
    hopper::setmaxnreg_inc<hopper::kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key_a = n0 + warp * 16 + g;  // this thread's keys: key_a, +8

    hopper::mbar_wait(kv_full, 0);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    int stage = 0, phase = 0;
    for (int it = 0; it < n_q; ++it) {
      const int m0 = m_start + it * kHopperQ;
      // (the stream starts at the diagonal: no tile lies wholly before
      // this block's keys)
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* qst = qs + stage * C::kQStage;
      const unsigned char* dost = dos + stage * C::kQStage;
      // s^T = K Q^T and dp^T = V dO^T: 64 keys x 64 queries each, one
      // commit group each, so p is computed while dp^T runs
      float s[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int j = kk >> 2, c = (kk & 3) * 32;
        hopper::wgmma_ss_n64(s, hopper::desc_kmajor(ks + j * C::kKVBox + c),
                             hopper::desc_kmajor(qst + j * C::kQBox + c),
                             kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int j = kk >> 2, c = (kk & 3) * 32;
        hopper::wgmma_ss_n64(dp,
                             hopper::desc_kmajor(vs + j * C::kKVBox + c),
                             hopper::desc_kmajor(dost + j * C::kQBox + c),
                             kk > 0);
      }
      hopper::wgmma_commit();

      // p = exp(scale q.k - lse) on the visible pairs, ds = p (dp - delta)
      // scale, from the stage's lse (base 2) and delta
      const float* ls = lse_s + stage * kHopperQ;
      const float* dl = dl_s + stage * kHopperQ;
      const bool edge = m0 + kHopperQ > a.S || n0 + kHopperKeys > a.S ||
                        (a.causal && m0 < n0 + kHopperKeys - 1);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        bool vis = true;
        if (edge) {
          const int key = key_a + ((i >> 1) & 1) * 8;
          const int query = m0 + (i >> 2) * 8 + t * 2 + (i & 1);
          vis = key < a.S && query < a.S && !(a.causal && key > query);
        }
        const int qi = (i >> 2) * 8 + t * 2 + (i & 1);
        s[i] = vis ? hopper::exp2_ftz(fmaf(s[i], a.scale_log2, -ls[qi]))
                   : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = (i >> 2) * 8 + t * 2 + (i & 1);
        dp[i] = s[i] * (dp[i] - dl[qi]) * a.scale;
      }
      // dV += round(P^T) dO and dK += round(dS^T) Q over this tile's 64
      // queries: the A fragments are the accumulators', B is MN-major
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pf[kk][e] =
              hopper::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          df[kk][e] =
              hopper::pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      }
      const unsigned char* dob = dost + (c0 >> 6) * C::kQBox;
      const unsigned char* qb = qst + (c0 >> 6) * C::kQBox;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs_n64_mnmajor(
            dv, pf[kk], hopper::desc_mnmajor(dob + kk * 16 * 128), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_rs_n64_mnmajor(
            dk, df[kk], hopper::desc_mnmajor(qb + kk * 16 * 128), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::fence_regs(pf);
      hopper::fence_regs(df);
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    store_tile_hopper(a.dk, a, b, h, n0, c0, ostage, dk, tid);
    store_tile_hopper(a.dv, a, b, h, n0, c0, ostage, dv, tid);
  }
}

template <int DP>
int launch_dkdv_hopper(const Args& a, cudaStream_t stream) {
  using C = HopperDkdvCfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::make_bshd_map(&tq, a.q, a.B, a.S, a.H, a.D, a.sq.b, a.sq.s,
                                a.sq.h, kHopperQ);
  if (e == 0) {
    e = hopper::make_bshd_map(&tdo, a.dout, a.B, a.S, a.H, a.D, a.sdo.b,
                              a.sdo.s, a.sdo.h, kHopperQ);
  }
  if (e == 0) {
    e = hopper::make_bshd_map(&tk, a.k, a.B, a.S, a.H, a.D, a.sk.b, a.sk.s,
                              a.sk.h, kHopperKeys);
  }
  if (e == 0) {
    e = hopper::make_bshd_map(&tv, a.v, a.B, a.S, a.H, a.D, a.sv.b, a.sv.s,
                              a.sv.h, kHopperKeys);
  }
  // checked once: a split the compiled registers cannot cover would hang
  static const int split =
      hopper::check_register_split(flash_bwd_dkdv_hopper_kernel<DP>);
  if (e == 0) e = split;
  if (e != 0) return e;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_hopper_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.S + kHopperKeys - 1) / kHopperKeys),
                  static_cast<unsigned>((a.D + 63) / 64));
  flash_bwd_dkdv_hopper_kernel<DP>
      <<<grid, hopper::kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- B6 on Hopper (bf16, D <= 128) ------------------------------------

template <int DP>
struct HopperDqCfg {
  static constexpr int kSub = DP / 64;               // 64-column boxes
  static constexpr int kHalves = DP <= 64 ? 2 : 1;   // 64-row halves a block
  static constexpr int kM = 64 * kHalves;            // query rows a block
  static constexpr int kStages = DP <= 64 ? 4 : 2;
  static constexpr int kQBox = kM * 128;             // bytes of a Q/dO box
  static constexpr int kKVBox = kHopperKeys * 128;   // bytes of a K/V box
  static constexpr int kQBytes = kSub * kQBox;
  static constexpr int kKVStage = kSub * kKVBox;
  static constexpr int kOPitch = DP + 8;             // f32 staging pitch
  // the epilogue stages dQ in the K/V ring, free after the last tile
  static_assert(kM * kOPitch * 4 <= 2 * kStages * kKVStage, "");
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  2 * kStages * kKVStage +
                                  (1 + 2 * kStages) * 8;
};

// Warpgroup 0 of a block holds query rows m0 .. m0 + kM - 1 (half hf:
// rows m0 + 64 hf .. + 63) and walks the visible key tiles, as B4 does.
template <int DP>
__global__ void __launch_bounds__(hopper::kThreads, 2)
flash_bwd_dq_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           Args a) {
  using C = HopperDqCfg<DP>;
  constexpr int ST = C::kStages;
  constexpr int MH = C::kHalves;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* dos = qs + C::kQBytes;
  unsigned char* ks = dos + C::kQBytes;
  unsigned char* vs = ks + ST * C::kKVStage;
  float* ostage = reinterpret_cast<float*>(ks);  // after the last tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * C::kKVStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // the last query tile (the most key tiles under the causal mask) first
  const int m0 = (gridDim.y - 1 - blockIdx.y) * C::kM;
  // under the causal mask, key tiles past the block's last row see none
  const int n_end = a.causal ? min(a.S, m0 + C::kM) : a.S;
  const int n_tiles = (n_end + kHopperKeys - 1) / kHopperKeys;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: warpgroup 1, one thread of it ----
    hopper::setmaxnreg_dec<hopper::kProducerRegs>();
    if (threadIdx.x == 128) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tdo);
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
        hopper::tma_load_4d(qs + j * C::kQBox, &tq, q_full, 64 * j, m0, h,
                            b);
        hopper::tma_load_4d(dos + j * C::kQBox, &tdo, q_full, 64 * j, m0, h,
                            b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * C::kKVStage);
        unsigned char* kst = ks + stage * C::kKVStage;
        unsigned char* vst = vs + stage * C::kKVStage;
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) {
          hopper::tma_load_4d(kst + j * C::kKVBox, &tk, &full[stage], 64 * j,
                              it * kHopperKeys, h, b);
          hopper::tma_load_4d(vst + j * C::kKVBox, &tv, &full[stage], 64 * j,
                              it * kHopperKeys, h, b);
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer ----
    hopper::setmaxnreg_inc<hopper::kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_a = m0 + warp * 16 + g;  // rows row_a (+8) + 64 hf

    // this thread's rows' lse (base 2) and delta, read once
    float lse2[MH][2], dlt[MH][2];
    float dq[MH][C::kSub][32];
#pragma unroll
    for (int hf = 0; hf < MH; ++hf) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 64 * hf + r * 8;
        const long long i = static_cast<long long>(bh) * a.S + row;
        lse2[hf][r] = row < a.S ? a.lse[i] * kLog2e : 0.f;
        dlt[hf][r] = row < a.S ? a.delta[i] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[hf][j][i] = 0.f;
      }
    }

    hopper::mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * kHopperKeys;
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* kst = ks + stage * C::kKVStage;
      const unsigned char* vst = vs + stage * C::kKVStage;
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
        const int r0 = m0 + 64 * hf;
        // under the causal mask the block's last tile can lie wholly
        // above half 0's diagonal, and that half skips it
        if (a.causal && n0 > r0 + 63) continue;
        // s = Q K^T and dp = dO V^T: 64 rows x 64 keys each, one commit
        // group each, so p is computed while dp runs
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int j = kk >> 2, c = (kk & 3) * 32;
          hopper::wgmma_ss_n64(
              s, hopper::desc_kmajor(qs + j * C::kQBox + hf * 64 * 128 + c),
              hopper::desc_kmajor(kst + j * C::kKVBox + c), kk > 0);
        }
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int j = kk >> 2, c = (kk & 3) * 32;
          hopper::wgmma_ss_n64(
              dp, hopper::desc_kmajor(dos + j * C::kQBox + hf * 64 * 128 + c),
              hopper::desc_kmajor(vst + j * C::kKVBox + c), kk > 0);
        }
        hopper::wgmma_commit();

        // p = exp(scale q.k - lse) on the visible pairs (one FFMA and one
        // MUFU a score), then ds = p (dp - delta) scale
        const bool edge =
            n0 + kHopperKeys > a.S || (a.causal && n0 + kHopperKeys - 1 > r0);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hi = (i >> 1) & 1;
          bool vis = true;
          if (edge) {
            const int row = row_a + 64 * hf + hi * 8;
            const int col = n0 + (i >> 2) * 8 + t * 2 + (i & 1);
            vis = col < a.S && !(a.causal && col > row);
          }
          s[i] = vis ? hopper::exp2_ftz(
                           fmaf(s[i], a.scale_log2, -lse2[hf][hi]))
                     : 0.f;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        // dQ += round(dS) K over this tile's 64 keys: the A fragments are
        // the accumulator's, 16 keys (8 registers) a slice; K is MN-major
        // from the same stage
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d2[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = 8 * kk + 2 * e + u;
              d2[u] = s[i] * (dp[i] - dlt[hf][(i >> 1) & 1]) * a.scale;
            }
            da[kk][e] = hopper::pack_bf16(d2[0], d2[1]);
          }
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < C::kSub; ++j) {
            hopper::wgmma_rs_n64_mnmajor(
                dq[hf][j], da[kk],
                hopper::desc_mnmajor(kst + j * C::kKVBox + kk * 16 * 128), 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) hopper::fence_regs(dq[hf][j]);
        hopper::fence_regs(da);
      }
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: stage the kM x DP f32 rows in the idle K/V ring, then
    // 16-byte stores along each row
#pragma unroll
    for (int hf = 0; hf < MH; ++hf) {
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int rl = 64 * hf + warp * 16 + g + ((i >> 1) & 1) * 8;
          const int col = j * 64 + (i >> 2) * 8 + t * 2;
          *reinterpret_cast<float2*>(ostage + rl * C::kOPitch + col) =
              make_float2(dq[hf][j][i], dq[hf][j][i + 1]);
        }
      }
    }
    hopper::named_sync(1, 128);
    constexpr int kVec = DP / 4;  // float4s a row
    for (int idx = tid; idx < C::kM * kVec; idx += 128) {
      const int rl = idx / kVec, col = (idx % kVec) * 4;
      const int row = m0 + rl;
      if (row < a.S && col < a.D) {
        *reinterpret_cast<float4*>(
            a.dq + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D +
            col) =
            *reinterpret_cast<const float4*>(ostage + rl * C::kOPitch + col);
      }
    }
  }
}

template <int DP>
int launch_dq_hopper(const Args& a, cudaStream_t stream) {
  using C = HopperDqCfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  int e = hopper::make_bshd_map(&tq, a.q, a.B, a.S, a.H, a.D, a.sq.b, a.sq.s,
                                a.sq.h, C::kM);
  if (e == 0) {
    e = hopper::make_bshd_map(&tdo, a.dout, a.B, a.S, a.H, a.D, a.sdo.b,
                              a.sdo.s, a.sdo.h, C::kM);
  }
  if (e == 0) {
    e = hopper::make_bshd_map(&tk, a.k, a.B, a.S, a.H, a.D, a.sk.b, a.sk.s,
                              a.sk.h, kHopperKeys);
  }
  if (e == 0) {
    e = hopper::make_bshd_map(&tv, a.v, a.B, a.S, a.H, a.D, a.sv.b, a.sv.s,
                              a.sv.h, kHopperKeys);
  }
  // checked once: a split the compiled registers cannot cover would hang
  static const int split =
      hopper::check_register_split(flash_bwd_dq_hopper_kernel<DP>);
  if (e == 0) e = split;
  if (e != 0) return e;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_hopper_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.S + C::kM - 1) / C::kM));
  flash_bwd_dq_hopper_kernel<DP>
      <<<grid, hopper::kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int rows, int chunks,
           const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.S + rows - 1) / rows),
                  static_cast<unsigned>(chunks));
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at 128 < D <= 256 (D <= 128 takes the Hopper kernels)
int launch_bf16(bool dkdv, const Args& a, cudaStream_t stream) {
  constexpr int DP = 256;
  constexpr int DC = kChunk;
  const int chunks = (a.D + DC - 1) / DC;
  const size_t tiles =
      4 * static_cast<size_t>(kTile) * (DP + 8) * sizeof(__nv_bfloat16);
  if (dkdv) {
    return launch(flash_bwd_dkdv_bf16_kernel<DP, DC>, kThreadsBf16,
                  tiles + 2 * kTile * sizeof(float), kTile, chunks, a,
                  stream);
  }
  return launch(flash_bwd_dq_bf16_kernel<DP, DC>, kThreadsBf16, tiles, kTile,
                chunks, a, stream);
}

template <int DP>
int launch_f32(bool dkdv, const Args& a, cudaStream_t stream) {
  constexpr int R = DP <= 128 ? 64 : 32;  // tile rows: smem <= 227 KB
  const size_t tiles = 4 * static_cast<size_t>(R) * (DP + 1);
  const size_t scores = static_cast<size_t>(R) * (R + 1);
  if (dkdv) {
    return launch(flash_bwd_dkdv_f32_kernel<DP, R>, 4 * R,
                  (tiles + 2 * scores + 2 * R) * sizeof(float), R, 1, a,
                  stream);
  }
  return launch(flash_bwd_dq_f32_kernel<DP, R>, 4 * R,
                (tiles + scores) * sizeof(float), R, 1, a, stream);
}

int run(bool dkdv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int is_bf16, int B, int S, int H, int D,
        const long long* st, int causal, float scale, void* stream) {
  if (D < 1 || D > 256 || (is_bf16 && D % 8 != 0) || B < 0 || S < 0 ||
      H < 0 || static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  a.sdo = {st[9], st[10], st[11]};
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && dkdv && D <= 128) {
    return D <= 64 ? launch_dkdv_hopper<64>(a, s)
                   : launch_dkdv_hopper<128>(a, s);
  }
  if (is_bf16 && !dkdv && D <= 128) {
    return D <= 64 ? launch_dq_hopper<64>(a, s)
                   : launch_dq_hopper<128>(a, s);
  }
  if (is_bf16) return launch_bf16(dkdv, a, s);
  if (D <= 32) return launch_f32<32>(dkdv, a, s);
  if (D <= 64) return launch_f32<64>(dkdv, a, s);
  if (D <= 128) return launch_f32<128>(dkdv, a, s);
  return launch_f32<256>(dkdv, a, s);
}

}  // namespace

// Plain C entries, loaded with ctypes.  q/k/v/dout are device pointers to
// (B, S, H, D) views with unit d stride; `strides` holds their element
// strides (b, s, h) in that order, 12 values (multiples of 8 for bf16,
// 16-byte aligned bases).  lse and delta are contiguous f32 [B*H, S];
// dk/dv (B5) and dq (B6) contiguous f32 (B, S, H, D) buffers the kernel
// overwrites.  `scale` is 1/sqrt(D).  The launch goes on `stream` and
// does not synchronise.  Each returns the CUDA error of the launch (0 on
// success).
extern "C" int mmk_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int is_bf16,
    int B, int S, int H, int D, const long long* strides, int causal,
    float scale, void* stream) {
  return run(true, q, k, v, dout, lse, delta, nullptr, dk, dv, is_bf16, B,
             S, H, D, strides, causal, scale, stream);
}

extern "C" int mmk_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int is_bf16, int B, int S,
    int H, int D, const long long* strides, int causal, float scale,
    void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, nullptr, nullptr, is_bf16,
             B, S, H, D, strides, causal, scale, stream);
}

// Dynamic shared memory a block of B5's Hopper kernel takes at head dim D
// (bf16, D <= 128), 0 for a D the Hopper route does not take; for reports.
extern "C" int mmk_flash_attention_bwd_dkdv_hopper_smem(int D) {
  if (D < 1 || D > 128) return 0;
  return static_cast<int>(D <= 64 ? HopperDkdvCfg<64>::kSmem
                                  : HopperDkdvCfg<128>::kSmem);
}

// ... and of B6's Hopper kernel.
extern "C" int mmk_flash_attention_bwd_dq_hopper_smem(int D) {
  if (D < 1 || D > 128) return 0;
  return static_cast<int>(D <= 64 ? HopperDqCfg<64>::kSmem
                                  : HopperDqCfg<128>::kSmem);
}
