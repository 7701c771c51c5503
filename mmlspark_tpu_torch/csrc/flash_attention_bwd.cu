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
// Design (a first design: right and simple, not yet fast).  Two kernels,
// as on the TPU: each output element is summed by exactly one thread, in
// a fixed order — deterministic, no atomics.
//   * B5: one thread block per (b*h, 64-key tile[, 64-column chunk of D]).
//     The block's K and V tiles stay in shared memory; it streams the
//     visible 64-query tiles of Q, dO, lse and delta (under the causal
//     mask it starts at the diagonal tile) and holds dK and dV for its
//     keys in f32 registers.
//   * B6: one thread block per (b*h, 64-query tile[, column chunk]): the
//     forward's walk.  Q and dO stay in shared memory; it streams the
//     visible K/V tiles and holds dQ in f32 registers.
//   * bf16: four warps, 16 keys (B5) or 16 queries (B6) each.  Every
//     product is a warp-level tensor-core mma.sync m16n8k16, bf16 in, f32
//     accumulate.  B5 works on the transposed scores (keys x queries), so
//     the score and dp fragments are, register for register, the A
//     fragments of dV += P^T dO and dK += dS^T Q once rounded to bf16;
//     the B fragments come from shared memory with ldmatrix.trans.  A
//     block writes 64 columns of D (the register budget of the f32
//     accumulators); for D = 128 or 256 the grid's z axis walks the
//     chunks and each chunk recomputes the scores.
//   * f32: four threads per row, f32 FMAs (the f32 tolerance leaves no
//     room for bf16 or TF32 products), p and ds through shared memory;
//     64-row tiles up to D = 128, 32-row tiles for D = 256 (227 KB of
//     shared memory a block).
// Rows past S and columns past D are zero-filled in shared memory and
// masked; any S, no padding.  Not yet: cp.async/TMA double buffering,
// wgmma and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int DP>
int launch_bf16(bool dkdv, const Args& a, cudaStream_t stream) {
  constexpr int DC = DP < kChunk ? DP : kChunk;
  const int chunks = (a.D + DC - 1) / DC;
  const size_t tiles =
      4 * static_cast<size_t>(kTile) * (DP + 8) * sizeof(__nv_bfloat16);
  if (dkdv) {
    return launch(flash_bwd_dkdv_bf16_kernel<DP, DC>, kThreadsBf16,
                  tiles + 2 * kTile * sizeof(float), kTile, chunks, a, stream);
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
  if (is_bf16) {
    if (D <= 32) return launch_bf16<32>(dkdv, a, s);
    if (D <= 64) return launch_bf16<64>(dkdv, a, s);
    if (D <= 128) return launch_bf16<128>(dkdv, a, s);
    return launch_bf16<256>(dkdv, a, s);
  }
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
