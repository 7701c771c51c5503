// Flash-attention forward for (B, S, H, D) q/k/v: the Hopper port of the
// JAX package's Pallas kernel
// mmlspark_tpu/ops/attention_kernels.py::_attention_pallas (B4).
//
// Computes, for every batch row b, head h and query row i,
//
//   s[j]      = scale * sum_d q[b][i][h][d] * k[b][j][h][d]      (f32)
//   lse[i]    = log sum_j exp(s[j])           over the visible j
//   o[b][i][h]= sum_j round(exp(s[j] - m)) * v[b][j][h] / sum_j exp(s[j] - m)
//
// with scale = 1/sqrt(D), "visible" meaning j < S and, when causal,
// j <= i, and round() the cast of the probabilities to the input dtype
// before the PV product (bf16 inputs; a no-op for f32), as the TPU kernel
// does.  O is f32 in the (B, S, H, D) layout, lse f32 [B*H, S].  A row
// with no visible column (impossible with self-attention, kept as a
// guard) gets O = 0, not NaN.
//
// What bounds it on an H100: at the main path's shapes (S = 196 to 1024,
// D = 64) bytes — q, k and v read once and the f32 O written once
// take longer at 3.35 TB/s than the 4*S*S*D operations per head take at
// the bf16 tensor-core peak (989 TFLOP/s).  Both need every score block
// to stay on chip: the [S, S] scores are never written to device memory.
//
// Routes, by dtype and D alone (a fixed shape rule; each raises on a
// launch error, neither gives way to the other):
//   * bf16, D <= 128: the Hopper kernel below (flash_fwd_hopper_kernel).
//     Every main path (ViT-B/16, TransformerLM prefill, serving
//     admission, LM training: D = 64) takes it.
//   * bf16, 128 < D <= 256: flash_fwd_bf16_kernel, mma.sync m16n8k16.
//   * f32: flash_fwd_f32_kernel, f32 FMAs (the f32 tolerance leaves no
//     room for bf16 or TF32 products).
//
// The Hopper kernel (TMA, mbarriers, wgmma, setmaxnreg; sm_90a).  One
// block of two warpgroups per (b*h, 128-query tile at D <= 64, 64-query
// tile at D <= 128), two blocks an SM, so one block's first loads and
// epilogue overlap the other's products; under the causal mask the grid
// launches the tiles nearest the end of the sequence (the most keys to
// visit) first.  Timed on the card with each part left out in turn
// (attention_ablation.py), neither product nor the exponentials bounds
// it; the bytes it moves weigh most — K/V tiles read again from L2 for
// each query tile, and the f32 O — so a block's 64-key K/V tiles serve
// as many query rows as the consumer's registers hold.
//   * Warpgroup 1 is the producer: it gives up registers (setmaxnreg, a
//     whole warpgroup as the instruction requires) and one thread issues
//     TMA loads — the Q tile once, then each K/V tile into a ring of
//     shared-memory stages (4 at D <= 64, 2 at D <= 128), each completed
//     on an mbarrier ("full") and released by the consumer on another
//     ("empty").  The tensor maps read the (B, S, H, D) strided views
//     directly (dims D, S, H, B; boxes of 64 columns), with 128-byte
//     swizzle; rows past S and columns past D arrive as zeros, so the
//     masks are the only masks and any S needs no padding.
//   * Warpgroup 0 is the consumer, in 64-row halves (two at D <= 64).
//     S = Q.K^T is a wgmma with Q and K from shared memory (both
//     K-major); the online softmax runs on the accumulator in f32
//     registers, in base 2 with the scale folded into one FFMA and 2^x
//     one MUFU instruction; P, rounded to bf16, becomes the register A
//     operand of O += P.V, a wgmma with V MN-major from shared memory.
//     Under the causal mask a half skips a tile wholly above its
//     diagonal.
//   * Epilogue: the consumer normalises O, stages its rows through the
//     (then idle) K/V ring and writes them with 16-byte stores (O is the
//     largest stream: 50 MB of the 127 MB at the LM train shape).
//   A D under 64 (or between 64 and 128) is padded with TMA's zeros to
//   64-column boxes.  Not yet: TMA multicast of K/V across a cluster of
//   blocks, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kThreadsBf16 = 128;
constexpr int kThreadsF32 = 256;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;  // element strides of a (B, S, H, D) view; d is 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* lse;
  int B, S, H, D;
  Strides sq, sk, sv;
  int causal;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
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
  for (int c = threadIdx.x; c < kBlockM * kChunks; c += blockDim.x) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && ch * 8 < D) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + ch * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + ch * 8) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsBf16)
flash_fwd_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;  // padded row: conflict-free 32-bit reads
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* ks = qs + kBlockM * LD;
  __nv_bfloat16* vs = ks + kBlockN * LD;

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * kBlockM;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;
  load_tile_bf16<DP>(qs, qg, a.sq.s, m0, a.S, a.D);

  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums of its rows
  const int row_a = m0 + warp * 16 + g;  // this thread's rows: row_a, +8
  const int n_end = a.causal ? min(a.S, m0 + kBlockM) : a.S;

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    load_tile_bf16<DP>(ks, kg, a.sk.s, n0, a.S, a.D);
    load_tile_bf16<DP>(vs, vg, a.sv.s, n0, a.S, a.D);
    __syncthreads();

    // s = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qr = qs + (warp * 16 + g) * LD + kk * 16 + t * 2;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qr);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qr + 8 * LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qr + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qr + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[nt], a0, a1, a2, a3, b0, b1);
      }
    }

    // masks, then the online-softmax update in base 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e >> 1) * 8;
        const int col = n0 + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * a.scale_log2;
        if (col >= a.S || (a.causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += round_bf16(P) V: P's A fragments are the score fragments
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DP / 8; dt += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(
            b0, b1, b2, b3,
            vs + (kk * 16 + (lane & 15)) * LD + dt * 8 + (lane >> 4) * 8);
        mma_bf16(o[dt], a0, a1, a2, a3, b0, b1);
        mma_bf16(o[dt + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= a.S) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-20f);
    float* orow =
        a.o + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + t * 2;
      if (col < a.D) {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      }
    }
    if (t == 0) {
      const float m = m_run[r] == -INFINITY ? 0.f : m_run[r];
      a.lse[static_cast<long long>(bh) * a.S + row] =
          (m + log2f(fmaxf(l_run[r], 1e-20f))) * kLn2;
    }
  }
}

// f32: rows row0..row0+63 of one (b, h) slice into dst [64][DP + 1]
// (odd row pitch: conflict-free column walks); zeros past S and D.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride,
                                              int row0, int S, int D) {
  for (int c = threadIdx.x; c < kBlockM * DP; c += blockDim.x) {
    const int r = c / DP, d = c % DP;
    float val = 0.f;
    if (row0 + r < S && d < D) {
      val = src[static_cast<long long>(row0 + r) * row_stride + d];
    }
    dst[r * (DP + 1) + d] = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(Args a) {
  constexpr int LD = DP + 1;
  constexpr int LP = kBlockN + 1;
  extern __shared__ float smem_f32[];
  float* qs = smem_f32;
  float* ks = qs + kBlockM * LD;
  float* vs = ks + kBlockN * LD;
  float* ps = vs + kBlockN * LD;  // [64][65] probabilities

  const int bh = blockIdx.x;
  const int m0 = blockIdx.y * kBlockM;
  const int b = bh / a.H, h = bh % a.H;
  const int row_l = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int row = m0 + row_l;

  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  load_tile_f32<DP>(qs, qg, a.sq.s, m0, a.S, a.D);

  float o[DP / 4];  // columns sub, sub + 4, ...
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) o[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_end = a.causal ? min(a.S, m0 + kBlockM) : a.S;

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();
    load_tile_f32<DP>(ks, kg, a.sk.s, n0, a.S, a.D);
    load_tile_f32<DP>(vs, vg, a.sv.s, n0, a.S, a.D);
    __syncthreads();

    float s[kBlockN / 4];  // keys sub, sub + 4, ...
#pragma unroll
    for (int c = 0; c < kBlockN / 4; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float qv = qs[row_l * LD + d];
#pragma unroll
      for (int c = 0; c < kBlockN / 4; ++c) {
        s[c] = fmaf(qv, ks[(sub + 4 * c) * LD + d], s[c]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBlockN / 4; ++c) {
      const int col = n0 + sub + 4 * c;
      float x = s[c] * a.scale_log2;
      if (col >= a.S || (a.causal && col > row)) x = -INFINITY;
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m_run - m_use);
    m_run = m_new;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < kBlockN / 4; ++c) {
      const float p = exp2f(s[c] - m_use);
      rs += p;
      ps[row_l * LP + sub + 4 * c] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * corr + rs;
    __syncwarp();  // the row's four threads share their P row
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) o[c] *= corr;
    for (int j = 0; j < kBlockN; ++j) {
      const float p = ps[row_l * LP + j];
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        o[c] = fmaf(p, vs[j * LD + sub + 4 * c], o[c]);
      }
    }
    __syncwarp();  // P is read before the next tile rewrites it
  }

  if (row < a.S) {
    const float inv = 1.f / fmaxf(l_run, 1e-20f);
    float* orow =
        a.o + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      const int d = sub + 4 * c;
      if (d < a.D) orow[d] = o[c] * inv;
    }
    if (sub == 0) {
      const float m = m_run == -INFINITY ? 0.f : m_run;
      a.lse[static_cast<long long>(bh) * a.S + row] =
          (m + log2f(fmaxf(l_run, 1e-20f))) * kLn2;
    }
  }
}

using hopper::desc_kmajor;
using hopper::desc_mnmajor;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_wait;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// One consumer warpgroup and one producer warpgroup a block
// (hopper::kThreads), two blocks an SM: one block's first loads and
// epilogue overlap the other's products.  At D <= 64 the consumer owns
// two 64-row halves, so each K/V tile that crosses from L2 serves 128
// query rows; at D <= 128 its registers hold one half.
template <int DP>
struct HopperFwdCfg {
  static constexpr int kSub = DP / 64;         // 64-column boxes
  static constexpr int kHalves = DP <= 64 ? 2 : 1;
  static constexpr int kM = 64 * kHalves;      // query rows a block
  static constexpr int kBN = 64;               // keys a K/V stage
  static constexpr int kStages = DP <= 64 ? 4 : 2;
  static constexpr int kQBox = kM * 128;       // bytes of one Q box
  static constexpr int kKVBox = kBN * 128;     // bytes of one K/V box
  static constexpr int kOPitch = DP + 8;       // f32 staging pitch
  static constexpr int kQBytes = kSub * kQBox;
  static constexpr int kKVStage = kSub * kKVBox;
  // the epilogue stages O in the K/V ring, free once the last tile is done
  static_assert(kM * kOPitch * 4 <= 2 * kStages * kKVStage, "");
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVStage + (1 + 2 * kStages) * 8;
};

template <int DP>
__global__ void __launch_bounds__(hopper::kThreads, 2)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Args a) {
  using C = HopperFwdCfg<DP>;
  constexpr int BN = C::kBN;
  constexpr int ST = C::kStages;
  constexpr int MH = C::kHalves;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = hopper::align1024(smem_raw);
  unsigned char* ks = qs + C::kQBytes;
  unsigned char* vs = ks + ST * C::kKVStage;
  float* ostage = reinterpret_cast<float*>(ks);  // after the last tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + ST * C::kKVStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // the last query tile (the most keys under the causal mask) first
  const int m0 = (gridDim.y - 1 - blockIdx.y) * C::kM;
  const int n_end = a.causal ? min(a.S, m0 + C::kM) : a.S;
  const int n_tiles = (n_end + BN - 1) / BN;

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
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
        tma_load_4d(qs + j * C::kQBox, &tq, q_full, 64 * j, m0, h, b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * C::kKVStage);
        unsigned char* kst = ks + stage * C::kKVStage;
        unsigned char* vst = vs + stage * C::kKVStage;
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) {
          tma_load_4d(kst + j * C::kKVBox, &tk, &full[stage], 64 * j,
                      it * BN, h, b);
          tma_load_4d(vst + j * C::kKVBox, &tv, &full[stage], 64 * j,
                      it * BN, h, b);
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer: warpgroup 0 owns query rows m0 .. m0 + kM - 1, half
    // hf of them rows m0 + 64 hf .. + 63 ----
    hopper::setmaxnreg_inc<hopper::kConsumerRegs>();
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_a = m0 + warp * 16 + g;  // rows row_a (+8) + 64 hf

    float o[MH][C::kSub][32];
    float m_run[MH][2], l_run[MH][2];  // l: this thread's partial sums
#pragma unroll
    for (int hf = 0; hf < MH; ++hf) {
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][j][i] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[hf][r] = -INFINITY;
        l_run[hf][r] = 0.f;
      }
    }

    mbar_wait(q_full, 0);
    // Under the causal mask the last tile lies wholly above half 0's
    // diagonal, and that half skips it.
    int stage = 0, phase = 0;
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * BN;
      bool live[MH];
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
        live[hf] = !(a.causal && n0 > m0 + 64 * hf + 63);
      }
      mbar_wait(&full[stage], phase);
      const unsigned char* kst = ks + stage * C::kKVStage;
      const unsigned char* vst = vs + stage * C::kKVStage;
      // S = Q K^T: 64 rows x BN keys a half
      float s[MH][BN / 2];
      wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
        if (!live[hf]) continue;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int j = kk >> 2, c = (kk & 3) * 32;
          hopper::wgmma_ss_n64(
              s[hf], desc_kmajor(qs + j * C::kQBox + hf * 64 * 128 + c),
              desc_kmajor(kst + j * C::kKVBox + c), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) fence_regs(s[hf]);

      uint32_t pa[MH][BN / 16][4];  // P, the A operand of P V
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
        if (!live[hf]) continue;
        // masks, then the online-softmax update in base 2: the running
        // max m is kept scaled (scale * log2(e) * max s; the scale is
        // > 0) and p = 2^(s * scale_log2 - m) is one FFMA and one MUFU
        const int r0 = m0 + 64 * hf;
        const bool edge = n0 + BN > a.S || (a.causal && n0 + BN - 1 > r0);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int hi = (i >> 1) & 1;
          if (edge) {
            const int row = row_a + 64 * hf + hi * 8;
            const int col = n0 + (i >> 2) * 8 + t * 2 + (i & 1);
            if (col >= a.S || (a.causal && col > row)) s[hf][i] = -INFINITY;
          }
          mx[hi] = fmaxf(mx[hi], s[hf][i]);
        }
        float corr[2], m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[hf][r], mx[r] * a.scale_log2);
          m_use[r] = m_new == -INFINITY ? 0.f : m_new;
          corr[r] = hopper::exp2_ftz(m_run[hf][r] - m_use[r]);
          m_run[hf][r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int hi = (i >> 1) & 1;
          const float p =
              hopper::exp2_ftz(fmaf(s[hf][i], a.scale_log2, -m_use[hi]));
          s[hf][i] = p;
          rs[hi] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[hf][r] = l_run[hf][r] * corr[r] + rs[r];
        }
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[hf][j][i] *= corr[(i >> 1) & 1];
        }
        // P's register A fragments are the score accumulator's, 16 keys
        // (8 registers) a slice, rounded to bf16
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[hf][kk][e] = pack_bf16(s[hf][8 * kk + 2 * e],
                                      s[hf][8 * kk + 2 * e + 1]);
          }
        }
      }

      // O += round_bf16(P) V
      wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
        if (!live[hf]) continue;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < C::kSub; ++j) {
            hopper::wgmma_rs_n64_mnmajor(
                o[hf][j], pa[hf][kk],
                desc_mnmajor(vst + j * C::kKVBox + kk * 16 * 128), 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) fence_regs(o[hf][j]);
        fence_regs(pa[hf]);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: normalise, stage the kM x DP f32 rows in shared memory,
    // then 16-byte stores along each row
#pragma unroll
    for (int hf = 0; hf < MH; ++hf) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[hf][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-20f);
        const int row = row_a + 64 * hf + r * 8;
        if (t == 0 && row < a.S) {
          const float m = m_run[hf][r] == -INFINITY ? 0.f : m_run[hf][r];
          a.lse[static_cast<long long>(bh) * a.S + row] =
              (m + log2f(fmaxf(l, 1e-20f))) * kLn2;
        }
      }
#pragma unroll
      for (int j = 0; j < C::kSub; ++j) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int hi = (i >> 1) & 1;
          const int rl = 64 * hf + warp * 16 + g + hi * 8;
          const int col = j * 64 + (i >> 2) * 8 + t * 2;
          *reinterpret_cast<float2*>(ostage + rl * C::kOPitch + col) =
              make_float2(o[hf][j][i] * inv[hi], o[hf][j][i + 1] * inv[hi]);
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
            a.o + ((static_cast<long long>(b) * a.S + row) * a.H + h) * a.D +
            col) =
            *reinterpret_cast<const float4*>(ostage + rl * C::kOPitch + col);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.S + kBlockM - 1) / kBlockM));
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_hopper(const Args& a, cudaStream_t stream) {
  using C = HopperFwdCfg<DP>;
  CUtensorMap tq, tk, tv;
  int e = hopper::make_bshd_map(&tq, a.q, a.B, a.S, a.H, a.D, a.sq.b, a.sq.s,
                                a.sq.h, C::kM);
  if (e == 0) {
    e = hopper::make_bshd_map(&tk, a.k, a.B, a.S, a.H, a.D, a.sk.b, a.sk.s,
                              a.sk.h, C::kBN);
  }
  if (e == 0) {
    e = hopper::make_bshd_map(&tv, a.v, a.B, a.S, a.H, a.D, a.sv.b, a.sv.s,
                              a.sv.h, C::kBN);
  }
  // checked once: a split the compiled registers cannot cover would hang
  static const int split =
      hopper::check_register_split(flash_fwd_hopper_kernel<DP>);
  if (e == 0) e = split;
  if (e != 0) return e;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_hopper_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.S + C::kM - 1) / C::kM));
  flash_fwd_hopper_kernel<DP>
      <<<grid, hopper::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlockM + 2 * kBlockN) * (DP + 8) *
                      sizeof(__nv_bfloat16);
  return launch(flash_fwd_bf16_kernel<DP>, kThreadsBf16, smem, a, stream);
}

template <int DP>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBlockM + 2 * kBlockN) * (DP + 1) +
       static_cast<size_t>(kBlockM) * (kBlockN + 1)) *
      sizeof(float);
  return launch(flash_fwd_f32_kernel<DP>, kThreadsF32, smem, a, stream);
}

}  // namespace

// Plain C entry, loaded with ctypes.  q/k/v are device pointers to
// (B, S, H, D) views with unit d stride and the given element strides
// (multiples of 8 for bf16, 16-byte aligned bases); o is a contiguous
// f32 (B, S, H, D) buffer and lse a contiguous f32 [B*H, S] one.
// `scale` is 1/sqrt(D).  The launch goes on `stream` and does not
// synchronise.  Returns the CUDA error of the launch (0 on success).
extern "C" int mmk_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int is_bf16, int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    void* stream) {
  if (D < 1 || D > 256 || (is_bf16 && D % 8 != 0) || B < 0 || S < 0 ||
      H < 0 || static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || H == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.sq = {q_sb, q_ss, q_sh};
  a.sk = {k_sb, k_ss, k_sh};
  a.sv = {v_sb, v_ss, v_sh};
  a.causal = causal;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D <= 64) return launch_hopper<64>(a, s);
    if (D <= 128) return launch_hopper<128>(a, s);
    return launch_bf16<256>(a, s);
  }
  if (D <= 32) return launch_f32<32>(a, s);
  if (D <= 64) return launch_f32<64>(a, s);
  if (D <= 128) return launch_f32<128>(a, s);
  return launch_f32<256>(a, s);
}

// Dynamic shared memory a block of the Hopper kernel takes at head dim D
// (bf16, D <= 128), 0 for a D the Hopper route does not take; for reports.
extern "C" int mmk_flash_attention_fwd_hopper_smem(int D) {
  if (D < 1 || D > 128) return 0;
  return static_cast<int>(D <= 64 ? HopperFwdCfg<64>::kSmem
                                  : HopperFwdCfg<128>::kSmem);
}
