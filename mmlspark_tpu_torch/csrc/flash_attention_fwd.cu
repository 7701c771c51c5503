// Flash-attention forward for (B, S, H, D) q/k/v: the Hopper port of the
// JAX package's Pallas kernel
// mmlspark_tpu/ops/attention_kernels.py::_attention_pallas.
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
// What bounds it on an H100: at the main path's shapes (S = 196 or
// 1000, D = 64) bytes — q, k and v read once and the f32 O written once
// take longer at 3.35 TB/s than the 4*S*S*D operations per head take at
// the bf16 tensor-core peak.  Both need every score block to stay on
// chip: the [S, S] scores are never written to device memory.
//
// Design (a first design: right and simple, not yet fast).  One thread
// block per (b*h, 64-query tile).  The Q tile and, in turn, each 64-key
// K/V tile are staged in shared memory with 16-byte loads straight from
// the model's (B, S, H, D) layout through its strides (no transpose or
// pad copies); rows past S and columns past D are zero-filled, so a
// ragged S needs no padding and the causal and bounds masks are the
// only masks.  The online-softmax recurrence (running max, normalizer,
// unnormalized O rescaled per tile) runs in f32 registers, and with the
// causal mask the K tiles wholly above the diagonal are never visited.
//   * bf16: four warps, 16 query rows each.  QK^T and PV are warp-level
//     tensor-core products (mma.sync m16n8k16, bf16 in, f32 accumulate).
//     The score fragment of QK^T is, register for register, the A
//     fragment of PV once rounded to bf16, so P never leaves registers;
//     V's B fragments come from shared memory with ldmatrix.trans.
//   * f32: 256 threads, four per query row, FMAs in f32 (the tolerance
//     of f32 inputs leaves no room for bf16 or TF32 products).  P goes
//     through shared memory.
// Not yet: cp.async/TMA double buffering, wgmma and warp
// specialisation, and splitting long rows across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
    if (D <= 32) return launch_bf16<32>(a, s);
    if (D <= 64) return launch_bf16<64>(a, s);
    if (D <= 128) return launch_bf16<128>(a, s);
    return launch_bf16<256>(a, s);
  }
  if (D <= 32) return launch_f32<32>(a, s);
  if (D <= 64) return launch_f32<64>(a, s);
  if (D <= 128) return launch_f32<128>(a, s);
  return launch_f32<256>(a, s);
}
