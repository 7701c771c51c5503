// Paged decode attention, one new token per slot: the Hopper port of the
// JAX package's Pallas kernels
// mmlspark_tpu/ops/paged_attention.py::_paged_pallas (B7, pools in the
// model dtype) and ::_paged_pallas_int8 (B8, int8 pools with f32 scales).
//
// For slot b and query head h, served by K/V head hk = h / G with
// G = H / Hkv (jnp.repeat's grouping), over the live rows t = 0..pos[b]
// (row t lives in pool page page_table[b][t / page] at row t % page):
//
//   s[t]    = scale * sum_d f32(q[b][h][d]) * f32(k[pg][r][hk][d])
//             (B8: times ks[pg][r][hk])
//   o[b][h] = sum_t exp(s[t] - m) * f32(v[pg][r][hk])     (B8: * vs[pg][r][hk])
//             / max(sum_t exp(s[t] - m), 1e-20)
//
// in f32 throughout (P is never rounded), output f32 [B, H, D].  As in
// the TPU kernels the online softmax runs across pages; unlike them, rows
// past pos[b] are skipped, never weighted by 0, and pages past the last
// live one are never read, so nothing in them (the write-trash page 0
// included) can reach the output.
//
// What bounds it on an H100: bytes.  Each live K/V row is read once per
// (slot, K/V head) and takes 2*G operations per element of K and of V,
// well below the ~20 f32 operations per byte at which the card's FMA
// rate would be the limit, so plain f32 FMAs suffice: no tensor cores.
//
// Design (a first design: right and simple, not yet fast).  One block of
// 128 threads per (slot, K/V head), serving that head's G query heads, so
// a K/V row shared by G query heads is read once.  The block walks the
// slot's live rows in tiles of up to 64 rows that never cross a page (the
// host picks the tile so that shared memory fits); each tile's physical
// page is read from the page table in device memory, and its K and V rows
// (B8: and their scales) are copied into shared memory with cp.async, the
// next tile's copy in flight while the current one is computed.  Per
// tile: the four warps take the rows in turn, lanes over d, and reduce
// each row's dot products with warp shuffles; one warp per query head
// then updates the running max and normaliser and turns the scores into
// probabilities; last, each thread owns (head, d) entries of the f32
// accumulator (kept in shared memory) and adds the tile's P.V.
// Not yet: splitting a long slot over several blocks (flash-decoding; at
// the serving shape B * Hkv = 96 blocks leave SMs of the 132 idle) and
// wider loads in the compute phase.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // what one block may opt in to on sm_90

struct Args {
  const void* q;      // [B, H, D] view, unit d stride
  const void* k;      // [NP, page, Hkv, D] contiguous
  const void* v;
  const float* ks;    // [NP, page, Hkv] (B8), else null
  const float* vs;
  const int* table;   // [B, MP]
  const int* pos;     // [B]
  float* out;         // [B, H, D] contiguous
  int B, H, Hkv, D, page, MP;
  long long q_sb, q_sh;
  int tile;           // rows per tile, <= min(kMaxTile, page)
  int chunk;          // bytes per cp.async: 16, 8 or 4
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared memory: q and the accumulator
// [G, D] f32, scores [G, tile] f32, the softmax statistics [G] f32 x3,
// then two tile buffers (K, V and, for B8, their scales).
struct Layout {
  size_t q, acc, sc, m, l, corr, buf, kv_bytes, s_bytes, buf_stride, total;
};

__host__ __device__ inline Layout make_layout(int G, int D, int tile,
                                              int item, bool int8) {
  Layout L;
  size_t o = 0;
  L.q = o;
  o = align16(o + static_cast<size_t>(G) * D * 4);
  L.acc = o;
  o = align16(o + static_cast<size_t>(G) * D * 4);
  L.sc = o;
  o = align16(o + static_cast<size_t>(G) * tile * 4);
  L.m = o;
  o = align16(o + static_cast<size_t>(G) * 4);
  L.l = o;
  o = align16(o + static_cast<size_t>(G) * 4);
  L.corr = o;
  o = align16(o + static_cast<size_t>(G) * 4);
  L.kv_bytes = align16(static_cast<size_t>(tile) * D * item);
  L.s_bytes = int8 ? align16(static_cast<size_t>(tile) * 4) : 0;
  L.buf = o;
  L.buf_stride = 2 * L.kv_bytes + 2 * L.s_bytes;
  L.total = o + 2 * L.buf_stride;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void copy_chunk(int chunk, void* dst,
                                           const void* src) {
  if (chunk == 16) {
    cp_async<16>(dst, src);
  } else if (chunk == 8) {
    cp_async<8>(dst, src);
  } else {
    cp_async<4>(dst, src);
  }
}

// Start the copy of `n` rows of one K/V head, from pool row `row0` on,
// into tile buffer `buf` (K, then V, then the B8 scales).
template <typename T, bool kInt8>
__device__ void issue_tile(const Args& a, const Layout& L, unsigned char* buf,
                           size_t row0, int hk, int n) {
  const size_t row_bytes = static_cast<size_t>(a.D) * sizeof(T);
  const int per_row = static_cast<int>(row_bytes / a.chunk);
  const char* kg = static_cast<const char*>(a.k);
  const char* vg = static_cast<const char*>(a.v);
  for (int c = threadIdx.x; c < n * per_row; c += kThreads) {
    const int t = c / per_row;
    const size_t off = static_cast<size_t>(c % per_row) * a.chunk;
    const size_t src = ((row0 + t) * a.Hkv + hk) * row_bytes + off;
    const size_t dst = t * row_bytes + off;
    copy_chunk(a.chunk, buf + dst, kg + src);
    copy_chunk(a.chunk, buf + L.kv_bytes + dst, vg + src);
  }
  if (kInt8) {
    float* ks_s = reinterpret_cast<float*>(buf + 2 * L.kv_bytes);
    float* vs_s = reinterpret_cast<float*>(buf + 2 * L.kv_bytes + L.s_bytes);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const size_t i = (row0 + t) * a.Hkv + hk;
      cp_async<4>(ks_s + t, a.ks + i);
      cp_async<4>(vs_s + t, a.vs + i);
    }
  }
}

template <typename TQ, typename T, bool kInt8>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.Hkv;
  const int hk = blockIdx.x % a.Hkv;
  const int G = a.H / a.Hkv;
  const int D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Layout L = make_layout(G, D, a.tile, sizeof(T), kInt8);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);

  const int p = a.pos[b];
  const int npages = p < 0 ? 0 : min(p / a.page + 1, a.MP);
  // rows of page j that are live: all of a page below the last, and up
  // to pos[b] in the last
  auto live_rows = [&](int j) { return min(a.page, p - j * a.page + 1); };
  auto pool_row = [&](int j, int r) {
    return static_cast<size_t>(a.table[static_cast<size_t>(b) * a.MP + j]) *
               a.page + r;
  };

  // the tile (page j, first row r0) in flight first
  int j = 0, r0 = 0;
  if (npages > 0) {
    issue_tile<T, kInt8>(a, L, smem + L.buf, pool_row(0, 0), hk,
                         min(a.tile, live_rows(0)));
  }
  cp_async_commit();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb +
                   static_cast<long long>(hk * G + g) * a.q_sh + i % D;
    q_s[i] = to_f32(*qp);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  __syncthreads();

  int cur = 0;
  while (j < npages) {
    const int n = min(a.tile, live_rows(j) - r0);
    int jn = j, rn = r0 + a.tile;
    if (rn >= live_rows(j)) {
      jn = j + 1;
      rn = 0;
    }
    if (jn < npages) {
      issue_tile<T, kInt8>(a, L, smem + L.buf + (cur ^ 1) * L.buf_stride,
                           pool_row(jn, rn), hk,
                           min(a.tile, live_rows(jn) - rn));
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    unsigned char* buf = smem + L.buf + cur * L.buf_stride;
    const T* k_t = reinterpret_cast<const T*>(buf);
    const T* v_t = reinterpret_cast<const T*>(buf + L.kv_bytes);
    const float* ks_t = reinterpret_cast<const float*>(buf + 2 * L.kv_bytes);
    const float* vs_t =
        reinterpret_cast<const float*>(buf + 2 * L.kv_bytes + L.s_bytes);

    // scores: warps over the tile's rows, lanes over d
    for (int r = warp; r < n; r += kWarps) {
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) {
          s = fmaf(q_s[g * D + d], to_f32(k_t[r * D + d]), s);
        }
        s = warp_sum(s);
        if (lane == 0) {
          s *= a.scale;
          if (kInt8) s *= ks_t[r];
          sc_s[g * a.tile + r] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, lanes over rows
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sc_s + g * a.tile;
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(sg[r] - m_new);
        sum += e;
        sg[r] = kInt8 ? e * vs_t[r] : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // P.V into the accumulator: each thread owns (head, d) entries
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pg = sc_s + g * a.tile;
      float o = acc_s[i] * corr_s[g];
      for (int r = 0; r < n; ++r) o = fmaf(pg[r], to_f32(v_t[r * D + d]), o);
      acc_s[i] = o;
    }
    __syncthreads();
    j = jn;
    r0 = rn;
    cur ^= 1;
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    a.out[(static_cast<size_t>(b) * a.H + hk * G + g) * D + i % D] =
        acc_s[i] / fmaxf(l_s[g], 1e-20f);
  }
}

// Checks the shapes, picks the tile and the copy width, and launches.
template <typename TQ, typename T, bool kInt8>
int launch(Args a, cudaStream_t stream) {
  if (a.B < 0 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.D < 1 ||
      a.D > 256 || a.page < 1 || a.MP < 1 ||
      static_cast<long long>(a.B) * a.Hkv > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t row_bytes = static_cast<size_t>(a.D) * sizeof(T);
  a.chunk = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
          : row_bytes % 4 == 0 ? 4 : 0;
  if (a.chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0) return 0;
  const int G = a.H / a.Hkv;
  // the largest tile (a power of two, at most 64 rows and one page) whose
  // shared memory fits the default 48 KB; else the largest that fits the
  // opt-in maximum
  const size_t limits[2] = {kDefaultSmem, kMaxSmem};
  int tile = 0;
  size_t smem = 0;
  for (int li = 0; li < 2 && tile == 0; ++li) {
    for (int t = kMaxTile; t >= 1 && tile == 0; t >>= 1) {
      if (t > a.page && t > 1) continue;
      const size_t need =
          make_layout(G, a.D, t, static_cast<int>(sizeof(T)), kInt8).total;
      if (need <= limits[li]) {
        tile = t;
        smem = need;
      }
    }
  }
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.tile = tile;
  auto kernel = paged_decode_kernel<TQ, T, kInt8>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(a.B * a.Hkv), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* table, const void* pos, void* out,
               int B, int H, int Hkv, int D, int page, int MP, long long q_sb,
               long long q_sh, float scale) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.page = page;
  a.MP = MP;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.tile = 0;
  a.chunk = 0;
  a.scale = scale;
  return a;
}

}  // namespace

// Plain C entries, loaded with ctypes.  q is a device pointer to a
// [B, H, D] view with unit d stride and element strides q_sb, q_sh; the
// pools are contiguous [NP, page, Hkv, D] (16-byte-aligned bases), the
// B8 scales contiguous f32 [NP, page, Hkv]; table is int32 [B, MP] with
// every entry a page of the pool, pos int32 [B]; out is a contiguous f32
// [B, H, D] buffer.  `scale` is 1/sqrt(D).  The launch goes on `stream`
// and does not synchronise.  Each returns the CUDA error of the launch
// (0 on success).

// B7: q and the pools in one type, f32 (is_bf16 = 0) or bf16 (1).
extern "C" int mmk_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* pos, void* out, int is_bf16,
                                   int B, int H, int Hkv, int D, int page,
                                   int MP, long long q_sb, long long q_sh,
                                   float scale, void* stream) {
  const Args a = make_args(q, k_pool, v_pool, nullptr, nullptr, table, pos,
                           out, B, H, Hkv, D, page, MP, q_sb, q_sh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16, __nv_bfloat16, false>(a, s);
  return launch<float, float, false>(a, s);
}

// B8: int8 pools with f32 scales; q f32 (q_is_bf16 = 0) or bf16 (1).
extern "C" int mmk_paged_attention_int8(
    const void* q, const void* kq_pool, const void* ks_pool,
    const void* vq_pool, const void* vs_pool, const void* table,
    const void* pos, void* out, int q_is_bf16, int B, int H, int Hkv, int D,
    int page, int MP, long long q_sb, long long q_sh, float scale,
    void* stream) {
  const Args a = make_args(q, kq_pool, vq_pool, ks_pool, vs_pool, table, pos,
                           out, B, H, Hkv, D, page, MP, q_sb, q_sh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) return launch<__nv_bfloat16, int8_t, true>(a, s);
  return launch<float, int8_t, true>(a, s);
}
