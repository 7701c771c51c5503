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
// the TPU kernels the softmax runs across pages; unlike them, rows past
// pos[b] are skipped, never weighted by 0, and pages past the last live
// one are never read, so nothing in them (the write-trash page 0
// included) can reach the output.
//
// What bounds it on an H100: bytes.  Each live K/V row is read once per
// (slot, K/V head) and takes 2*G operations per element of K and of V,
// well below the ~20 f32 operations per byte at which the card's FMA
// rate would be the limit, so plain f32 FMAs suffice: no tensor cores.
// At a serving tick the live rows are a few MB, microseconds at the HBM
// rate, so what a launch costs is a chain of latencies (pos, then the
// page table, then the rows), and the design keeps as many rows in
// flight at once as it can.
//
// B7: flash-decoding, two kernels a call (split, then merge).
//   * paged_split_kernel: a grid of (slot, K/V head[, group of up to 8 of
//     its query heads]) x chunk, a chunk being `split_pages` whole pages
//     (64 rows at the serving page size; the caller fixes it from the
//     page size alone).  The grid comes from the static shapes (MP and
//     the page size), never from pos, so the host never reads pos.  A
//     block whose chunk starts past pos[b] writes an empty partial (m =
//     -inf, l = 0, acc = 0) and exits.  Otherwise each row of the chunk
//     goes to a group of lanes of one warp (a 64-wide bf16 row is 128
//     bytes: 8 lanes of one 16-byte load each, 4 rows a warp
//     instruction); every lane issues its loads of several rows' K and V
//     before it computes, reading each row's physical page from the page
//     table in device memory.  Each lane group keeps its own running
//     (m, l, acc) in registers for the block's query heads; the groups of
//     a warp merge through shuffles, the 4 warps once through shared
//     memory, and the block writes its f32 partial: acc [B, H, n_split,
//     D], m and l [B, H, n_split] (unnormalised, relative to m).
//   * paged_merge_kernel: one warp per (slot, query head) combines the
//     partials in split order (a fixed order: deterministic), skips the
//     empty ones (no exp(-inf - (-inf))), and divides by max(l, 1e-20).
//   The split kernel is templated on the pool type; an int8 instantiation
//   (B8) adds the per-row scales to its loads.
//
// B8 (int8 pools), the first design, kept until it moves to the split
// kernel: one block of 128 threads per (slot, K/V head), serving that
// head's G query heads, walks the slot's live rows in tiles of up to 64
// rows that never cross a page (the host picks the tile so that shared
// memory fits); each tile's physical page is read from the page table in
// device memory, and its K and V rows and their scales are copied into
// shared memory with cp.async, the next tile's copy in flight while the
// current one is computed.  Per tile: the four warps take the rows in
// turn, lanes over d, and reduce each row's dot products with warp
// shuffles; one warp per query head then updates the running max and
// normaliser and turns the scores into probabilities; last, each thread
// owns (head, d) entries of the f32 accumulator (kept in shared memory)
// and adds the tile's P.V.

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

// ---- B7: split and merge -------------------------------------------------

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;

struct SplitArgs {
  const void* q;       // [B, H, D] view, unit d stride
  const void* k;       // [NP, page, Hkv, D] contiguous
  const void* v;
  const int* table;    // [B, MP]
  const int* pos;      // [B]
  float* ws_acc;       // [B, H, n_split, D] partials
  float* ws_m;         // [B, H, n_split]
  float* ws_l;         // [B, H, n_split]
  float* out;          // [B, H, D] contiguous
  int B, H, Hkv, D, page, MP;
  int split_pages;     // pages a chunk
  int n_split;         // chunks a slot: ceil(MP / split_pages)
  int n_hg;            // query-head groups a K/V head
  long long q_sb, q_sh;
  int vec;             // a pool row is whole 16-byte vectors
  float scale;
};

// x[0 .. 16 / sizeof(T)) = f32(row[d0 ..]), zeros at and past D; `vec`:
// one 16-byte load (the row is whole 16-byte vectors, so a vector that
// starts below D ends at or below it).
__device__ __forceinline__ void load16(float* x, const float* row, int d0,
                                       int D, bool vec) {
  if (vec) {
    const float4 f = d0 < D ? *reinterpret_cast<const float4*>(row + d0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = d0 + u < D ? row[d0 + u] : 0.f;
  }
}

__device__ __forceinline__ void load16(float* x, const __nv_bfloat16* row,
                                       int d0, int D, bool vec) {
  if (vec) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (d0 < D) raw = *reinterpret_cast<const uint4*>(row + d0);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(p[u]);
      x[2 * u] = f.x;
      x[2 * u + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = d0 + u < D ? __bfloat162float(row[d0 + u]) : 0.f;
    }
  }
}

// (m, l, acc) <- the merge of two partials over disjoint rows, each
// relative to its own m; an empty partial has m = -inf and l = acc = 0.
template <int E>
__device__ __forceinline__ void merge_into(float& m, float& l, float (&acc)[E],
                                           float m2, float l2,
                                           const float (&acc2)[E]) {
  const float mx = fmaxf(m, m2);
  const float mu = mx == -INFINITY ? 0.f : mx;
  const float c1 = expf(m - mu), c2 = expf(m2 - mu);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * c1 + acc2[e] * c2;
  m = mx;
}

// One chunk of one slot for GB query heads of one K/V head.  T: the pool
// (and q) type.
template <typename T, int DP, int GB>
__global__ void __launch_bounds__(kSplitThreads)
    paged_split_kernel(const SplitArgs a) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // values a load
  constexpr int LPR = DP / VEC < 32 ? DP / VEC : 32;      // lanes a row
  constexpr int E = DP / LPR;                             // values a lane
  constexpr int NV = E / VEC;                             // loads a row
  constexpr int RPW = 32 / LPR;                           // rows a warp
  constexpr int STEP = kSplitWarps * RPW;                 // rows a block
  constexpr int U = GB <= 2 ? 4 : 2;  // block steps whose loads fly together
  __shared__ float sh_acc[kSplitWarps][GB][DP];
  __shared__ float sh_m[kSplitWarps][GB], sh_l[kSplitWarps][GB];

  const int G = a.H / a.Hkv;
  const int b = blockIdx.x / (a.Hkv * a.n_hg);
  const int hk = (blockIdx.x / a.n_hg) % a.Hkv;
  const int g0 = (blockIdx.x % a.n_hg) * GB;  // the group's first head in hk
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / LPR, li = lane % LPR;
  const int D = a.D;
  const bool vec = a.vec != 0;
  const int chunk = a.split_pages * a.page;  // rows a chunk
  // partial of head g of the group: (b, hk * G + g0 + g, split)
  const size_t part0 =
      (static_cast<size_t>(b) * a.H + hk * G + g0) * a.n_split + split;

  const int p = a.pos[b];
  const int live = p < 0 ? 0 : min(p, a.MP * a.page - 1) + 1;
  const int n = min(live - split * chunk, chunk);  // live rows of the chunk
  if (n <= 0) {
    for (int i = tid; i < GB * D; i += kSplitThreads) {
      const int g = i / D, d = i % D;
      if (g0 + g >= G) continue;
      const size_t pi = part0 + static_cast<size_t>(g) * a.n_split;
      a.ws_acc[pi * D + d] = 0.f;
      if (d == 0) {
        a.ws_m[pi] = -INFINITY;
        a.ws_l[pi] = 0.f;
      }
    }
    return;
  }

  // q for the group's heads, this lane's values: load v of a row covers
  // d = (v * LPR + li) * VEC .. + VEC - 1 (q's own strides: scalar loads)
  float qr[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const bool head = g0 + g < G;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb +
                  static_cast<long long>(hk * G + (head ? g0 + g : 0)) * a.q_sh;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      load16(&qr[g][v * VEC], qp, (v * LPR + li) * VEC, head ? D : 0, false);
    }
  }

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const int* pages = a.table + static_cast<size_t>(b) * a.MP +
                     static_cast<size_t>(split) * a.split_pages;
  for (int base = 0; base < n; base += U * STEP) {
    // every load of U block steps first, then the arithmetic
    float kr[U][E], vr[U][E];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * STEP + warp * RPW + rg;  // row of the chunk
      ok[u] = r < n;
      const T* kp = kg;
      const T* vp = vg;
      if (ok[u]) {
        const size_t prow =
            (static_cast<size_t>(pages[r / a.page]) * a.page + r % a.page) *
                a.Hkv + hk;
        kp += prow * D;
        vp += prow * D;
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d0 = (v * LPR + li) * VEC;
        load16(&kr[u][v * VEC], kp, d0, ok[u] ? D : 0, vec);
        load16(&vr[u][v * VEC], vp, d0, ok[u] ? D : 0, vec);
      }
    }
    // scores: each lane's values, then the row's lane group
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[g][e], kr[u][e], x);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
        }
        s[u][g] = ok[u] ? x * a.scale : -INFINITY;
      }
    }
    // the online softmax over this lane group's U rows
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float c = expf(m[g] - mu);
      l[g] *= c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= c;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = expf(s[u][g] - mu);
        l[g] += pu;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pu, vr[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // the warp's lane groups, then the block's warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float acc2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge_into(m[g], l[g], acc[g], m2, l2, acc2);
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          sh_acc[warp][g][(v * LPR + li) * VEC + u] = acc[g][v * VEC + u];
        }
      }
      if (li == 0) {
        sh_m[warp][g] = m[g];
        sh_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < GB * D; i += kSplitThreads) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, sh_m[w][g]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float c = expf(sh_m[w][g] - mx);  // mx is finite: n > 0
      ls = fmaf(sh_l[w][g], c, ls);
      as = fmaf(sh_acc[w][g][d], c, as);
    }
    const size_t pi = part0 + static_cast<size_t>(g) * a.n_split;
    a.ws_acc[pi * D + d] = as;
    if (d == 0) {
      a.ws_m[pi] = mx;
      a.ws_l[pi] = ls;
    }
  }
}

// One warp per (slot, query head): the partials merged in split order.
__global__ void __launch_bounds__(128) paged_merge_kernel(const SplitArgs a) {
  const int pair = blockIdx.x * 4 + (threadIdx.x >> 5);  // b * H + h
  const int lane = threadIdx.x & 31;
  if (pair >= a.B * a.H) return;
  const int D = a.D;
  const float* pm = a.ws_m + static_cast<size_t>(pair) * a.n_split;
  const float* pl = a.ws_l + static_cast<size_t>(pair) * a.n_split;
  const float* pa = a.ws_acc + static_cast<size_t>(pair) * a.n_split * D;
  float mx = -INFINITY;
  for (int sp = 0; sp < a.n_split; ++sp) mx = fmaxf(mx, pm[sp]);
  float ls = 0.f, o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
  for (int sp = 0; sp < a.n_split; ++sp) {
    const float ms = pm[sp];
    if (ms == -INFINITY) continue;  // an empty chunk
    const float c = expf(ms - mx);
    ls = fmaf(pl[sp], c, ls);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[i] = fmaf(pa[static_cast<size_t>(sp) * D + d], c, o[i]);
    }
  }
  const float inv = 1.f / fmaxf(ls, 1e-20f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = lane + 32 * i;
    if (d < D) a.out[static_cast<size_t>(pair) * D + d] = o[i] * inv;
  }
}

template <typename T, int DP, int GB>
int launch_split(SplitArgs a, cudaStream_t stream) {
  a.n_hg = (a.H / a.Hkv + GB - 1) / GB;
  const dim3 grid(static_cast<unsigned>(a.B * a.Hkv * a.n_hg),
                  static_cast<unsigned>(a.n_split));
  paged_split_kernel<T, DP, GB><<<grid, kSplitThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_merge_kernel<<<static_cast<unsigned>((a.B * a.H + 3) / 4), 128, 0,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_split_g(const SplitArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (G <= 1) return launch_split<T, DP, 1>(a, stream);
  if (G <= 2) return launch_split<T, DP, 2>(a, stream);
  if (G <= 4) return launch_split<T, DP, 4>(a, stream);
  return launch_split<T, DP, 8>(a, stream);
}

template <typename T>
int launch_split_d(const SplitArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_split_g<T, 64>(a, stream);
  if (a.D <= 128) return launch_split_g<T, 128>(a, stream);
  return launch_split_g<T, 256>(a, stream);
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

// B7: q and the pools in one type, f32 (is_bf16 = 0) or bf16 (1); bf16
// needs D % 8 == 0.  `workspace` is an f32 buffer of B * H * n_split *
// (D + 2) values, n_split = ceil(MP / split_pages): the partials of
// chunks of `split_pages` pages.  Two launches (split, merge); returns
// the first error.
extern "C" int mmk_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* pos, void* out,
                                   void* workspace, int is_bf16, int B, int H,
                                   int Hkv, int D, int page, int MP,
                                   int split_pages, long long q_sb,
                                   long long q_sh, float scale,
                                   void* stream) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > 256 ||
      (is_bf16 && D % 8 != 0) || page < 1 || MP < 1 || split_pages < 1 ||
      static_cast<long long>(MP) * page > 0x7fffffffLL ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SplitArgs a;
  a.n_split = (MP + split_pages - 1) / split_pages;
  if (a.n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  const size_t parts = static_cast<size_t>(B) * H * a.n_split;
  a.ws_acc = static_cast<float*>(workspace);
  a.ws_m = a.ws_acc + parts * D;
  a.ws_l = a.ws_m + parts;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.page = page;
  a.MP = MP;
  a.split_pages = split_pages;
  a.n_hg = 0;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.vec = (static_cast<size_t>(D) * (is_bf16 ? 2 : 4)) % 16 == 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_split_d<__nv_bfloat16>(a, s);
  return launch_split_d<float>(a, s);
}

// B7's earlier tiled design, the B8 kernel at the pools' own type
// (arguments as mmk_paged_attention's without workspace and
// split_pages): kept only to be timed beside the split kernels on the
// same inputs (chip_smoke.py); no wrapper calls it.  It goes when B8
// moves to the split kernel.
extern "C" int mmk_paged_attention_tiled(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* table, const void* pos,
                                         void* out, int is_bf16, int B, int H,
                                         int Hkv, int D, int page, int MP,
                                         long long q_sb, long long q_sh,
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
