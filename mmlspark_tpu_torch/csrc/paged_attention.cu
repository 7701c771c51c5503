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
// B7 and B8 are one design, flash-decoding: two kernels a call (split,
// then merge).
//   * paged_split_kernel<TQ, T, DP, GB>: q of type TQ (f32 or bf16) over
//     pools of type T (B7: T = TQ; B8: int8 with per-row f32 scales).  A
//     grid of (slot, K/V head[, group of up to 8 of its query heads]) x
//     chunk, a chunk being `split_pages` whole pages (the caller fixes it
//     from the page size and the pool type: 64 rows, see
//     ops/paged_attention.py::split_pages).  The grid comes from the
//     static shapes (MP and the page size), never from pos, so the host
//     never reads pos.  A block whose chunk starts past pos[b] writes an
//     empty partial (m = -inf, l = 0, acc = 0) and exits.  Otherwise each
//     row of the chunk goes to a group of lanes of one warp, each lane
//     one 16-byte load of K and one of V a row (a 64-wide bf16 row is 8
//     lanes, 4 rows a warp instruction; a 64-wide int8 row 4 lanes, 8
//     rows); every lane issues the loads of several rows (and, for B8,
//     their two scales) before it computes, keeping them as raw words
//     until the arithmetic needs them, and reads each row's physical page
//     from the page table in device memory.  B8 applies the scales where
//     the TPU kernel does: the K scale after the lane group's reduction
//     of q.kq, the V scale on p before the V update, never on the
//     normaliser l.  Each lane group keeps its own running (m, l, acc) in
//     registers for the block's query heads; the groups of a warp merge
//     through shuffles, the 4 warps once through shared memory, and the
//     block writes its f32 partial: acc [B, H, n_split, D], m and l [B,
//     H, n_split] (unnormalised, relative to m).
//   * paged_merge_kernel (B7 and B8): one warp per (slot, query head)
//     combines the partials in split order (a fixed order:
//     deterministic), skips the empty ones (no exp(-inf - (-inf))), and
//     divides by max(l, 1e-20).
//   Registers: with 16-byte int8 loads a lane holds 16 values of a row,
//   so q and the accumulators of GB query heads take 32 * GB registers;
//   an int8 block of more than 2 query heads (GQA) loads 8 bytes a lane
//   instead (8 values, as bf16), so that nothing spills.  A row that is
//   not whole load vectors (D * sizeof(T) not a multiple of the load)
//   is read in 4-byte words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;

struct SplitArgs {
  const void* q;       // [B, H, D] view, unit d stride
  const void* k;       // [NP, page, Hkv, D] contiguous
  const void* v;
  const float* ks;     // [NP, page, Hkv] (B8), else null
  const float* vs;
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
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// w[0 .. LB / 4) = the LB bytes of `row` from element d0 on, as raw
// words; zeros at and past D.  `vec`: one LB-byte load (the row is whole
// LB-byte vectors, so a vector that starts below D ends at or below it);
// else 4-byte words (a word holds whole values: D is a multiple of
// 4 / sizeof(T) wherever this path runs).
template <typename T, int LB>
__device__ __forceinline__ void load_raw(uint32_t (&w)[LB / 4], const T* row,
                                         int d0, int D, bool vec) {
  constexpr int VPW = 4 / static_cast<int>(sizeof(T));  // values a word
  if (vec) {
    if (d0 < D) {
      if constexpr (LB == 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(row + d0);
        w[0] = x.x;
        w[1] = x.y;
        w[2] = x.z;
        w[3] = x.w;
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(row + d0);
        w[0] = x.x;
        w[1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < LB / 4; ++i) w[i] = 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < LB / 4; ++i) {
      w[i] = d0 + i * VPW < D
                 ? *reinterpret_cast<const uint32_t*>(row + d0 + i * VPW)
                 : 0u;
    }
  }
}

// x[0 .. 4 / sizeof(T)) = f32 of the values in word w, exactly.
template <typename T>
__device__ __forceinline__ void unpack_word(float* x, uint32_t w) {
  if constexpr (std::is_same<T, float>::value) {
    x[0] = __uint_as_float(w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    // int8: the biased byte u = b + 128 under the exponent of 2^23 is
    // 2^23 + u exactly; less 2^23 + 128 it is b (full-rate ALU ops in
    // place of the quarter-rate integer-to-float conversion)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t u = ((w >> (8 * j)) & 0xffu) ^ 0x80u;
      x[j] = __uint_as_float(0x4b000000u | u) - 8388736.f;
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void unpack(float* x, const uint32_t (&w)[W]) {
  constexpr int VPW = 4 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < W; ++i) unpack_word<T>(x + i * VPW, w[i]);
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

// One chunk of one slot for GB query heads of one K/V head.  TQ: q's
// type; T: the pools' (B8: int8, with the scales).
template <typename TQ, typename T, int DP, int GB>
__global__ void __launch_bounds__(kSplitThreads)
    paged_split_kernel(const SplitArgs a) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int LB = kInt8 && GB > 2 ? 8 : 16;            // bytes a load
  constexpr int W = LB / 4;                               // words a load
  constexpr int VEC = LB / static_cast<int>(sizeof(T));   // values a load
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
  const bool vec = D * static_cast<int>(sizeof(T)) % LB == 0;
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
    const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb +
                   static_cast<long long>(hk * G + (head ? g0 + g : 0)) * a.q_sh;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int d0 = (v * LPR + li) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        qr[g][v * VEC + i] = head && d0 + i < D ? to_f32(qp[d0 + i]) : 0.f;
      }
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
    // every load of U block steps first (raw words), then the arithmetic
    uint32_t kw[U][NV][W], vw[U][NV][W];
    float ksr[U], vsr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * STEP + warp * RPW + rg;  // row of the chunk
      ok[u] = r < n;
      size_t prow = 0;  // the row's (page row, hk) index
      if (ok[u]) {
        prow = (static_cast<size_t>(pages[r / a.page]) * a.page + r % a.page) *
                   a.Hkv + hk;
      }
      const T* kp = kg + prow * D;
      const T* vp = vg + prow * D;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d0 = (v * LPR + li) * VEC;
        load_raw<T, LB>(kw[u][v], kp, d0, ok[u] ? D : 0, vec);
        load_raw<T, LB>(vw[u][v], vp, d0, ok[u] ? D : 0, vec);
      }
      if constexpr (kInt8) {
        ksr[u] = ok[u] ? a.ks[prow] : 0.f;
        vsr[u] = ok[u] ? a.vs[prow] : 0.f;
      }
    }
    // scores: each lane's values, then the row's lane group (B8: then
    // the row's K scale)
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack<T>(&kf[v * VEC], kw[u][v]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[g][e], kf[e], x);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
        }
        if constexpr (kInt8) x *= ksr[u];
        s[u][g] = ok[u] ? x * a.scale : -INFINITY;
      }
    }
    // the online softmax over this lane group's U rows: rescale, then
    // each row's p (B8: times its V scale) into the V sum
    float mu[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      mu[g] = mx == -INFINITY ? 0.f : mx;
      const float c = expf(m[g] - mu[g]);
      l[g] *= c;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= c;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack<T>(&vf[v * VEC], vw[u][v]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float pu = expf(s[u][g] - mu[g]);
        l[g] += pu;
        if constexpr (kInt8) pu *= vsr[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pu, vf[e], acc[g][e]);
      }
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

template <typename TQ, typename T, int DP, int GB>
int launch_split(SplitArgs a, cudaStream_t stream) {
  a.n_hg = (a.H / a.Hkv + GB - 1) / GB;
  const dim3 grid(static_cast<unsigned>(a.B * a.Hkv * a.n_hg),
                  static_cast<unsigned>(a.n_split));
  paged_split_kernel<TQ, T, DP, GB><<<grid, kSplitThreads, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_merge_kernel<<<static_cast<unsigned>((a.B * a.H + 3) / 4), 128, 0,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename T, int DP>
int launch_split_g(const SplitArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (G <= 1) return launch_split<TQ, T, DP, 1>(a, stream);
  if (G <= 2) return launch_split<TQ, T, DP, 2>(a, stream);
  if (G <= 4) return launch_split<TQ, T, DP, 4>(a, stream);
  return launch_split<TQ, T, DP, 8>(a, stream);
}

template <typename TQ, typename T>
int launch_split_d(const SplitArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_split_g<TQ, T, 64>(a, stream);
  if (a.D <= 128) return launch_split_g<TQ, T, 128>(a, stream);
  return launch_split_g<TQ, T, 256>(a, stream);
}

// The checks and the arguments both C entries share; returns a CUDA
// error, or 0 with `a` filled (and then nothing to launch if B == 0).
int split_args(SplitArgs& a, const void* q, const void* k, const void* v,
               const void* ks, const void* vs, const void* table,
               const void* pos, void* out, void* workspace, int B, int H,
               int Hkv, int D, int page, int MP, int split_pages,
               long long q_sb, long long q_sh, float scale) {
  if (B < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > 256 ||
      page < 1 || MP < 1 || split_pages < 1 ||
      static_cast<long long>(MP) * page > 0x7fffffffLL ||
      static_cast<long long>(B) * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_split = (MP + split_pages - 1) / split_pages;
  if (a.n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
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
  a.scale = scale;
  return 0;
}

}  // namespace

// Plain C entries, loaded with ctypes.  q is a device pointer to a
// [B, H, D] view with unit d stride and element strides q_sb, q_sh; the
// pools are contiguous [NP, page, Hkv, D] (16-byte-aligned bases), the
// B8 scales contiguous f32 [NP, page, Hkv]; table is int32 [B, MP] with
// every entry a page of the pool, pos int32 [B]; out is a contiguous f32
// [B, H, D] buffer.  `workspace` is an f32 buffer of B * H * n_split *
// (D + 2) values, n_split = ceil(MP / split_pages): the partials of
// chunks of `split_pages` pages.  `scale` is 1/sqrt(D).  Two launches
// (split, merge) on `stream`, no synchronisation; each entry returns the
// first CUDA error (0 on success).

// B7: q and the pools in one type, f32 (is_bf16 = 0) or bf16 (1); bf16
// needs D % 8 == 0.
extern "C" int mmk_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* pos, void* out,
                                   void* workspace, int is_bf16, int B, int H,
                                   int Hkv, int D, int page, int MP,
                                   int split_pages, long long q_sb,
                                   long long q_sh, float scale,
                                   void* stream) {
  if (is_bf16 && D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a;
  const int err = split_args(a, q, k_pool, v_pool, nullptr, nullptr, table,
                             pos, out, workspace, B, H, Hkv, D, page, MP,
                             split_pages, q_sb, q_sh, scale);
  if (err != 0 || B == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_split_d<__nv_bfloat16, __nv_bfloat16>(a, s);
  return launch_split_d<float, float>(a, s);
}

// B8: int8 pools with f32 scales; q f32 (q_is_bf16 = 0) or bf16 (1); D
// a multiple of 4.
extern "C" int mmk_paged_attention_int8(
    const void* q, const void* kq_pool, const void* ks_pool,
    const void* vq_pool, const void* vs_pool, const void* table,
    const void* pos, void* out, void* workspace, int q_is_bf16, int B, int H,
    int Hkv, int D, int page, int MP, int split_pages, long long q_sb,
    long long q_sh, float scale, void* stream) {
  if (D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a;
  const int err = split_args(a, q, kq_pool, vq_pool, ks_pool, vs_pool, table,
                             pos, out, workspace, B, H, Hkv, D, page, MP,
                             split_pages, q_sb, q_sh, scale);
  if (err != 0 || B == 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) return launch_split_d<__nv_bfloat16, int8_t>(a, s);
  return launch_split_d<float, int8_t>(a, s);
}
