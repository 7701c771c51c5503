// K1: one pass of per-example AdaGrad SGD over hashed sparse rows, on the
// card.  The port's own kernel: it replaces no Pallas kernel.  The JAX
// package runs the pass as a `lax.scan` under `jit`
// (mmlspark_tpu/online/learners.py:36 `_train_pass_impl`,
// mmlspark_tpu/online/contextual_bandit.py:44 `_cb_train_pass`); in eager
// PyTorch the same scan is a Python loop of about a dozen launches an
// example, paced by the host.  This kernel walks the examples in order in
// one launch a pass.
//
// Computes, for each example e in order (slots a of its row, index i_a,
// value v_a; zero-valued slots are exact no-ops and are skipped):
//
//   pred  = sum_a w[i_a] * v_a
//   g     = -y sigmoid(-y pred)          loss = softplus(-y pred)  (logistic)
//         = pred - y                     loss = 0.5 (pred - y)^2   (squared)
//         = iw (pred - c)                loss = iw 0.5 (pred - c)^2 (bandit)
//   gi_a  = g v_a
//   g2[i_a] += gi_a^2                    every slot, before any slot reads g2
//   d_a   = sqrt(g2[i_a]) + 1e-8
//   w[i_a] += -lr (gi_a / d_a + l2 w_a + l1 sign(w_a))
//                                        w_a read before any slot writes
//   loss_out[e] = loss * valid,  valid_out[e] = (row has a nonzero value)
//
// (the bandit passes l1 = l2 = 0 and writes its loss unmasked), which is
// the reference's arithmetic, duplicates included: an index that appears
// in several slots of a row adds each slot's square to g2 and each slot's
// step to w, in slot order.
//
// Layout.  The wrapper (ops/online_pass.py `plan_rows`) sorts each row's
// slots once per fit, stably by (value == 0, index): the nonzero slots
// come first (`nnz[e]` of them) and the slots of one index sit together,
// in their original order.  `run[e, a]` is the length of the run of equal
// indices that starts at slot a, 0 for a slot inside a run.  The slot that
// starts a run owns its index for the example: it sums the run's squares
// into g2 and its steps into w, in slot order, and writes each once.  No
// two threads write one address, so there are no atomics and two launches
// agree bit for bit.
//
// What bounds it on an H100: the chain of examples.  Example e + 1 may read
// what example e wrote, so the examples run one after another on one warp;
// each costs a dependent read of w and g2 (L1 or L2: the tables are
// 2^bits x 4 bytes each, 1 MiB at 18 bits), a warp reduction, a few
// transcendental operations and the writes.  The bytes (idx, val, y and a
// gather and scatter of w and g2 a slot) would take a few microseconds at
// 3.35 TB/s for a million rows; the chain takes on the order of a
// microsecond an example.  The row data does not depend on the tables, so
// each lane loads the next example's slots while the current one computes.
// Arithmetic is in f32 with rounded intrinsics (no fused multiply-adds), in
// the reference's order of operations, so the kernel differs from the
// plain loop only in the order of pred's sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;                   // slots a lane holds, at most
constexpr int kMaxSlots = kWarp * kMaxPerLane;   // A the kernel takes

enum Loss : int { kSquared = 0, kLogistic = 1, kBandit = 2 };

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// One example's row as the lanes hold it: slot lane + k * 32 in entry k.
template <int PER_LANE>
struct Slots {
  int idx[PER_LANE];
  float val[PER_LANE];
  int run[PER_LANE];
  int nnz;
  float y, wt;
};

template <int PER_LANE>
__device__ __forceinline__ void load_row(Slots<PER_LANE>& s, const int* __restrict__ idx,
                                         const float* __restrict__ val,
                                         const int* __restrict__ run,
                                         const int* __restrict__ nnz,
                                         const float* __restrict__ y,
                                         const float* __restrict__ wt,
                                         long long e, int a_cols, int lane) {
  s.nnz = nnz[e];
  s.y = y[e];
  s.wt = wt != nullptr ? wt[e] : 1.f;
  const long long base = e * a_cols;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int a = lane + k * kWarp;
    if (a < s.nnz) {
      s.idx[k] = idx[base + a];
      s.val[k] = val[base + a];
      s.run[k] = run[base + a];
    } else {
      s.idx[k] = 0;
      s.val[k] = 0.f;
      s.run[k] = 0;
    }
  }
}

// One warp walks all n examples in order.
template <int PER_LANE>
__global__ void __launch_bounds__(kWarp)
online_pass_kernel(float* __restrict__ w, float* __restrict__ g2,
                   const int* __restrict__ idx, const float* __restrict__ val,
                   const int* __restrict__ run, const int* __restrict__ nnz,
                   const float* __restrict__ y, const float* __restrict__ wt,
                   long long n, int a_cols, int loss_kind, float lr, float l1,
                   float l2, float* __restrict__ loss_out,
                   float* __restrict__ valid_out) {
  __shared__ float s_val[kMaxSlots];
  const int lane = threadIdx.x;
  Slots<PER_LANE> cur, nxt;
  if (n > 0) {
    load_row<PER_LANE>(cur, idx, val, run, nnz, y, wt, 0, a_cols, lane);
  }
  for (long long e = 0; e < n; ++e) {
    if (e + 1 < n) {
      load_row<PER_LANE>(nxt, idx, val, run, nnz, y, wt, e + 1, a_cols, lane);
    }
    // every slot reads w (and g2) before any slot of this example writes
    float wv[PER_LANE], gv[PER_LANE];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int a = lane + k * kWarp;
      if (a < cur.nnz) {
        wv[k] = w[cur.idx[k]];
        gv[k] = g2[cur.idx[k]];
        s_val[a] = cur.val[k];
        part = __fadd_rn(part, __fmul_rn(wv[k], cur.val[k]));
      } else {
        wv[k] = 0.f;
        gv[k] = 0.f;
      }
    }
    // pred: a fixed butterfly, the same on every launch
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    }
    const float pred = part;
    float g, ex_loss;
    if (loss_kind == kLogistic) {
      const float z = -cur.y * pred;                    // margin of the loss
      const float sig = 1.f / (1.f + expf(-z));         // sigmoid(-y pred)
      g = -cur.y * sig;
      ex_loss = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));  // softplus(z)
    } else {
      const float r = pred - cur.y;
      g = cur.wt * r;
      ex_loss = __fmul_rn(cur.wt, __fmul_rn(0.5f, __fmul_rn(r, r)));
    }
    __syncwarp();  // s_val complete
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int a = lane + k * kWarp;
      const int len = cur.run[k];
      if (a < cur.nnz && len > 0) {
        float acc2 = gv[k];
        for (int s = a; s < a + len; ++s) {
          const float gi = __fmul_rn(g, s_val[s]);
          acc2 = __fadd_rn(acc2, __fmul_rn(gi, gi));
        }
        const float denom = __fadd_rn(__fsqrt_rn(acc2), 1e-8f);
        const float wi = wv[k];
        const float reg2 = __fmul_rn(l2, wi);
        const float reg1 = __fmul_rn(l1, sign_of(wi));
        float accw = wi;
        for (int s = a; s < a + len; ++s) {
          const float gi = __fmul_rn(g, s_val[s]);
          // the bandit's step is (-lr gi) / d (contextual_bandit.py:54),
          // the learners' -lr (gi / d + l2 w + l1 sign w) (learners.py:62)
          const float step =
              loss_kind == kBandit
                  ? __fdiv_rn(__fmul_rn(-lr, gi), denom)
                  : __fmul_rn(-lr, __fadd_rn(__fadd_rn(__fdiv_rn(gi, denom),
                                                       reg2), reg1));
          accw = __fadd_rn(accw, step);
        }
        g2[cur.idx[k]] = acc2;
        w[cur.idx[k]] = accw;
      }
    }
    if (lane == 0) {
      const float valid = cur.nnz > 0 ? 1.f : 0.f;
      loss_out[e] = loss_kind == kBandit ? ex_loss : ex_loss * valid;
      valid_out[e] = valid;
    }
    // this example's writes are seen by every lane of the next one, and
    // s_val is free again
    __threadfence_block();
    __syncwarp();
    cur = nxt;
  }
}

template <int PER_LANE>
cudaError_t launch(float* w, float* g2, const int* idx, const float* val,
                   const int* run, const int* nnz, const float* y,
                   const float* wt, long long n, int a_cols, int loss_kind,
                   float lr, float l1, float l2, float* loss_out,
                   float* valid_out, cudaStream_t stream) {
  online_pass_kernel<PER_LANE><<<1, kWarp, 0, stream>>>(
      w, g2, idx, val, run, nnz, y, wt, n, a_cols, loss_kind, lr, l1, l2,
      loss_out, valid_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmk_online_max_slots() { return kMaxSlots; }

// One pass over n examples of a_cols slots each (see the layout above).
// wt is null for the learners (weight 1).  Returns a cudaError_t.
extern "C" int mmk_online_pass(void* w, void* g2, const void* idx,
                               const void* val, const void* run,
                               const void* nnz, const void* y, const void* wt,
                               long long n, int a_cols, int loss_kind,
                               float lr, float l1, float l2, void* loss_out,
                               void* valid_out, void* stream) {
  if (n < 0 || a_cols < 1 || a_cols > kMaxSlots || loss_kind < kSquared ||
      loss_kind > kBandit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int per_lane = (a_cols + kWarp - 1) / kWarp;
  auto* fw = static_cast<float*>(w);
  auto* fg = static_cast<float*>(g2);
  auto* ii = static_cast<const int*>(idx);
  auto* vv = static_cast<const float*>(val);
  auto* rr = static_cast<const int*>(run);
  auto* nz = static_cast<const int*>(nnz);
  auto* yy = static_cast<const float*>(y);
  auto* ww = static_cast<const float*>(wt);
  auto* lo = static_cast<float*>(loss_out);
  auto* vo = static_cast<float*>(valid_out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (per_lane <= 1) {
    err = launch<1>(fw, fg, ii, vv, rr, nz, yy, ww, n, a_cols, loss_kind, lr,
                    l1, l2, lo, vo, st);
  } else if (per_lane <= 2) {
    err = launch<2>(fw, fg, ii, vv, rr, nz, yy, ww, n, a_cols, loss_kind, lr,
                    l1, l2, lo, vo, st);
  } else if (per_lane <= 4) {
    err = launch<4>(fw, fg, ii, vv, rr, nz, yy, ww, n, a_cols, loss_kind, lr,
                    l1, l2, lo, vo, st);
  } else {
    err = launch<8>(fw, fg, ii, vv, rr, nz, yy, ww, n, a_cols, loss_kind, lr,
                    l1, l2, lo, vo, st);
  }
  return static_cast<int>(err);
}
