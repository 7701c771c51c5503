"""What bounds the Hopper flash-attention kernels: each timed with one part
left out.

Builds patched copies of `mmlspark_tpu_torch/csrc/flash_attention_fwd.cu`
(B4) and `flash_attention_bwd.cu` (B5 and B6) — the package's own sources and
libraries are never touched — each with one part of the kernel's work
removed (the exponentials, a product, the output stores, ...), and
times every copy with CUDA events at the main paths' shapes, in
alternating rounds.  A part whose removal leaves the time unchanged does
not bound the kernel.  The copies compute wrong results on purpose; only
their times are read.  Needs a CUDA card and nvcc:

    python3 attention_ablation.py

Prints one line per (variant, shape, round) and the card's name and
power limit.  The builds go to `mmlspark_tpu_torch/csrc/build/ablation/`.
"""
from __future__ import annotations

import ctypes
import math
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FWD, BWD = "flash_attention_fwd.cu", "flash_attention_bwd.cu"
VIT = ((64, 196, 12, 64), False)     # a ViT-B/16 chunk layer
TRAIN = ((16, 1024, 12, 64), True)   # the GPT-small train layer
PREFILL = ((8, 1000, 12, 64), True)  # the GPT-small prefill layer
SKIP = "if (a.B < 0) "  # never true: the guarded call is left out

# name -> (source, [(text, replacement)], shapes)
VARIANTS = {
    "fwd": (FWD, [], [VIT, PREFILL, TRAIN]),
    "fwd_no_exp": (FWD, [(
        "hopper::exp2_ftz(fmaf(s[hf][i], a.scale_log2, -m_use[hi]))",
        "fmaf(s[hf][i], a.scale_log2, -m_use[hi])")], [VIT, TRAIN]),
    "fwd_no_qk": (FWD, [("hopper::wgmma_ss_n64(\n              s[hf],",
                         SKIP + "hopper::wgmma_ss_n64(\n              s[hf],")],
                  [VIT, TRAIN]),
    "fwd_no_pv": (FWD, [("hopper::wgmma_rs_n64_mnmajor(",
                         SKIP + "hopper::wgmma_rs_n64_mnmajor(")],
                  [VIT, TRAIN]),
    "fwd_no_o_store": (FWD, [("if (row < a.S && col < a.D) {",
                              "if (row < a.S && col < a.D && a.B < 0) {")],
                       [VIT, TRAIN]),
    "fwd_one_half": (FWD, [(
        "static constexpr int kHalves = DP <= 64 ? 2 : 1;",
        "static constexpr int kHalves = 1;")], [VIT, PREFILL, TRAIN]),
    "dkdv": (BWD, [], [TRAIN]),
    "dkdv_no_exp": (BWD, [(
        "hopper::exp2_ftz(fmaf(s[i], a.scale_log2, -ls[qi]))",
        "fmaf(s[i], a.scale_log2, -ls[qi])")], [TRAIN]),
    "dkdv_no_scores": (BWD, [
        ("hopper::wgmma_ss_n64(s,", SKIP + "hopper::wgmma_ss_n64(s,"),
        ("hopper::wgmma_ss_n64(dp,", SKIP + "hopper::wgmma_ss_n64(dp,")],
        [TRAIN]),
    "dkdv_no_dvdk": (BWD, [("hopper::wgmma_rs_n64_mnmajor(",
                            SKIP + "hopper::wgmma_rs_n64_mnmajor(")],
                     [TRAIN]),
    "dkdv_no_lse_loads": (BWD, [
        ("in ? a.lse[row_base + m0 + i] * kLog2e : 0.f", "0.f"),
        ("in ? a.delta[row_base + m0 + i] : 0.f", "0.f")], [TRAIN]),
    "dkdv_no_store": (BWD, [("if (row < a.S && c0 + col < a.D) {",
                             "if (row < a.S && c0 + col < a.D && a.B < 0) {")],
                      [TRAIN]),
    "dq": (BWD, [], [TRAIN]),
    "dq_no_exp": (BWD, [(
        "hopper::exp2_ftz(\n                           "
        "fmaf(s[i], a.scale_log2, -lse2[hf][hi]))",
        "fmaf(s[i], a.scale_log2, -lse2[hf][hi])")],
        [TRAIN]),
    "dq_no_scores": (BWD, [
        ("hopper::wgmma_ss_n64(\n              s,",
         SKIP + "hopper::wgmma_ss_n64(\n              s,"),
        ("hopper::wgmma_ss_n64(\n              dp,",
         SKIP + "hopper::wgmma_ss_n64(\n              dp,")], [TRAIN]),
    "dq_no_dq": (BWD, [("hopper::wgmma_rs_n64_mnmajor(\n                dq",
                        SKIP + "hopper::wgmma_rs_n64_mnmajor(\n"
                        "                dq")], [TRAIN]),
    "dq_no_store": (BWD, [("if (row < a.S && col < a.D) {",
                           "if (row < a.S && col < a.D && a.B < 0) {")],
                    [TRAIN]),
    "dq_one_half": (BWD, [(
        "static constexpr int kHalves = DP <= 64 ? 2 : 1;   // 64-row",
        "static constexpr int kHalves = 1;   // 64-row")], [TRAIN]),
    # half 1's score products issued while half 0's dQ product runs
    "dq_overlap_halves": (BWD, [(
        """        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) hopper::fence_regs(dq[hf][j]);
        hopper::fence_regs(da);
      }
      hopper::mbar_arrive(&empty[stage]);""",
        """        hopper::wgmma_commit();
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) hopper::fence_regs(dq[hf][j]);
        hopper::fence_regs(da);
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < MH; ++hf) {
#pragma unroll
        for (int j = 0; j < C::kSub; ++j) hopper::fence_regs(dq[hf][j]);
      }
      hopper::mbar_arrive(&empty[stage]);""")], [TRAIN]),
}


def build_all():
    """name -> loaded library of each variant, built all together."""
    from mmlspark_tpu_torch.ops import _ablation, _build

    texts = {}
    for name, (src, patches, _shapes) in VARIANTS.items():
        text = open(os.path.join(_build.CSRC, src), encoding="utf-8").read()
        texts[name] = _ablation.patched(text, patches, name)
    return _ablation.build_variants(texts, "attention", ("-I", _build.CSRC))


def launcher(lib, name, src, q, k, v, do, lse, delta, causal):
    """A call of the variant's C entry on these inputs (outputs made once)."""
    import torch

    b, s, h, d = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    if src == FWD:
        out = torch.empty((b, s, h, d), dtype=torch.float32, device="cuda")
        lse_out = torch.empty((b * h, s), dtype=torch.float32, device="cuda")
        fn = lib.mmk_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_out.data_ptr(), 1, b, s, h, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], int(causal),
                1.0 / math.sqrt(d), stream)
    elif name.startswith("dq"):
        dq = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        fn = lib.mmk_flash_attention_bwd_dq
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *do.stride()[:3])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), 1, b, s, h,
                d, strides, int(causal), 1.0 / math.sqrt(d), stream)
    else:
        dk = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        dv = torch.empty_like(dk)
        fn = lib.mmk_flash_attention_bwd_dkdv
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *do.stride()[:3])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                1, b, s, h, d, strides, int(causal), 1.0 / math.sqrt(d),
                stream)
    fn.restype = ctypes.c_int

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def cuda_ms(fn, iters: int = 30) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_ablation: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.ops import _ablation
    from mmlspark_tpu_torch.ops import attention_kernels as A

    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, causal in (VIT, PREFILL, TRAIN):
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        b, s, h, _d = shape
        out, lse = A.flash_attention_fwd(q, k, v, causal)
        delta = torch.einsum("bshd,bshd->bhs", do.float(), out).reshape(
            b * h, s).contiguous()
        calls = {name: launcher(libs[name], name, src, q, k, v, do, lse,
                                delta, causal)
                 for name, (src, _p, shapes) in VARIANTS.items()
                 if (shape, causal) in shapes}
        for rnd in range(2):
            for name, call in calls.items():
                print(f"[ablation] {name} {list(shape)} causal={causal} "
                      f"round {rnd}: {cuda_ms(call):.4f} ms", flush=True)
    print(_ablation.card())


if __name__ == "__main__":
    main()
