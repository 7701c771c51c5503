"""What bounds B1's tile route, and which rows-a-tile rule is fastest.

Builds patched copies of `mmlspark_tpu_torch/csrc/resize_normalize.cu` —
the package's own source and library are never touched — each with one
part of the tile route left out (the width pass, the height taps, the
staging copy, the output stores), and times every copy, queued behind a
spin (the device alone), at the featurizers' three chunk shapes at the
rule's rows a tile.  A part whose removal leaves the time unchanged does
not bound the kernel.  The copies compute wrong results on purpose; only
their times are read.  Then it times the package's kernel at the rows a
tile the rule picks for budgets of 1 to 4 blocks an SM, and the pixel
route, on the same inputs.  Needs a CUDA card and nvcc:

    python3 resample_ablation.py

Prints one line per (shape, round) and the card's name and power limit.
The builds go to `mmlspark_tpu_torch/csrc/build/ablation/`.
"""
from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(64, 256, 256, 3), (64, 224, 224, 3), (64, 320, 240, 3)]
SKIP = "if (a.n_tiles < 0) "  # never true: the guarded work is left out

# name -> [(text, replacement)] of the tile route
VARIANTS = {
    "full": [],
    "no_width": [("for (int u = tid; u < w_out * rg; u += kTileThreads) {",
                  "for (int u = tid; u < 0; u += kTileThreads) {")],
    "no_height_taps": [("      for (int k = 0; k < cnt; ++k) {",
                        "      for (int k = 0; k < 0; ++k) {")],
    "no_staging": [("    cp_async16(dst + head + 16 * i, src + head + 16 * i);",
                    "    " + SKIP + "cp_async16(dst + head + 16 * i, "
                    "src + head + 16 * i);")],
    "no_stores": [("      out4[yr * G4 + g] = make_float4(",
                   "      " + SKIP + "out4[yr * G4 + g] = make_float4(")],
}
VARIANTS["stores_only"] = (VARIANTS["no_width"] + VARIANTS["no_height_taps"]
                           + VARIANTS["no_staging"])


def build_all():
    """name -> C entry of each variant, built all together."""
    from mmlspark_tpu_torch.ops import _ablation, _build

    src = open(os.path.join(_build.CSRC, "resize_normalize.cu"),
               encoding="utf-8").read()
    texts = {name: _ablation.patched(src, patches, name)
             for name, patches in VARIANTS.items()}
    entries = {}
    for name, lib in _ablation.build_variants(texts, "resample").items():
        fn = lib.mmk_affine_resample
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("resample_ablation: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.ops import _ablation
    from mmlspark_tpu_torch.ops import image_kernels as K

    entries = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
        plan = K.resize_plan(shape[1], shape[2], 3, 224, 224, (100.0,) * 3,
                             (50.0,) * 3)
        ty, span = plan.tiling(x.dtype, shape[0])
        a_h, a_w, cmix, mean, inv, y_rng, x_rng, w_taps, x_lo = \
            plan.tensors(x.device)
        tiles = plan.tile_tensor(x.device, ty)
        out = torch.empty((shape[0], 224, 224, 3), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def variant(fn):
            def call():
                err = fn(x.data_ptr(), 1, out.data_ptr(), shape[0], shape[1],
                         shape[2], 3, 224, 224, 3, a_h.data_ptr(),
                         a_w.data_ptr(), y_rng.data_ptr(), x_rng.data_ptr(),
                         cmix.data_ptr(), mean.data_ptr(), inv.data_ptr(), ty,
                         tiles.data_ptr(), span, w_taps.data_ptr(),
                         x_lo.data_ptr(), plan.k_w, plan.k_h, int(plan.mix),
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        calls = {name: variant(fn) for name, fn in entries.items()}
        # the rule at other budgets of blocks an SM, and the pixel route
        rule = {}
        for blocks in (1, 2, 3, 4):
            K.TILE_SMEM = (233_472 - 1_024 * blocks) // blocks
            plan._tiling.clear()
            rule[blocks] = plan.tiling(x.dtype, shape[0])
        K.TILE_SMEM = (233_472 - 1_024 * K.TILE_BLOCKS_PER_SM) \
            // K.TILE_BLOCKS_PER_SM
        plan._tiling.clear()
        for blocks, (b_ty, b_span) in rule.items():
            calls[f"budget_{blocks}_blocks_ty{b_ty}"] = (
                lambda t=b_ty, s=b_span: K._launch(x, plan, t, s))
        calls["pixel_route"] = lambda: K._launch(x, plan, 0, 0)
        for rnd in range(2):
            times = {name: round(_ablation.queued_ms(call), 4)
                     for name, call in calls.items()}
            print(f"[ablation] {list(shape)} uint8 -> 224x224 (rule TY {ty} "
                  f"span {span}) round {rnd}: {times}", flush=True)
    print(_ablation.card())


if __name__ == "__main__":
    main()
