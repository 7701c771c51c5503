"""What bounds B3, the RLE decode, and how its routes and tile size compare.

Builds patched copies of `mmlspark_tpu_torch/csrc/rle_decode.cu` — the
package's own source and library are never touched — and times each,
queued behind a spin (the device alone), at `tools/feed_bench.py`'s
default chunk (16 x 224 x 224 x 3 uint8 of flat 8-pixel blocks) and at
the worst case of `chip_smoke.py` (64 uniform-random 224 x 224 x 3
images as one chunk), in two rounds of opposite order:

- full: the package's kernel;
- vector_only: every window on the four-runs-a-thread route;
- tile_4k, tile_16k: other tile sizes;
- search_only: the window search, then the (zeroed) tile's stores;
- stores_only: the tile's stores alone (the floor of any tile kernel);
- first: with `--first PATH`, another rle_decode.cu with the same C
  entry (for example an earlier design, from `git show <commit>:<path>`).

Every copy but search_only and stores_only is first held against the
plain version, exact to the byte.  Needs a CUDA card and nvcc:

    python3 rle_ablation.py [--first PATH]

Prints one line per (chunk, round) with the bound (the bytes of the runs
the chunk needs and of the output at 3.35 TB/s), and the card's name and
power limit.  The builds go to `mmlspark_tpu_torch/csrc/build/ablation/`.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
WINDOW = "const int q_begin = win[0], q_end = max(win[3], win[0]) + 1;"

# name -> [(text, replacement)] of the package's source
VARIANTS = {
    "full": [],
    "vector_only": [("if (q_end - q_begin <= kThreads * kFew) {",
                     "if (false) {")],
    "tile_4k": [("constexpr int kTile = 8192;", "constexpr int kTile = 4096;")],
    "tile_16k": [("constexpr int kTile = 8192;",
                  "constexpr int kTile = 16384;")],
    "search_only": [(WINDOW, "const int q_begin = win[0], q_end = win[0];")],
    "stores_only": [("    warp_search(ends, lo, hi, warp == 0 ? t0 : t0 + len - 1);",
                     ""),
                    (WINDOW, "const int q_begin = 0, q_end = 0;")],
}
UNCHECKED = ("search_only", "stores_only")


def build_all(first):
    """name -> C entry of each variant, built all together."""
    from mmlspark_tpu_torch.ops import _ablation, _build

    src = open(os.path.join(_build.CSRC, "rle_decode.cu"),
               encoding="utf-8").read()
    texts = {name: _ablation.patched(src, patches, name)
             for name, patches in VARIANTS.items()}
    if first:
        texts["first"] = open(first, encoding="utf-8").read()
    entries = {}
    for name, lib in _ablation.build_variants(texts, "rle").items():
        fn = lib.mmk_rle_decode
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def chunks():
    """{name: chunk}: feed_bench's default chunk and chip_smoke's worst
    case, from the same seeds."""
    import numpy as np

    rng = np.random.default_rng(0)
    bench = (rng.integers(0, 6, (16, 224, 28, 1)) * 40).astype(
        np.uint8).repeat(8, axis=2).repeat(3, axis=3)
    rng = np.random.default_rng(0)
    sizes = [(256, 256), (224, 224), (320, 240)]
    images = [rng.integers(0, 256, size=(*sizes[i % 3], 3), dtype=np.uint8)
              for i in range(192)]
    return {"feed_bench": bench,
            "uniform_64x224x224x3": np.stack(images[1::3])}


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--first", help="another rle_decode.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rle_ablation: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.ops import _ablation
    from mmlspark_tpu_torch.ops import wire_codec as W

    entries = build_all(args.first)
    stream = torch.cuda.current_stream().cuda_stream
    for cname, arr in chunks().items():
        p = W.rle_encode(arr)
        v = torch.from_numpy(p.values).cuda()
        e = torch.from_numpy(p.ends).cuda()
        ref = W.decode_bytes_plain(v, e, p.n_pad)
        out = torch.empty(p.n_pad, dtype=torch.uint8, device="cuda")

        def variant(fn):
            def call():
                err = fn(v.data_ptr(), e.data_ptr(), v.numel(),
                         out.data_ptr(), p.n_pad, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        calls = {name: variant(fn) for name, fn in entries.items()}
        for name, call in calls.items():
            if name in UNCHECKED:
                continue
            out.zero_()
            call()
            if not torch.equal(out, ref):
                raise SystemExit(f"{name} is not exact on {cname}")
        r_used = int(np.searchsorted(p.ends, p.n_pad - 1, side="right")) + 1
        bound_ms = (5 * r_used + p.n_pad) / HBM_BYTES_PER_S * 1e3
        for rnd in range(2):
            names = list(calls) if rnd == 0 else list(calls)[::-1]
            times = {name: round(_ablation.queued_ms(calls[name]), 4)
                     for name in names}
            print(f"[ablation] {cname} R={len(p.values)} R_used={r_used} "
                  f"n_pad={p.n_pad} bound_ms={bound_ms:.4f} round {rnd}: "
                  f"{ {n: times[n] for n in calls} }", flush=True)
    print(_ablation.card())


if __name__ == "__main__":
    main()
