"""Time the port's JPEG path on this tree's decoder and another tree's, in
turns, in one process on one card.

    python3 jpeg_route_bench.py --first PATH [--rounds 6]

PATH is another checkout of the repository (for example the parent
commit, unpacked with `git archive <commit> | tar -x -C PATH`).  Its
decoder module (`mmlspark_tpu_torch/native`) is imported beside this
tree's under another name and builds its own library by its own rules;
everything else that runs is this tree's.  A turn puts one tree's
`jpeg_available`, `jpeg_probe` and `decode_jpeg_bgr_into` in place of the
package's and measures, on bench.py's recipe (the six committed
`tests/jpeg_fixtures/bench_*.jpg`: uniform noise, quality 85, 4:2:0,
256x256, 224x224 and 320x240):

- the decoder alone: 192 fixture JPEGs decoded by 4 threads into one
  chunk's slots, images/s of each of 3 passes; and the same 192 decoded
  one after another on one thread, ms an image of each of 3 passes (the
  latency an image pays, C2's launch and kernel included on this tree);
- the JPEG path: `ImageFeaturizer(zoo ResNet-50, batch 64)` over a bytes
  column of those 192 JPEGs (three shape groups, as `chip_smoke.py`
  phase 4b), images/s of each of 3 runs and the feed's `stall_decode_s`
  share of the wall.

A round is PATH, this, this, PATH; the next round the other way round.
Each turn checks that its tree's decoder ran: the C2 kernel's launch
count (this tree's) grows by one a JPEG in this tree's turns and not in
PATH's.  Prints a JSON line a turn, then one a tree (every run, and its
median), then each round's ratio of this tree to PATH, then the card's
name and power limit.  Needs a CUDA card and
the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES, BATCH, PASSES, THREADS = 192, 64, 3, 4
SWAPPED = ("jpeg_available", "jpeg_probe", "decode_jpeg_bgr_into")


def other_decoder(tree: str):
    """The decoder module of another checkout, as `first_native`."""
    path = os.path.join(tree, "mmlspark_tpu_torch", "native", "__init__.py")
    if not os.path.exists(path):
        raise SystemExit(f"{tree} holds no mmlspark_tpu_torch/native/")
    spec = importlib.util.spec_from_file_location(
        "first_native", path, submodule_search_locations=[os.path.dirname(path)])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not mod.jpeg_available():
        raise SystemExit(f"{tree}'s decoder did not build: {mod.build_error()}")
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("jpeg_route_bench: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch import Table, native
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import ModelRepo, get_or_create_resnet
    from mmlspark_tpu_torch.ops import _ablation, _build

    decoders = {"first": other_decoder(os.path.abspath(args.first)),
                "this": native}
    own = {name: getattr(native, name) for name in SWAPPED}
    assert native.jpeg_backend() == "nvjpeg", native.build_error()
    fx = os.path.join(ROOT, "tests", "jpeg_fixtures")
    blobs = [open(os.path.join(fx, n), "rb").read()
             for n in sorted(os.listdir(fx)) if n.startswith("bench_")]
    column = [blobs[i % len(blobs)] for i in range(N_IMAGES)]
    slots = [np.empty(native.jpeg_probe(b), np.uint8) for b in column]
    _build.build(["resize_normalize"])
    repo = ModelRepo(os.path.join(ROOT, "build", "model_repo"))
    bundle = get_or_create_resnet("resnet50", (224, 224, 3), 1000, repo=repo)
    feat = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    table = Table({"image": column})

    def turn(tree: str) -> dict:
        mod = decoders[tree]
        for name in SWAPPED:
            setattr(native, name, own[name] if tree == "this"
                    else getattr(mod, name))
        try:
            c2_before = native.ycc_launches()
            with ThreadPoolExecutor(THREADS) as ex:
                decode = []
                for _ in range(PASSES + 1):  # the first pass warms
                    t0 = time.perf_counter()
                    ok = list(ex.map(native.decode_jpeg_bgr_into, column,
                                     slots))
                    decode.append(N_IMAGES / (time.perf_counter() - t0))
                    assert all(ok), tree
            serial = []
            for _ in range(PASSES):
                t0 = time.perf_counter()
                for blob, slot in zip(column, slots):
                    native.decode_jpeg_bgr_into(blob, slot)
                serial.append((time.perf_counter() - t0) * 1e3 / N_IMAGES)
            feat.transform(table)
            torch.cuda.synchronize()
            path, share = [], []
            for _ in range(PASSES):
                before = FEED_TELEMETRY.snapshot()
                t0 = time.perf_counter()
                out = feat.transform(table)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                assert out["features"].shape == (N_IMAGES, 2048)
                path.append(N_IMAGES / wall)
                share.append(FEED_TELEMETRY.delta(before)["stall_decode_s"]
                             / wall)
            c2 = native.ycc_launches() - c2_before
            want = (3 * PASSES + 2) * N_IMAGES if tree == "this" else 0
            if c2 != want:
                raise SystemExit(f"{tree}'s turn launched C2 {c2} times, "
                                 f"not {want}: the swap did not take")
        finally:
            for name in SWAPPED:
                setattr(native, name, own[name])
        return {"decode_images_per_s": decode[1:],
                "decode_serial_ms_per_image": serial,
                "jpeg_path_images_per_s": path,
                "stall_decode_share": share}

    turn("this")  # builds, loads the model and warms both routes once
    turn("first")
    runs = {"first": [], "this": []}
    for r in range(args.rounds):
        order = ["first", "this", "this", "first"] if r % 2 == 0 \
            else ["this", "first", "first", "this"]
        for tree in order:
            row = turn(tree)
            runs[tree].append(row)
            print(json.dumps({"round": r, "tree": tree,
                              **{k: [round(v, 4) for v in vs]
                                 for k, vs in row.items()}}), flush=True)
    for tree, rows in runs.items():
        summary = {"tree": tree, "backend": decoders[tree].jpeg_backend()}
        for key in ("decode_images_per_s", "decode_serial_ms_per_image",
                    "jpeg_path_images_per_s", "stall_decode_share"):
            every = [v for row in rows for v in row[key]]
            turns = [statistics.median(row[key]) for row in rows]
            summary[key] = {"median": statistics.median(every),
                            "turn_medians": [round(v, 4) for v in turns],
                            "min": min(every), "max": max(every)}
        print(json.dumps(summary), flush=True)
    # each round's this-over-PATH ratio of the turn medians: the two
    # trees' turns of a round are adjacent, so host drift cancels there
    paired = {}
    for key in ("decode_images_per_s", "decode_serial_ms_per_image",
                "jpeg_path_images_per_s"):
        ratios = []
        for r in range(args.rounds):
            this, first = (sum(statistics.median(row[key])
                               for row in runs[tree][2 * r:2 * r + 2])
                           for tree in ("this", "first"))
            ratios.append(this / first)
        paired[key] = {"rounds": [round(v, 4) for v in ratios],
                       "median": statistics.median(ratios)}
    print(json.dumps({"this_over_first": paired}), flush=True)
    print(_ablation.card())


if __name__ == "__main__":
    main()
