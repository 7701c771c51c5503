"""Drive the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit, no result line) if anything in it fails:

1. device: a CUDA card must be present; its name and power limit are
   read with nvidia-smi.
2. build: every kernel of `mmlspark_tpu_torch/csrc/` is compiled (one
   nvcc per source, all at once) into `mmlspark_tpu_torch/csrc/build/`.
3. kernel check: each kernel's wrapper runs on the card at the shapes the
   main path gives it (plus a ragged one) and is held against its plain
   PyTorch version on the same inputs; kernel, plain and library times
   (CUDA events) are printed beside the least time the card could take.
4. main path: `ImageFeaturizer.transform` with the zoo's random-init
   ResNet-50 at 224x224, batch 64, on a table of 192 uint8 BGR images in
   the three sizes of the JAX package's benchmark (256x256, 224x224,
   320x240).  The kernel's launch counter is zeroed just before and read
   just after; the pooled features are checked for shape and finiteness,
   against the same transform with the preprocess forced through the
   plain version on the card, and against an f32 run of the port on the
   CPU (on weights with random BatchNorms, so that every residual
   branch counts) for a few images.  Then images/s as a range over
   repeated runs with the feed's time split, and one chunk's device time
   from a CUDA-graph replay beside its eager stream span.
5. record: a `{"kernels": [...]}` JSON line, the nvidia-smi line, and
   last the `{"ok": true, "device": ...}` line.

Imports nothing of JAX or of the JAX package, and no PIL: the images are
made with numpy from a seed.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA's data sheet) for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ATOL = 1e-3              # kernel vs plain version, normalized units
PLAIN_FEATURES_RTOL = 2e-2   # relative L2, bf16 forward on both sides
CPU_FEATURES_RTOL = 3e-2     # relative L2, bf16 card vs f32 CPU

TIMED_RUNS = 7

IMG = 224
BATCH = 64
N_IMAGES = 192
SIZES = [(256, 256), (224, 224), (320, 240)]
MEAN_BGR = (103.53, 116.28, 123.675)
STD_BGR = (57.375, 57.12, 58.395)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
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


def resample_bound(plan, batch) -> tuple:
    """(bound_ms, bound_by) of one affine resample: the bytes it must move
    at the HBM rate (the batch read once, the f32 output written once, and
    of the weights only the non-zero taps and their ranges), against the
    f32 operations these taps need at the f32 peak."""
    import numpy as np

    ny = (plan.y_rng[:, 1] - plan.y_rng[:, 0]).astype(np.float64)
    nx = (plan.x_rng[:, 1] - plan.x_rng[:, 0]).astype(np.float64)
    b, ci, co = batch.shape[0], plan.c_in, plan.c_out
    flops = b * (ny.sum() * nx.sum() * 2 * ci        # width taps
                 + ny.sum() * plan.w_out * 2 * ci    # height taps
                 + plan.h_out * plan.w_out * co * (2 * ci + 2))  # mix + norm
    taps = (ny.sum() + nx.sum()) * 4 + plan.y_rng.nbytes + plan.x_rng.nbytes
    epilogue = plan.cmix.nbytes + plan.mean_eff.nbytes + plan.inv_eff.nbytes
    nbytes = (batch.numel() * batch.element_size() + taps + epilogue
              + b * plan.h_out * plan.w_out * co * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_resample(K, shape, dtype, seed):
    """Kernel vs plain (and the library call) at one shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == "uint8":
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
    else:
        x = torch.rand(shape, device="cuda", generator=gen) * 255.0
    c = shape[3]
    mean, std = MEAN_BGR[:c], STD_BGR[:c]
    plan = K.resize_plan(shape[1], shape[2], c, IMG, IMG, mean, std)
    got = K.affine_resample(x, plan)
    ref = K.affine_resample_plain(x, plan)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"resample {shape}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    mean_t = torch.tensor(mean, device="cuda").view(1, c, 1, 1)
    inv_t = 1.0 / torch.tensor(std, device="cuda").view(1, c, 1, 1)

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(IMG, IMG),
                          mode="bilinear", align_corners=False, antialias=True)
        return (y - mean_t) * inv_t

    lib_err = float((library().permute(0, 2, 3, 1) - ref).abs().max())
    kernel_ms = cuda_ms(lambda: K.affine_resample(x, plan), 20)
    plain_ms = cuda_ms(lambda: K.affine_resample_plain(x, plan), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = resample_bound(plan, x)
    log(f"[kernel] affine_resample {dtype}{list(shape)} -> {IMG}x{IMG}: "
        f"max_abs_err={err:.3e} kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(library agrees: {lib_err <= ATOL}, max_abs_err={lib_err:.3e}) "
        f"bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    if err > ATOL:
        fail(f"resample {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e} > {ATOL})")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms if lib_err <= ATOL else None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def graph_ms(forward, x, iters: int) -> tuple:
    """Device time of one forward(x), from replays of a CUDA graph of it
    (no host dispatch between kernels), and the largest gap between the
    graph's output and an eager call's, relative to the output's scale."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            forward(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = forward(x)
    ms = cuda_ms(graph.replay, iters)
    eager = forward(x)
    torch.cuda.synchronize()
    gap = float((out - eager).abs().max() / eager.abs().max())
    return ms, gap


def profiled_kernel_ms(fn):
    """(compute-kernel ms, affine_resample ms, wall ms) of one fn() under
    torch.profiler: the device time of every kernel (copies and memsets
    left out: they run on the feed's side stream and overlap), or None
    if the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_us = b1_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.key.startswith(("Memcpy", "Memset")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        total_us += us
        if "affine_resample" in ev.key:
            b1_us += us
    if total_us <= 0:
        return None
    return total_us / 1e3, b1_us / 1e3, wall_ms


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not os.path.isdir(os.path.join(ROOT, "mmlspark_tpu_torch")):
        fail("run from a checkout: mmlspark_tpu_torch/ is not beside chip_smoke.py")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import ImagePreprocess
    from mmlspark_tpu_torch.models.zoo import ModelRepo, get_or_create_resnet
    from mmlspark_tpu_torch.ops import _build
    from mmlspark_tpu_torch.ops import image_kernels as K

    # ---- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()} ({card}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {len(secs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s: {secs}")
    for name in secs:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel check -----------------------------------------------
    main_shapes = [(BATCH, h, w, 3) for h, w in SIZES]
    checks = [check_resample(K, s, "uint8", seed=i)
              for i, s in enumerate(main_shapes)]
    extra = [check_resample(K, (7, 333, 517, 3), "uint8", seed=7),
             check_resample(K, (5, 97, 131, 1), "float32", seed=8)]

    # ---- 4. main path --------------------------------------------------
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(*SIZES[i % 3], 3), dtype=np.uint8)
              for i in range(N_IMAGES)]
    table = Table({"image": images, "id": np.arange(N_IMAGES)})
    repo = ModelRepo(os.path.join(ROOT, "build", "model_repo"))
    t0 = time.perf_counter()
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    log(f"[main] zoo resnet50 ready in {time.perf_counter() - t0:.2f} s")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    n_chunks = sum(math.ceil(N_IMAGES / len(SIZES) / BATCH) for _ in SIZES)

    K.LAUNCHES = 0
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = K.LAUNCHES
    feats = out["features"]
    log(f"[main] first transform {first_s:.3f} s; affine_resample "
        f"launches={launches} (chunks={n_chunks})")
    if launches != n_chunks:
        fail(f"the main path launched the kernel {launches} times, "
             f"expected one per chunk ({n_chunks})")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"features: shape {feats.shape}, finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("row order changed")

    class PlainPreprocess(ImagePreprocess):
        """The same preprocess with the kernel's plain version, on the card."""

        @property
        def key(self):
            return ("plain",) + super().key

        def __call__(self, batch):
            batch = self.fix_channels(batch)
            mean, std = self.mean_std(batch.shape[-1])
            plan = K.resize_plan(*batch.shape[1:], self.height, self.width,
                                 tuple(mean), tuple(std))
            return K.affine_resample_plain(batch, plan)

    plain_model = featurizer._model_for(bundle, "image")
    plain_model.set(preprocess=PlainPreprocess(IMG, IMG, MEAN_BGR, STD_BGR))
    plain_feats = plain_model.transform(table)["features"]
    err_plain = rel_l2(feats, plain_feats)
    log(f"[main] features vs plain-preprocess run: rel_l2={err_plain:.3e} "
        f"(bound {PLAIN_FEATURES_RTOL})")
    if err_plain > PLAIN_FEATURES_RTOL:
        fail("features disagree with the plain-preprocess run")

    # The card's bf16 forward against an f32 CPU run of the port, on
    # weights whose BatchNorms are all random: under the zoo's flax-style
    # init every residual branch is 0, and only the stem and the
    # projection convs would be checked.
    few = [i for s in range(len(SIZES)) for i in range(s, 12, len(SIZES))]
    few_table = Table({"image": [images[i] for i in few]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side_feats = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        side_feats[dev] = ImageFeaturizer(
            bundle=check_bundle, batch_size=BATCH,
            device=dev).transform(few_table)["features"]
    err_cpu = rel_l2(side_feats["cuda"], side_feats["cpu"])
    log(f"[main] features (random-BatchNorm ResNet-50, bf16 on the card) vs "
        f"an f32 CPU run of {len(few)} images: rel_l2={err_cpu:.3e} "
        f"(bound {CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("features disagree with the f32 CPU run")

    # images/s on the host's clock, as a range over repeated runs (a run
    # is tens of ms on a shared host), with the feed's split of the median
    runs = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        before = FEED_TELEMETRY.snapshot()
        t0 = time.perf_counter()
        featurizer.transform(table)
        runs.append((time.perf_counter() - t0, FEED_TELEMETRY.delta(before)))
    runs.sort(key=lambda r: r[0])
    walls = [r[0] for r in runs]
    med_wall, med_feed = runs[len(runs) // 2]
    log(f"[main] ImageFeaturizer resnet50 pool {IMG}x{IMG} batch {BATCH}, "
        f"{N_IMAGES} images, {TIMED_RUNS} runs: images/s min "
        f"{N_IMAGES / walls[-1]:.0f}, median {N_IMAGES / med_wall:.0f}, "
        f"max {N_IMAGES / walls[0]:.0f} (walls {walls[0]:.4f}-{walls[-1]:.4f}"
        f" s) on {card}")
    log("[main] median run's feed: " + " ".join(
        f"{k}={med_feed[k]:.4f}" for k in (
            "wall_s", "stall_decode_s", "transfer_s", "compute_s",
            "stall_drain_s")))
    # one chunk's device work (B1 at identity size + the ResNet-50 bf16
    # forward): from a CUDA-graph replay, which has no dispatch gaps, and
    # the eager stream span, which includes them
    _module, forward = featurizer._model_for(bundle, "image")._executor(
        bundle, "pool", torch.device("cuda"))
    x224 = torch.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    span_ms = cuda_ms(lambda: forward(x224), 10)
    dev_ms, gap = graph_ms(forward, x224, 20)
    log(f"[main] one chunk (B1 + ResNet-50 bf16, batch {BATCH}): device "
        f"time {dev_ms:.3f} ms (CUDA-graph replay; graph vs eager output "
        f"gap {gap:.1e}) = {BATCH / dev_ms * 1e3:.0f} images/s; eager "
        f"stream span incl. dispatch gaps {span_ms:.3f} ms; x{n_chunks} "
        f"chunks of device time = {n_chunks * dev_ms / (med_wall * 1e3):.3f}"
        f" of the median run's wall")
    if gap > 1e-2:
        fail(f"the CUDA graph's output differs from the eager forward's "
             f"(relative gap {gap:.1e})")
    busy = profiled_kernel_ms(lambda: featurizer.transform(table))
    if busy is None:
        log("[main] profiled run: the profiler saw no device time "
            "(device busy share not measured)")
    else:
        total_ms, b1_ms, wall_ms = busy
        log(f"[main] profiled run: compute kernels {total_ms:.3f} ms on the "
            f"device, of which affine_resample {b1_ms:.4f} ms "
            f"({b1_ms / total_ms:.4f}); the profiled run's wall {wall_ms:.3f}"
            f" ms; kernels / median unprofiled wall = "
            f"{total_ms / (med_wall * 1e3):.3f}")

    # ---- 5. record -----------------------------------------------------
    lib = [c["library_ms"] for c in checks]
    kernels = [{
        "name": "affine_resample",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:164",
        "launches": launches,
        "max_abs_err": max(c["err"] for c in checks + extra),
        # one chunk of each of the main path's three chunk shapes, summed
        "ms": sum(c["ms"] for c in checks),
        "plain_ms": sum(c["plain_ms"] for c in checks),
        "bound_ms": sum(c["bound_ms"] for c in checks),
        "bound_by": ("bytes" if all(c["bound_by"] == "bytes" for c in checks)
                     else "operations"),
        "library_ms": sum(lib) if None not in lib else None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
