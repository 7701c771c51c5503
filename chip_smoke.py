"""Drive the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit, no result line) if anything in it fails:

1. device: a CUDA card must be present; its name and power limit are
   read with nvidia-smi.
2. build: every kernel of `mmlspark_tpu_torch/csrc/` is compiled (one
   nvcc per source, all at once) into `mmlspark_tpu_torch/csrc/build/`;
   each one's register and spill report is printed.
3. kernel check: each kernel's wrapper runs on the card at the shapes the
   main paths give it (plus ragged ones) and is held against its plain
   PyTorch version on the same inputs; kernel, plain and library times
   (CUDA events) are printed beside the least time the card could take.
4. ResNet path: `ImageFeaturizer.transform` with the zoo's random-init
   ResNet-50 at 224x224, batch 64, on a table of 192 uint8 BGR images in
   the three sizes of the JAX package's benchmark (256x256, 224x224,
   320x240).  The kernels' launch counters are zeroed just before and
   read just after; the pooled features are checked for shape and
   finiteness, against the same transform with the preprocess forced
   through the plain version on the card, and against an f32 run of the
   port on the CPU (on weights with random BatchNorms, so that every
   residual branch counts) for a few images.  Then images/s as a range
   over repeated runs with the feed's time split, and one chunk's device
   time from a CUDA-graph replay beside its eager stream span.
5. ViT path: the same transform and table with the zoo's random-init
   ViT-B/16 (seed 0): B4 launches 12 times per chunk, B1 once; the
   features are checked against the same transform with attention forced
   through the plain version on the card and against an f32 CPU run of
   the port on a few images; images/s and one chunk's device time.
6. LM path: greedy `generate` on a random-init GPT-small TransformerLM
   (vocab 8192, embed 768, 12 layers, 12 heads, max_len 1024, bf16),
   batch 8, a 1000-token prompt, 24 new tokens: B4 launches exactly 12
   times (the prefill) and never in the decode steps; the prefill logits
   are checked against a plain-attention prefill on the card and against
   an f32 CPU prefill of a 128-token prompt; prefill ms and decode
   tokens/s.
7. record: a `{"kernels": [...]}` JSON line, the nvidia-smi line, and
   last the `{"ok": true, "device": ...}` line.

Imports nothing of JAX or of the JAX package, and no PIL: the images,
tokens and weights are made from seeds.
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
BF16_FLOPS = 989e12

ATOL = 1e-3              # resize kernel vs plain version, normalized units
PLAIN_FEATURES_RTOL = 2e-2   # relative L2, bf16 forward on both sides
CPU_FEATURES_RTOL = 3e-2     # relative L2, bf16 card vs f32 CPU
# attention kernel vs plain version: f32 inputs at f32 rounding; bf16
# inputs round the probabilities to bf16 before PV (unnormalized in the
# kernel, normalized in the plain version), so ~2^-8 relative per term
ATTN_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-4
# the transformer paths, relative L2: kernel vs plain attention, both
# bf16 (only the attention's rounding differs); bf16 on the card vs f32
# on the CPU (bf16 keeps 8 mantissa bits; 12 blocks of bf16 matmuls,
# LayerNorms and residual adds)
VIT_PLAIN_RTOL = 2e-2
VIT_CPU_RTOL = 5e-2
LM_PLAIN_RTOL = 2e-2
LM_CPU_RTOL = 5e-2

TIMED_RUNS = 5

IMG = 224
BATCH = 64
N_IMAGES = 192
SIZES = [(256, 256), (224, 224), (320, 240)]
MEAN_BGR = (103.53, 116.28, 123.675)
STD_BGR = (57.375, 57.12, 58.395)

# GPT-small at bench.py's `_measure_transformer` width (bench.py:538-540)
LM = dict(vocab_size=8192, embed_dim=768, num_layers=12, num_heads=12,
          max_len=1024)
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1000, 24
LM_CPU_PROMPT = 128


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


def attention_bound(shape, dtype: str, causal: bool) -> tuple:
    """(bound_ms, bound_by) of one flash-attention forward: q, k and v
    read once in their dtype plus O (f32) and the logsumexp written once,
    at the HBM rate, against 4*B*H*S*S*D operations (times (S+1)/(2S)
    under the causal mask: the visible half) at the peak rate of the
    inputs' type (bf16 tensor cores, or f32 outside them)."""
    b, s, h, d = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * b * s * h * d * item + b * s * h * d * 4 + b * h * s * 4
    ops = 4.0 * b * h * s * s * d * ((s + 1) / (2 * s) if causal else 1.0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(A, shape, dtype: str, causal: bool, seed: int):
    """Kernel vs plain (and SDPA as the library yardstick) at one shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(
        getattr(torch, dtype)) for _ in range(3))
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"attention {shape}: bad output {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    lib_err = float((library().transpose(1, 2).float() - ref).abs().max())
    kernel_ms = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), 20)
    plain_ms = cuda_ms(lambda: A.flash_attention_fwd_plain(q, k, v, causal), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = attention_bound(shape, dtype, causal)
    log(f"[kernel] flash_attention_fwd {dtype}{list(shape)} "
        f"causal={causal}: max_abs_err={err:.3e} (limit {ATTN_ATOL[dtype]}) "
        f"lse_err={lse_err:.3e} (limit {LSE_ATOL}) kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA, "
        f"max_abs_err vs plain {lib_err:.3e}) bound_ms={bound_ms:.4f} "
        f"({bound_by}) roofline_share={bound_ms / kernel_ms:.3f}")
    if err > ATTN_ATOL[dtype] or lse_err > LSE_ATOL:
        fail(f"attention {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e}, lse {lse_err:.3e})")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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


def profiled_kernel_ms(fn, names):
    """(compute-kernel ms, {name: ms of the kernels whose name holds it},
    wall ms) of one fn() under torch.profiler: the device time of every
    kernel (copies and memsets left out: they run on the feed's side
    stream and overlap), or None if the profiler saw no device time."""
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
    total_us = 0.0
    by_name = {n: 0.0 for n in names}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.key.startswith(("Memcpy", "Memset")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        total_us += us
        for n in names:
            if n in ev.key:
                by_name[n] += us
    if total_us <= 0:
        return None
    return total_us / 1e3, {n: us / 1e3 for n, us in by_name.items()}, wall_ms


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def timed_transforms(featurizer, table, label, card):
    """images/s on the host's clock, as a range over repeated runs (a run
    is tens of ms on a shared host), with the feed's split of the median;
    returns the median wall in seconds."""
    import torch
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY

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
    log(f"[{label}] ImageFeaturizer pool {IMG}x{IMG} batch {BATCH}, "
        f"{N_IMAGES} images, {TIMED_RUNS} runs: images/s min "
        f"{N_IMAGES / walls[-1]:.0f}, median {N_IMAGES / med_wall:.0f}, "
        f"max {N_IMAGES / walls[0]:.0f} (walls {walls[0]:.4f}-{walls[-1]:.4f}"
        f" s) on {card}")
    log(f"[{label}] median run's feed: " + " ".join(
        f"{k}={med_feed[k]:.4f}" for k in (
            "wall_s", "stall_decode_s", "transfer_s", "compute_s",
            "stall_drain_s")))
    return med_wall


def chunk_device_time(featurizer, bundle, label, n_chunks, med_wall):
    """One chunk's device work (B1 at identity size + the backbone's bf16
    forward): from a CUDA-graph replay, which has no dispatch gaps, and
    the eager stream span, which includes them."""
    import torch

    _module, forward = featurizer._model_for(bundle, "image")._executor(
        bundle, "pool", torch.device("cuda"))
    x224 = torch.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    span_ms = cuda_ms(lambda: forward(x224), 10)
    dev_ms, gap = graph_ms(forward, x224, 20)
    log(f"[{label}] one chunk (B1 + {bundle.builder} bf16, batch {BATCH}): "
        f"device time {dev_ms:.3f} ms (CUDA-graph replay; graph vs eager "
        f"output gap {gap:.1e}) = {BATCH / dev_ms * 1e3:.0f} images/s; eager "
        f"stream span incl. dispatch gaps {span_ms:.3f} ms; x{n_chunks} "
        f"chunks of device time = {n_chunks * dev_ms / (med_wall * 1e3):.3f}"
        f" of the median run's wall")
    if gap > 1e-2:
        fail(f"the CUDA graph's output differs from the eager forward's "
             f"(relative gap {gap:.1e})")


def profile_run(fn, label, names, med_wall_s):
    busy = profiled_kernel_ms(fn, names)
    if busy is None:
        log(f"[{label}] profiled run: the profiler saw no device time "
            "(device busy share not measured)")
        return
    total_ms, by_name, wall_ms = busy
    shares = " ".join(f"{n} {ms:.4f} ms ({ms / total_ms:.4f})"
                      for n, ms in by_name.items())
    log(f"[{label}] profiled run: compute kernels {total_ms:.3f} ms on the "
        f"device, of which {shares}; the profiled run's wall {wall_ms:.3f}"
        f" ms; kernels / median unprofiled wall = "
        f"{total_ms / (med_wall_s * 1e3):.3f}")


def resnet_path(K, A, images, table, repo, n_chunks, card):
    """Phase 4; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import ImagePreprocess
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet

    t0 = time.perf_counter()
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    log(f"[resnet] zoo resnet50 ready in {time.perf_counter() - t0:.2f} s")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)

    K.LAUNCHES = A.LAUNCHES = 0
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = {"affine_resample": K.LAUNCHES, "flash_attention_fwd": A.LAUNCHES}
    feats = out["features"]
    log(f"[resnet] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks})")
    if launches != {"affine_resample": n_chunks, "flash_attention_fwd": 0}:
        fail(f"the ResNet path launched the kernels {launches} times, "
             f"expected affine_resample once per chunk ({n_chunks})")
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
    log(f"[resnet] features vs plain-preprocess run: rel_l2={err_plain:.3e} "
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
    log(f"[resnet] features (random-BatchNorm ResNet-50, bf16 on the card) "
        f"vs an f32 CPU run of {len(few)} images: rel_l2={err_cpu:.3e} "
        f"(bound {CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("features disagree with the f32 CPU run")

    med_wall = timed_transforms(featurizer, table, "resnet", card)
    chunk_device_time(featurizer, bundle, "resnet", n_chunks, med_wall)
    profile_run(lambda: featurizer.transform(table), "resnet",
                ["affine_resample"], med_wall)
    del featurizer, plain_model
    torch.cuda.empty_cache()
    return launches


def vit_path(K, A, images, table, repo, n_chunks, card):
    """Phase 5; returns {kernel: launches}."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    t0 = time.perf_counter()
    bundle = get_or_create_resnet("vit_base", (IMG, IMG, 3), 1000, repo=repo)
    log(f"[vit] zoo vit_base ready in {time.perf_counter() - t0:.2f} s")
    if bundle.layer_names[1] != "pool" or "encoded" not in bundle.layer_names:
        fail(f"vit_base bundle taps {bundle.layer_names}")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    layers = 12

    K.LAUNCHES = A.LAUNCHES = 0
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = {"affine_resample": K.LAUNCHES, "flash_attention_fwd": A.LAUNCHES}
    feats = out["features"]
    log(f"[vit] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks}, layers={layers})")
    want = {"affine_resample": n_chunks,
            "flash_attention_fwd": layers * n_chunks}
    if launches != want:
        fail(f"the ViT path launched the kernels {launches} times, "
             f"expected {want}")
    if feats.shape != (N_IMAGES, 768) or not np.isfinite(feats).all():
        fail(f"ViT features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("ViT path changed the row order")

    # the same transform, attention through the plain version on the card
    plain_attn = functools.partial(full_attention, causal=False)
    plain_bundle = TorchBundle(
        "vit_base", dict(bundle.builder_kwargs, attn_fn=plain_attn),
        state_dict=bundle.state_dict, input_shape=(IMG, IMG, 3))
    A.LAUNCHES = 0
    plain_feats = ImageFeaturizer(bundle=plain_bundle, batch_size=BATCH
                                  ).transform(table)["features"]
    if A.LAUNCHES:
        fail("the plain-attention ViT launched the attention kernel")
    err_plain = rel_l2(feats, plain_feats)
    log(f"[vit] features vs plain-attention run on the card: "
        f"rel_l2={err_plain:.3e} (bound {VIT_PLAIN_RTOL})")
    if err_plain > VIT_PLAIN_RTOL:
        fail("ViT features disagree with the plain-attention run")

    few = [i for s in range(len(SIZES)) for i in range(s, 6, len(SIZES))]
    few_table = Table({"image": [images[i] for i in few]})
    cpu_bundle = TorchBundle("vit_base", bundle.builder_kwargs,
                             state_dict=bundle.state_dict,
                             input_shape=(IMG, IMG, 3), dtype="float32")
    cpu_feats = ImageFeaturizer(bundle=cpu_bundle, batch_size=BATCH,
                                device="cpu").transform(few_table)["features"]
    err_cpu = rel_l2(feats[few], cpu_feats)
    log(f"[vit] features (bf16 on the card) vs an f32 CPU run of "
        f"{len(few)} images: rel_l2={err_cpu:.3e} (bound {VIT_CPU_RTOL})")
    if err_cpu > VIT_CPU_RTOL:
        fail("ViT features disagree with the f32 CPU run")

    med_wall = timed_transforms(featurizer, table, "vit", card)
    chunk_device_time(featurizer, bundle, "vit", n_chunks, med_wall)
    profile_run(lambda: featurizer.transform(table), "vit",
                ["affine_resample", "flash_fwd"], med_wall)
    del featurizer, plain_bundle
    torch.cuda.empty_cache()
    return launches


def lm_path(K, A, card):
    """Phase 6; returns {kernel: launches}."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    t0 = time.perf_counter()
    bundle = TorchBundle("transformer_lm", LM, input_shape=(LM_PROMPT,),
                         seed=0)
    log(f"[lm] random-init TransformerLM {LM} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_PROMPT)).astype(np.int32)

    K.LAUNCHES = A.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.generate(bundle, prompt, LM_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"affine_resample": K.LAUNCHES, "flash_attention_fwd": A.LAUNCHES}
    log(f"[lm] first generate (batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_NEW} new tokens) {first_s:.3f} s; launches {launches}")
    want = {"affine_resample": 0, "flash_attention_fwd": LM["num_layers"]}
    if launches != want:
        fail(f"the LM path launched the kernels {launches} times, expected "
             f"{want} (the prefill once per layer; no decode step)")
    toks = out.cpu().numpy()
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            not (toks[:, :LM_PROMPT] == prompt).all() or \
            toks.min() < 0 or toks.max() >= LM["vocab_size"]:
        fail(f"generate returned {toks.shape}, or tokens outside the vocab "
             f"or a changed prompt")

    module = G._module_for(bundle, torch.device("cuda"))
    plain_bundle = TorchBundle(
        "transformer_lm",
        dict(LM, attn_fn=functools.partial(full_attention, causal=True)),
        state_dict=bundle.state_dict, input_shape=(LM_PROMPT,))
    plain_module = plain_bundle.module(torch.device("cuda"))
    p_cuda = torch.from_numpy(prompt).cuda()
    with torch.inference_mode():
        logits = module(p_cuda)[0]
        plain_logits = plain_module(p_cuda)[0]
        # greedy's first new token, from the prefill's last position
        if not torch.equal(out[:, LM_PROMPT].long(),
                           logits[:, -1].argmax(-1)):
            fail("generate's first token is not the prefill's argmax")
    err_plain = rel_l2(logits.cpu().numpy(), plain_logits.cpu().numpy())
    log(f"[lm] prefill logits vs plain-attention prefill on the card: "
        f"rel_l2={err_plain:.3e} (bound {LM_PLAIN_RTOL})")
    if err_plain > LM_PLAIN_RTOL:
        fail("prefill logits disagree with the plain-attention prefill")
    del plain_module, plain_logits, logits

    cpu_bundle = TorchBundle("transformer_lm", LM, state_dict=bundle.state_dict,
                             input_shape=(LM_PROMPT,), dtype="float32")
    short = torch.from_numpy(prompt[:2, :LM_CPU_PROMPT])
    with torch.inference_mode():
        card_short = module(short.cuda())[0].cpu().numpy()
        cpu_short = cpu_bundle.module(torch.device("cpu"))(short)[0].numpy()
    err_cpu = rel_l2(card_short, cpu_short)
    log(f"[lm] prefill logits (bf16 on the card) vs an f32 CPU prefill of "
        f"a {LM_CPU_PROMPT}-token prompt, batch 2: rel_l2={err_cpu:.3e} "
        f"(bound {LM_CPU_RTOL})")
    if err_cpu > LM_CPU_RTOL:
        fail("prefill logits disagree with the f32 CPU prefill")

    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: G._prefill_cache(module, p_cuda), 5)
        _logits, cache = G._prefill_cache(module, p_cuda)
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
        steps = LM_NEW - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = module.decode_step(tok, cache, LM_PROMPT + i)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G.generate(bundle, prompt, LM_NEW)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    log(f"[lm] prefill (batch {LM_BATCH} x {LM_PROMPT} tokens, 12 layers, "
        f"KV copied into the caches) {prefill_ms:.3f} ms (CUDA events over "
        f"5 back-to-back prefills) = "
        f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} prompt tokens/s; "
        f"{steps} eager decode steps {decode_s * 1e3:.3f} ms = "
        f"{LM_BATCH * steps / decode_s:.0f} tokens/s "
        f"({decode_s / steps * 1e3:.3f} ms a step); whole generate walls "
        f"{min(walls):.4f}-{max(walls):.4f} s on {card}")
    profile_run(lambda: G.generate(bundle, prompt, LM_NEW), "lm",
                ["flash_fwd"], min(walls))
    del module, cache
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return launches


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
    from mmlspark_tpu_torch.models.zoo import ModelRepo
    from mmlspark_tpu_torch.ops import _build
    from mmlspark_tpu_torch.ops import attention_kernels as A
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
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel check -----------------------------------------------
    main_shapes = [(BATCH, h, w, 3) for h, w in SIZES]
    checks = [check_resample(K, s, "uint8", seed=i)
              for i, s in enumerate(main_shapes)]
    extra = [check_resample(K, (7, 333, 517, 3), "uint8", seed=7),
             check_resample(K, (5, 97, 131, 1), "float32", seed=8)]
    # B4 at the ViT-B/16 chunk and the LM prefill (the main paths'
    # shapes), then a ragged causal f32 and a D = 32 shape
    attn_main = [
        check_attention(A, (BATCH, 196, 12, 64), "bfloat16", False, seed=10),
        check_attention(A, (LM_BATCH, LM_PROMPT, 12, 64), "bfloat16", True,
                        seed=11)]
    attn_extra = [
        check_attention(A, (3, 77, 5, 64), "float32", True, seed=12),
        check_attention(A, (8, 128, 4, 32), "bfloat16", True, seed=13)]

    # ---- 4-6. the paths --------------------------------------------------
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(*SIZES[i % 3], 3), dtype=np.uint8)
              for i in range(N_IMAGES)]
    table = Table({"image": images, "id": np.arange(N_IMAGES)})
    repo = ModelRepo(os.path.join(ROOT, "build", "model_repo"))
    n_chunks = sum(math.ceil(N_IMAGES / len(SIZES) / BATCH) for _ in SIZES)
    paths = [resnet_path(K, A, images, table, repo, n_chunks, card),
             vit_path(K, A, images, table, repo, n_chunks, card),
             lm_path(K, A, card)]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}

    # ---- 7. record -----------------------------------------------------
    def summed(rows, key):
        vals = [r[key] for r in rows]
        return sum(vals) if None not in vals else None

    def bound_by(rows):
        return ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations")

    kernels = [{
        "name": "affine_resample",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:164",
        "launches": launches["affine_resample"],
        "max_abs_err": max(c["err"] for c in checks + extra),
        # one chunk of each of the main path's three chunk shapes, summed
        "ms": summed(checks, "ms"),
        "plain_ms": summed(checks, "plain_ms"),
        "bound_ms": summed(checks, "bound_ms"),
        "bound_by": bound_by(checks),
        "library_ms": summed(checks, "library_ms"),
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mmlspark_tpu/ops/attention_kernels.py:196",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(c["err"] for c in attn_main + attn_extra),
        # one ViT-B/16 chunk layer plus one LM prefill layer, summed
        "ms": summed(attn_main, "ms"),
        "plain_ms": summed(attn_main, "plain_ms"),
        "bound_ms": summed(attn_main, "bound_ms"),
        "bound_by": bound_by(attn_main),
        "library_ms": summed(attn_main, "library_ms"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
