"""Drive the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit, no result line) if anything in it fails:

1. device: a CUDA card must be present; its name and power limit are
   read with nvidia-smi.
2. build: every kernel of `mmlspark_tpu_torch/csrc/` is compiled (one
   nvcc per source, all at once, beside the nvJPEG decoder with its C2
   kernel, `mmlspark_tpu_torch/native/`) into `mmlspark_tpu_torch/csrc/
   build/` (and `native/build/`);
   each one's register and spill report is printed, and for the TMA /
   wgmma kernels of B4, B5 and B6 (bf16, D <= 128) their registers at
   launch, spills (the run fails on any) and shared memory a block; the
   run also fails on a spill in B7/B8's or B1's source.
3. kernel check: each kernel's wrapper runs on the card at the shapes the
   main paths give it (plus ragged ones; B1 on both its routes, with its
   route, rows a tile and shared memory printed, also at ragged store
   edges, at plans its rule sends to the pixel route and at two composed
   chains; B4 also at the batcher's admission prefill buckets, 8x1024 and
   1x16; B7/B8 also with f32 pools, a GQA pool and D 32) and is held
   against its plain PyTorch version on the same inputs; kernel, plain
   and library times (CUDA events) are printed beside the least time the
   card could take and the achieved TFLOP/s (B1, B2, B3, B4 and B6 from
   calls queued behind a spin: the device alone, with the back-to-back
   time beside it).
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
4b. JPEG path: the port's JPEG decoder (libjpeg where its headers exist,
   else nvJPEG from the CUDA toolkit; the run fails without one) holds
   each committed fixture of tests/jpeg_fixtures/ (bench.py's recipe:
   uniform noise, quality 85) against its libjpeg digest — byte-exact on
   libjpeg; on nvJPEG, whose planes C2 upsamples and converts with
   libjpeg's arithmetic, within a sample mean abs difference of 0.089
   levels and 0.0077 a channel (its max difference and share of
   differing values printed); the run fails on another backend.  Then
   `ImageFeaturizer.transform` with phase 4's ResNet-50 over a bytes
   column of 192 JPEGs, 64 per size (phase 4's three shape groups): B1
   launches once per chunk, C2 once per JPEG, nothing else; the features
   are (192,
   2048), finite, within 1e-3 relative L2 of phase 4's uint8 path on the
   same decoded pixels and within 3e-2 of an f32 CPU run of the port on
   12 rows; images/s over 3 runs, bytes and uint8 in turns, with the
   feed's stall_decode_s / transfer_s / compute_s.
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
7. decode serving: `ContinuousBatcher(paged=True)` (64-row pages).
   (a) f32 at GPT-small width with 2 layers, 4 slots, 8 requests of
   16..900-token prompts and 32 new tokens plus 2 over a registered
   256-token prefix, with plain and int8 pools, and the same requests over
   HTTP (`read_stream().continuous_server().generate_stream()`, 4
   concurrent clients): every stream equals `generate()` on the card (a
   mismatch passes only as a tie: top-2 logit gap under 1e-4).  With
   int8 pools the two shared-prefix requests are held against
   `generate`'s machinery with the prefix prefilled alone and the suffix
   fed one step at a time: their suffix attends over the quantized
   prefix rows, where `generate`'s single prefill does not quantize
   (tests/test_torch_batcher.py holds these streams against the JAX
   package's own paged int8 batcher on the CPU).
   (b) the serving configuration: the GPT-small LM of phase 6 (bf16),
   8 slots, the default 129-page pool, 16 requests of 16..900-token
   prompts and 64 new tokens, with bf16 pools (B7) and int8 pools (B8):
   the paged kernel launches exactly 12 times per tick, B4 12 times per
   admission prefill, B1 never; B4's output on every admission prefill
   against its plain version on that launch's own q/k/v; stream lengths,
   first tokens against the prefill's argmax, and teacher-forced
   agreement; B7/B8 against their plain versions on one tick's live
   pools (their recorded times queued behind a spin, beside the
   back-to-back time and the times at chunks of half and twice the
   rule's rows on the same inputs);
   tokens/s, ms per tick and the kernels' share over 3 rounds each.
   Streams are read with a deadline, so a dead batcher loop fails the run
   instead of hanging it.
8. training (the flash backward, B5/B6, is checked in phase 3 against its
   plain version and, through `fused_attention`'s autograd, against
   autograd through `full_attention`, at the LM train layer, a ViT-B/16
   chunk, a ragged f32, a D 32 and a D 128 shape; kernel, plain and SDPA
   backward times beside the bound):
   (a) GPT-small LM training at `bench.py` `_measure_transformer`'s shape
   (vocab 8192, embed 768, 12 layers, 12 heads, max_len 1024, bf16
   compute over f32 state, Adam 3e-4, batch 16, seq 1024): one warm-up
   and 8 timed steps of `make_lm_train_epoch` on one repeated batch; B4,
   B5 and B6 launch exactly 12 times a step; every loss finite and the
   last below the first; every parameter's first-step gradient against
   the same step through `full_attention`; a 2-layer f32 step on the card
   against the same step on the CPU; ms a step, tokens/s, the profiler's
   kernel ms a step with the B4/B5/B6 shares, peak memory, FLOPs a step
   and MFU.
   (b) ResNet-18 CIFAR training at `_measure_train`'s shape (bf16, SGD
   0.1 / 0.9, batch 256, 40 steps of `make_train_epoch` on device data
   from a seed): samples/s; finite losses; no ported kernel launches.
   (c) `DeepVisionClassifier(resnet18).fit` on 2,048 uint8 32x32 images
   of 10 classes learnable from their colours, batch 256, 2 epochs, then
   `DeepVisionModel.transform`: B1 launches once a step and once a
   scoring chunk, exactly; the loss falls; accuracy on the table.
10. image stages and compressed wire (after phase 8, before the record),
   on phase 4's table:
   (a) `Pipeline([ImageTransformer().resize(256, 256).center_crop(224,
   224).blur(2.0, 2.0).flip(), UnrollImage(output_col="features",
   mean/std ImageNet BGR), TorchModel(zoo ResNet-50, fetch_node="pool",
   batch_size=64)])` — example 19's chain at the featurizer's size, the
   ImageNet eval crop: B1 launches exactly 3 times (one per input shape
   group), B2 once (one 224x224 group), nothing else; the kernel rows
   against the `fuse=False` composition on the card within 1 LSB (the
   share of differing pixel values printed); the UnrollImage vectors
   within 1e-6 of B2's plain version; the pooled features finite, (192,
   2048), and within 3e-2 relative L2 of an f32 CPU run of the whole
   pipeline on 4 images (random-BatchNorm weights, as phase 4); images/s
   over 3 runs and the B1 / B2 / rest shares of the profiler's kernel time.
   (b) B2 against its plain version at (192, 224, 224, 3) f32 (timed,
   beside its bound and a stock-op composition) and at a ragged (5, 37,
   53, 1) and (3, 24, 24, 3) with a length-1 mean.
   (c) `DeviceFeed.put_group([rle_encode(c)])` over `tools/feed_bench.py`'s
   default chunks (16 chunks of 16 images, side 224, flat gray 8-pixel
   blocks, seed 0): B3 launches exactly 16 times, every decoded chunk
   equals its raw chunk byte for byte and its f32 mean the plain `put`
   path's; the wire ratio and the host's encode time.  B3 exact to the
   byte on phase 4's 64 uniform-random 224x224 images as one chunk (the
   worst case) and on the JAX package's codec test cases; timed at a
   feed_bench chunk and at the worst case beside its bound (the bytes of
   the runs the chunk needs and of the output) and
   `torch.repeat_interleave`.
11. resumable training and C2 (after phase 10; cuDNN's deterministic
   algorithms from here, cuBLAS's `:4096:8` workspace set at the top):
   (a) ResNet-18 CIFAR (bf16, SGD 0.1 / 0.9, batch 256, 40 steps over 2
   epochs of 5,120 images) through `fit_epochs_resumable` with a
   checkpoint every 10 steps, killed by `fault_point("training.step")`
   at step 25 and resumed: every number of the state equal to the
   uninterrupted run's, bit for bit; a guard drill (`training.loss_nan`
   at step 5: quarantined, rolled back to the floor checkpoint, a finite
   final loss, `quarantine.json` holding the step); the checkpoint's
   bytes and save / restore / verify seconds.
   (b) `DeepVisionClassifier(resnet18, 224x224, batch 64)` on a bytes
   column of the six bench fixtures repeated to 256 rows: 2 epochs, then
   1 and 2 on one `checkpoint_dir`, the resumed fit equal to the
   uninterrupted one bit for bit; B1 once a step and C2 once a row,
   exactly.
   (c) C2 against its plain version, byte for byte, on every colour
   fixture's nvJPEG planes and against the decoder's own pixels; timed
   at one image of each size.
9. record: a `{"kernels": [...]}` JSON line (the eight TPU kernels and
   C2), the nvidia-smi line, and last the `{"ok": true, "device": ...}`
   line.

Imports nothing of JAX or of the JAX package, and no PIL itself (phase
11 (b) resizes through the port, which uses PIL as the JAX package
does): the images, tokens and weights are made from seeds, the JPEGs
are the committed fixtures.
"""
import json
import re
import math
import os
import subprocess
import sys
import time

# phase 11 compares training runs bit for bit: cuBLAS takes a fixed
# workspace (its deterministic setting) before torch initialises it
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

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

# the flash backward (B5/B6) vs its plain version: f32 inputs at f32
# rounding; bf16 inputs round p and ds to bf16 at the same points on both
# sides, but the kernel's p differs in its last f32 bits (exp2, another
# summation order), which can move an element's rounding by one bf16 step
BWD_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
# ... and each output within this relative L2 of the plain version's: the
# max-abs limit is set by the few large entries near the first keys, so a
# kernel off by ~10% on later tiles would pass it alone (observed rel_l2
# ~5e-5 at the LM shape)
BWD_RTOL = 1e-3
# fused_attention's gradients against autograd through full_attention:
# f32 within the JAX package's off-TPU GRAD_TOL; bf16 as relative L2, the
# forwards differing by B4's bf16 rounding of P (unnormalised against
# normalised), under the JAX package's on-chip bf16 GRAD_TOL, 7.5e-2
AUTOGRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the LM train step: every parameter's first-step gradient through the
# kernels against the one through full_attention, relative L2 (bf16 both)
TRAIN_GRAD_RTOL = 5e-2
# a 2-layer f32 LM step on the card against the same step on the CPU
TRAIN_CPU_LOSS_RTOL = 1e-5
TRAIN_CPU_GRAD_RTOL = 1e-4

TIMED_RUNS = 5

# the JPEG path (phase 4b): its features against phase 4's uint8 path on
# the same decoded pixels (the same forward, so only cuDNN's choice of
# algorithm between two calls can differ); nvJPEG against the libjpeg
# digests: with the C2 kernel upsampling and converting nvJPEG's planes by
# libjpeg's arithmetic, only nvJPEG's IDCT differs from libjpeg's, which
# on the fixtures' uniform noise gave a mean absolute difference of
# 0.030-0.059 levels on the digests' pixel sample (max 3) and at most
# 0.0051 a channel on an H100 machine; the limits are 1.5x the worst of
# those (nvJPEG's own chroma path gave 13.1-13.5 and 0.46-0.50)
JPEG_UINT8_RTOL = 1e-3
NVJPEG_SAMPLE_MEAN_ABS = 0.089
NVJPEG_CHANNEL_MEAN = 0.0077

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

# decode serving (phase 7): the paged page size of the JAX package's
# serving default, and the f32 exactness configuration (GPT-small width,
# 2 layers) beside the bf16 serving one (chip_smoke's LM at 12 layers)
PAGE = 64
PAGED_ATOL = 1e-4        # B7/B8 vs plain: both f32 from the same stored values
TIE_GAP = 1e-4           # a token mismatch is a tie only below this top-2 gap
EXACT_LM = dict(LM, num_layers=2)
EXACT_SLOTS, EXACT_REQUESTS, EXACT_NEW, PREFIX_LEN = 4, 8, 32, 256
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW = 8, 16, 64
STREAM_WAIT_S = 300      # no token for this long fails the run, never hangs it
# the paged kernels' names in a profile: B7's and B8's split and merge
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_merge_kernel")

# training (phase 8): bench.py `_measure_transformer` (bench.py:515-549)
# and `_measure_train` (bench.py:129-169)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 16, 1024, 8, 3e-4
CIFAR_BATCH, CIFAR_STEPS = 256, 40
DV_ROWS, DV_CLASSES, DV_BATCH, DV_EPOCHS = 2048, 10, 256, 2
# resumable training (phase 11): the CIFAR configuration through
# fit_epochs_resumable, checkpoints every 10 steps, killed at step 25;
# DeepVisionClassifier at 224x224 on a bytes column of the JPEG fixtures
RESUME_EVERY, RESUME_KILL_AT, RESUME_NAN_AT = 10, 25, 5
DVJ_ROWS, DVJ_BATCH = 256, 64


# image stages and the compressed wire (phase 10): UnrollImage's B2
# against its plain version at the JAX package's own limit (both round
# the same two f32 ops); `tools/feed_bench.py`'s default chunks
UNROLL_ATOL = 1e-6
RLE_CHUNKS, RLE_CHUNK, RLE_SIDE = 16, 16, 224
# timing of B2/B3 (queued_ms): ~10 ms of spin at the H100's ~1.98 GHz
# boost clock, and the idle lead of phase 10's profiled run
SPIN_CYCLES = 20_000_000
PROFILE_LEAD_S = 0.5

# every kernel's wrapper counter, by the name the record line gives it
KERNELS = ("affine_resample", "flash_attention_fwd", "paged_decode_attention",
           "paged_decode_attention_int8", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dq", "fused_normalize_unroll", "rle_decode",
           "ycc_to_bgr")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (C2's counter lives in the
    decoder library)."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.ops import image_kernels as K
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

    K.LAUNCHES = A.LAUNCHES = PA.LAUNCHES = PA.LAUNCHES_INT8 = 0
    A.LAUNCHES_BWD_DKDV = A.LAUNCHES_BWD_DQ = 0
    K.LAUNCHES_UNROLL = W.LAUNCHES = 0
    native.reset_ycc_launches()


def read_launches() -> dict:
    """{kernel name: launches since zero_launches()}."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.ops import image_kernels as K
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

    return dict(zip(KERNELS, (K.LAUNCHES, A.LAUNCHES, PA.LAUNCHES,
                              PA.LAUNCHES_INT8, A.LAUNCHES_BWD_DKDV,
                              A.LAUNCHES_BWD_DQ, K.LAUNCHES_UNROLL,
                              W.LAUNCHES, native.ycc_launches())))


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


def check_resample(K, shape, dtype, seed, out_hw=(IMG, IMG), plan=None,
                   timed=True):
    """B1 on both routes against its plain version at one shape: the
    rule's route (`plan.tiling`) through the wrapper, and the pixel route
    on the same inputs; resized to out_hw and normalised with the
    ImageNet BGR mean/std, or by `plan`.  With `timed`, the kernel's time
    queued behind a spin (the record), back to back, and the pixel
    route's, beside the plain version, the library call and the bound."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == "uint8":
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
    else:
        x = torch.rand(shape, device="cuda", generator=gen) * 255.0
    c = shape[3]
    mean, std = (MEAN_BGR * 2)[:c], (STD_BGR * 2)[:c]  # an RGBA's 4th too
    resize = plan is None
    if resize:
        plan = K.resize_plan(shape[1], shape[2], c, *out_hw, mean, std)
    ty, span = plan.tiling(x.dtype, shape[0])
    route = f"tile TY {ty} span {span}" if ty else "pixel"
    if ty:
        smem = plan.tile_smem(span, x.element_size(), ty)
        c_smem = K._kernel_lib().mmk_affine_resample_smem(
            plan.w_in, plan.c_in, x.element_size(), plan.w_out, plan.c_out,
            ty, plan.k_h, span)
        if c_smem != smem or smem > K.TILE_SMEM:
            fail(f"resample {shape}: the tile route's shared memory is "
                 f"{c_smem} B in the kernel, {smem} B by the plan's rule "
                 f"(limit {K.TILE_SMEM})")
        route += f" smem {smem} B"
    got = K.affine_resample(x, plan)
    pixel = K._launch(x, plan, 0, 0)
    ref = K.affine_resample_plain(x, plan)
    torch.cuda.synchronize()
    label = (f"affine_resample {dtype}{list(shape)} -> "
             f"{plan.h_out}x{plan.w_out}x{plan.c_out}")
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    pixel_err = float((pixel - ref).abs().max())
    if max(err, pixel_err) > ATOL:
        fail(f"{label}: kernel disagrees with plain version (max abs err "
             f"{err:.3e}, pixel route {pixel_err:.3e} > {ATOL})")
    if not timed:
        log(f"[kernel] {label} ({route}): max_abs_err={err:.3e}, pixel "
            f"route {pixel_err:.3e} (limit {ATOL})")
        return {"err": max(err, pixel_err)}
    mean_t = torch.tensor(mean, device="cuda").view(1, c, 1, 1)
    inv_t = 1.0 / torch.tensor(std, device="cuda").view(1, c, 1, 1)

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw,
                          mode="bilinear", align_corners=False, antialias=True)
        return (y - mean_t) * inv_t

    lib_err = float((library().permute(0, 2, 3, 1) - ref).abs().max())

    def call():
        return K.affine_resample(x, plan)

    b2b_ms = cuda_ms(call, 20)
    kernel_ms = queued_ms(call)
    pixel_ms = queued_ms(lambda: K._launch(x, plan, 0, 0))
    plain_ms = cuda_ms(lambda: K.affine_resample_plain(x, plan), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = resample_bound(plan, x)
    log(f"[kernel] {label} ({route}): max_abs_err={err:.3e}, pixel route "
        f"{pixel_err:.3e} (limit {ATOL}) kernel_ms={kernel_ms:.4f} (queued "
        f"behind a spin; back-to-back calls {b2b_ms:.4f}; the pixel route "
        f"queued {pixel_ms:.4f}) plain_ms={plain_ms:.4f} library_ms="
        f"{library_ms:.4f} (library agrees: {lib_err <= ATOL}, max_abs_err="
        f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": max(err, pixel_err), "ms": kernel_ms, "plain_ms": plain_ms,
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
    # the kernel's time is the device's, from calls queued behind a spin:
    # at ~0.06 ms a call the wrapper's host work (checks, allocations,
    # three tensor maps) can outlast the kernel in back-to-back calls,
    # whose time is logged beside it
    b2b_ms = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), 20)
    kernel_ms = queued_ms(lambda: A.flash_attention_fwd(q, k, v, causal))
    plain_ms = cuda_ms(lambda: A.flash_attention_fwd_plain(q, k, v, causal), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = attention_bound(shape, dtype, causal)
    b, s, h, d = shape
    tflops = (4.0 * b * h * s * s * d * ((s + 1) / (2 * s) if causal else 1.0)
              / (kernel_ms * 1e-3) / 1e12)
    log(f"[kernel] flash_attention_fwd {dtype}{list(shape)} "
        f"causal={causal}: max_abs_err={err:.3e} (limit {ATTN_ATOL[dtype]}) "
        f"lse_err={lse_err:.3e} (limit {LSE_ATOL}) kernel_ms={kernel_ms:.4f} "
        f"(queued behind a spin; back-to-back calls {b2b_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA, "
        f"max_abs_err vs plain {lib_err:.3e}) bound_ms={bound_ms:.4f} "
        f"({bound_by}) roofline_share={bound_ms / kernel_ms:.3f} "
        f"achieved {tflops:.1f} TFLOP/s")
    if err > ATTN_ATOL[dtype] or lse_err > LSE_ATOL:
        fail(f"attention {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e}, lse {lse_err:.3e})")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def attention_bwd_bound(shape, dtype: str, causal: bool, which: str
                        ) -> tuple:
    """(bound_ms, bound_by) of one flash-backward kernel: q, k, v and dO
    read once in their dtype, lse and delta (f32) read once, and its f32
    outputs (B5: dK and dV; B6: dQ) written once, at the HBM rate, against
    its operations on the visible (query, key) pairs — B5 8*D a pair (QK,
    dO V, P dO, dS Q), B6 6*D (QK, dO V, dS K) — at the peak rate of the
    inputs' type."""
    b, s, h, d = shape
    item = 2 if dtype == "bfloat16" else 4
    n_out = 2 if which == "dkdv" else 1
    nbytes = (4 * b * s * h * d * item + 2 * b * h * s * 4
              + n_out * b * s * h * d * 4)
    pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    ops = (8.0 if which == "dkdv" else 6.0) * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention_bwd(A, shape, dtype: str, causal: bool, seed: int,
                        timed: bool = False):
    """B5 and B6 against their plain versions on one shape's q, k, v, dO
    and the forward's lse and delta; `fused_attention`'s autograd
    gradients against autograd through `full_attention`; with `timed`,
    kernel, plain and SDPA-backward times (CUDA events) and the bounds.
    Returns {"dkdv": row, "dq": row}."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(tdt)
                   for _ in range(4))
    b, s, h, d = shape
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out).reshape(
        b * h, s).contiguous()
    got = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal) + (
        A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),)
    ref = A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal) + (
        A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal),)
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, g, r in zip(("dk", "dv", "dq"), got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"attention backward {shape}: bad {name} {tuple(g.shape)}")
        errs[name] = float((g - r).abs().max())
        # relative L2 over a norm of at least 1: a gradient that is ~0
        # (dK and dQ at S = 1) is held in absolute terms
        rels[name] = float((g - r).norm() / r.norm().clamp(min=1.0))
    del got, ref
    # autograd: fused_attention (B4 forward, B5/B6 backward) against
    # autograd through the dense full_attention, same inputs and dO
    grads = []
    for fn in (A.fused_attention, full_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, causal), leaves,
                                         do.float()))
    if dtype == "float32":
        ag_err = max(float((x - y).abs().max()) for x, y in zip(*grads))
    else:
        ag_err = max(float((x.float() - y.float()).norm() / y.float().norm())
                     for x, y in zip(*grads))
    del grads
    kind = "max_abs" if dtype == "float32" else "rel_l2"
    err = max(errs.values())
    log(f"[kernel] flash_attention_bwd {dtype}{list(shape)} causal={causal}: "
        f"B5 dk max_abs_err={errs['dk']:.3e} dv={errs['dv']:.3e}, B6 dq "
        f"max_abs_err={errs['dq']:.3e} (limit {BWD_ATOL[dtype]}); rel_l2 "
        f"dk={rels['dk']:.3e} dv={rels['dv']:.3e} dq={rels['dq']:.3e} "
        f"(limit {BWD_RTOL}); "
        f"fused_attention grads vs autograd through full_attention "
        f"{kind}={ag_err:.3e} (limit {AUTOGRAD_TOL[dtype]})")
    if err > BWD_ATOL[dtype] or max(rels.values()) > BWD_RTOL:
        fail(f"attention backward {shape}: kernels disagree with the plain "
             f"versions (max abs {errs}, rel_l2 {rels})")
    if ag_err > AUTOGRAD_TOL[dtype]:
        fail(f"attention backward {shape}: fused_attention's gradients "
             f"disagree with full_attention's ({kind} {ag_err:.3e})")
    rows = {"dkdv": {"err": max(errs["dk"], errs["dv"])},
            "dq": {"err": errs["dq"]}}
    if not timed:
        return rows
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    g_lib = do.transpose(1, 2)

    def library():
        # dQ, dK and dV together: the work of B5 and B6
        return torch.autograd.grad(lib_out, (qt, kt, vt), g_lib,
                                   retain_graph=True)

    library_ms = cuda_ms(library, 20)
    kernels = {
        "dkdv": (lambda: A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                    causal),
                 lambda: A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse,
                                                          delta, causal)),
        "dq": (lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                causal),
               lambda: A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      causal))}
    for which, (kern, plain) in kernels.items():
        # B6 on the device alone (queued behind a spin), as B4; B5 back to
        # back, as in its earlier records
        b2b_ms = cuda_ms(kern, 20)
        kernel_ms = queued_ms(kern) if which == "dq" else b2b_ms
        plain_ms = cuda_ms(plain, 5)
        bound_ms, bound_by = attention_bwd_bound(shape, dtype, causal, which)
        rows[which].update(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
        tflops = ((8.0 if which == "dkdv" else 6.0) * d * pairs
                  / (kernel_ms * 1e-3) / 1e12)
        timing = ("queued behind a spin; back-to-back calls "
                  f"{b2b_ms:.4f}" if which == "dq" else "back-to-back calls")
        log(f"[kernel] flash_attention_bwd_{which} {dtype}{list(shape)} "
            f"causal={causal}: kernel_ms={kernel_ms:.4f} ({timing}) plain_ms="
            f"{plain_ms:.4f} library_ms={library_ms:.4f} (the backward of "
            f"SDPA: dQ, dK and dV together) bound_ms={bound_ms:.4f} "
            f"({bound_by}) roofline_share={bound_ms / kernel_ms:.3f} "
            f"achieved {tflops:.1f} TFLOP/s")
    del lib_out, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


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


def device_events_us(prof, names, copies: bool):
    """(device us, {name: (us, count) of the kernels whose name holds
    it}) summed over a profile's raw device events; copies and memsets
    only with `copies`."""
    from torch.autograd import DeviceType

    total_us = 0.0
    by_name = {n: [0.0, 0] for n in names}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or (
                not copies and ev.name.startswith(("Memcpy", "Memset"))):
            continue
        us = ev.time_range.elapsed_us()
        total_us += us
        for n in names:
            if n in ev.name:
                by_name[n][0] += us
                by_name[n][1] += 1
    return total_us, by_name


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one fn() call: CUDA events around `iters` calls that
    the host enqueues while a spin kernel (~10 ms) holds the card, so the
    card runs them back to back.  Plain back-to-back events (cuda_ms) also
    count the host's launch cost when a call's host work outlasts its
    kernels — a microsecond kernel behind a Python wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    spin_start = torch.cuda.Event(enable_timing=True)
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin_end.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin_start.elapsed_time(spin_end)
    if host_ms >= spin_ms:
        log(f"[timing] the host took {host_ms:.3f} ms to enqueue {iters} "
            f"calls, past the {spin_ms:.3f} ms spin: the time below "
            f"includes host gaps")
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def timed_transforms(featurizer, table, label, card, n_runs=TIMED_RUNS):
    """images/s on the host's clock, as a range over repeated runs (a run
    is tens of ms on a shared host), with the feed's split of the median;
    returns the median wall in seconds."""
    import torch
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY

    runs = []
    for _ in range(n_runs):
        torch.cuda.synchronize()
        before = FEED_TELEMETRY.snapshot()
        t0 = time.perf_counter()
        featurizer.transform(table)
        runs.append((time.perf_counter() - t0, FEED_TELEMETRY.delta(before)))
    runs.sort(key=lambda r: r[0])
    walls = [r[0] for r in runs]
    med_wall, med_feed = runs[len(runs) // 2]
    log(f"[{label}] ImageFeaturizer pool {IMG}x{IMG} batch {BATCH}, "
        f"{N_IMAGES} images, {n_runs} runs: images/s min "
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

    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[resnet] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks})")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks):
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


def jpeg_fixtures():
    """({file name: bytes}, digests) of tests/jpeg_fixtures/: JPEGs made by
    bench.py's recipe (uniform noise, quality 85) and the libjpeg digests
    of their pixels (make_jpeg_fixtures.py)."""
    d = os.path.join(ROOT, "tests", "jpeg_fixtures")
    with open(os.path.join(d, "digests.json")) as f:
        digests = json.load(f)
    blobs = {}
    for name in digests["fixtures"]:
        with open(os.path.join(d, name), "rb") as f:
            blobs[name] = f.read()
    return blobs, digests


def check_jpeg_decoder(native, blobs, digests):
    """Every fixture's pixels against its libjpeg digest: byte-exact on
    the libjpeg backend, within the stated difference on nvJPEG; returns
    {size: [decoded arrays of the bench fixtures of that size]}."""
    import base64
    import hashlib

    import numpy as np

    backend = native.jpeg_backend()
    stride = digests["sample_stride"]
    by_size = {}
    worst = {"max": 0, "mean": 0.0, "channel": 0.0}
    for name, want in sorted(digests["fixtures"].items()):
        t0 = time.perf_counter()
        got = native.decode_jpeg_bgr(blobs[name])
        dt_ms = (time.perf_counter() - t0) * 1e3
        if want is None:  # CMYK: the decoder refuses it (PIL decodes it)
            if got is not None:
                fail(f"jpeg {name}: decoded a stream libjpeg refuses")
            log(f"[jpeg] {name}: refused, as libjpeg refuses it")
            continue
        if got is None or list(got.shape) != want["shape"]:
            fail(f"jpeg {name}: decoded {None if got is None else got.shape}"
                 f", digest {want['shape']}")
        exact = hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        sample = np.frombuffer(base64.b64decode(want["sample"]), np.uint8)
        diff = np.abs(got[::stride, ::stride].astype(np.int16).ravel()
                      - sample.astype(np.int16))
        channel = ((got.reshape(-1, got.shape[2]).sum(0, np.int64)
                    - np.array(want["channel_sums"])) / got[..., 0].size)
        log(f"[jpeg] {name} {tuple(got.shape)} by {backend} in {dt_ms:.2f} ms"
            f": sha256 equals libjpeg's: {exact}; on the every-{stride}th-"
            f"pixel sample max abs diff {int(diff.max())}, share differing "
            f"{float(np.mean(diff > 0)):.4f}, mean abs diff "
            f"{float(diff.mean()):.4f} (limit {NVJPEG_SAMPLE_MEAN_ABS}); "
            f"channel mean diff {np.round(channel, 4).tolist()} (limit "
            f"{NVJPEG_CHANNEL_MEAN})")
        worst = {"max": max(worst["max"], int(diff.max())),
                 "mean": max(worst["mean"], float(diff.mean())),
                 "channel": max(worst["channel"],
                                float(np.abs(channel).max()))}
        if backend == "libjpeg" and not exact:
            fail(f"jpeg {name}: libjpeg pixels differ from the digest")
        if diff.mean() > NVJPEG_SAMPLE_MEAN_ABS or \
                np.abs(channel).max() > NVJPEG_CHANNEL_MEAN:
            fail(f"jpeg {name}: the decoder is past its stated difference")
        if name.startswith("bench_"):
            by_size.setdefault(tuple(want["shape"][:2]), []).append(got)
    log(f"[jpeg] worst over the fixtures by {backend}: max abs diff "
        f"{worst['max']}, sample mean abs diff {worst['mean']:.4f}, channel "
        f"mean diff {worst['channel']:.4f}")
    return by_size


def jpeg_path(repo, n_chunks, card):
    """Phase 4b; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table, native
    from mmlspark_tpu_torch.io.pipeline import PIPELINE_TELEMETRY
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet

    t0 = time.perf_counter()
    if not native.jpeg_available():
        fail(f"no JPEG decoder on the card's machine: {native.build_error()}")
    if native.jpeg_backend() != "nvjpeg":
        fail(f"the decoder built on {native.jpeg_backend()}: the C2 kernel "
             "is the nvJPEG backend's")
    log(f"[jpeg] decoder: {native.jpeg_backend()}, ready in "
        f"{time.perf_counter() - t0:.2f} s")
    blobs, digests = jpeg_fixtures()
    decoded = check_jpeg_decoder(native, blobs, digests)
    by_size = {hw: [n for n in sorted(blobs) if n.startswith("bench_") and
                    n.endswith(f"_{hw[0]}x{hw[1]}.jpg")] for hw in SIZES}
    # phase 4's three shape groups, 64 rows each, the two fixtures of a
    # size in turns; beside it the same decoded pixels as uint8 arrays
    column = [blobs[by_size[SIZES[i % 3]][(i // 3) % 2]]
              for i in range(N_IMAGES)]
    pixels = [decoded[SIZES[i % 3]][(i // 3) % 2] for i in range(N_IMAGES)]
    table = Table({"image": column, "id": np.arange(N_IMAGES)})
    pixel_table = Table({"image": pixels, "id": np.arange(N_IMAGES)})

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[jpeg] bytes column of {N_IMAGES} JPEGs: transform {first_s:.3f} "
        f"s; launches {launches} (chunks={n_chunks})")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks,
                        ycc_to_bgr=N_IMAGES):
        fail(f"the JPEG path launched the kernels {launches} times, "
             f"expected affine_resample once per chunk ({n_chunks}) and "
             f"ycc_to_bgr once per JPEG ({N_IMAGES})")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"JPEG features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("the JPEG path changed the row order")
    uint8_feats = featurizer.transform(pixel_table)["features"]
    err_uint8 = rel_l2(feats, uint8_feats)
    log(f"[jpeg] features vs phase 4's uint8 path on the same decoded "
        f"pixels: rel_l2={err_uint8:.3e} (bound {JPEG_UINT8_RTOL})")
    if err_uint8 > JPEG_UINT8_RTOL:
        fail("the JPEG path disagrees with the uint8 path on its pixels")

    # bf16 on the card against an f32 CPU run of the port (both decode
    # with the same decoder), random-BatchNorm weights as in phase 4
    few = [i for s in range(len(SIZES)) for i in range(s, 12, len(SIZES))]
    few_table = Table({"image": [column[i] for i in few]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        side[dev] = ImageFeaturizer(bundle=check_bundle, batch_size=BATCH,
                                    device=dev).transform(few_table)["features"]
    err_cpu = rel_l2(side["cuda"], side["cpu"])
    log(f"[jpeg] features (random-BatchNorm ResNet-50, bf16 on the card) vs "
        f"an f32 CPU run of {len(few)} JPEGs: rel_l2={err_cpu:.3e} (bound "
        f"{CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("JPEG features disagree with the f32 CPU run")

    # images/s, the JPEG bytes and phase 4's uint8 path on the same
    # pixels in turns, with the decode workers' busy time
    before = PIPELINE_TELEMETRY.snapshot()
    walls = {}
    for label, t in (("jpeg bytes", table), ("jpeg uint8", pixel_table),
                     ("jpeg bytes", table), ("jpeg uint8", pixel_table)):
        walls.setdefault(label, []).append(
            timed_transforms(featurizer, t, label, card, n_runs=3))
    busy = PIPELINE_TELEMETRY.delta(before).get("assemble", {})
    log(f"[jpeg] median walls: bytes {walls['jpeg bytes']} s, uint8 "
        f"{walls['jpeg uint8']} s; the assembly workers (decode for the "
        f"bytes, stacking for uint8) busy {busy.get('busy_s', 0.0):.4f} s "
        f"over {busy.get('items', 0.0):.0f} chunks in the 12 runs")
    del featurizer
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

    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[vit] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks}, layers={layers})")
    want = dict(NO_LAUNCHES, affine_resample=n_chunks,
                flash_attention_fwd=layers * n_chunks)
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

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.generate(bundle, prompt, LM_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[lm] first generate (batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_NEW} new tokens) {first_s:.3f} s; launches {launches}")
    want = dict(NO_LAUNCHES, flash_attention_fwd=LM["num_layers"])
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


def paged_inputs(b, h, hkv, d, page, mp, dtype, positions, seed, n_pages=None):
    """q and K/V pools full of random values (the trash page 0 included);
    slot i owns distinct pages for its live positions 0..positions[i], the
    rest of its table row is 0."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = [p // page + 1 for p in positions]
    n_pages = n_pages or 1 + sum(live)
    q = torch.randn((b, h, d), device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn((n_pages, page, hkv, d), device="cuda",
                        generator=gen).to(dtype) for _ in range(2))
    table = np.zeros((b, mp), np.int32)
    order = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    nxt = 0
    for i, n in enumerate(live):
        table[i, :n] = order[nxt:nxt + n]
        nxt += n
    return (q, k, v, torch.from_numpy(table).cuda(),
            torch.tensor(positions, dtype=torch.int32, device="cuda"))


def paged_bound(q, pools, pos, int8: bool) -> tuple:
    """(bound_ms, bound_by) of one paged decode attention: each live K/V
    row read once (sum_b (pos_b + 1) * Hkv * D * itemsize * 2, plus the
    f32 scales for B8), q read and the f32 output written once, at the HBM
    rate; against 4 * sum_b (pos_b + 1) * H * D operations (QK and PV) at
    the f32 rate (the kernels use FMAs, no tensor cores)."""
    rows = int((pos.long() + 1).sum())
    _np, _page, hkv, d = pools[0].shape
    h = q.shape[1]
    nbytes = rows * hkv * d * pools[0].element_size() * 2
    if int8:
        nbytes += rows * hkv * 4 * 2
    nbytes += q.numel() * q.element_size() + q.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * rows * h * d / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_paged(PA, label, q, pools, table, pos, timed: bool):
    """B7 (pools (k, v)) or B8 (pools (kq, ks, vq, vs)) against its plain
    version on the same inputs; with `timed`, kernel, plain and library
    times (CUDA events) and the bound."""
    import torch
    import torch.nn.functional as F

    int8 = len(pools) == 4
    kernel = PA.paged_decode_attention_int8 if int8 else \
        PA.paged_decode_attention
    plain = PA.paged_decode_attention_int8_plain if int8 else \
        PA.paged_decode_attention_plain
    got = kernel(q, *pools, table, pos)
    ref = plain(q, *pools, table, pos)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    b, h, d = q.shape
    np_, page, hkv, _ = pools[0].shape
    shape = (f"q{list(q.shape)} {str(q.dtype)[6:]} pools{list(pools[0].shape)}"
             f" {str(pools[0].dtype)[6:]} MP {table.shape[1]} pos "
             f"{pos.min().item()}..{pos.max().item()}")
    if err > PAGED_ATOL:
        fail(f"{label} {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e} > {PAGED_ATOL})")
    if not timed:
        log(f"[kernel] {label} {shape}: max_abs_err={err:.3e} "
            f"(limit {PAGED_ATOL})")
        return {"err": err}
    mp = table.shape[1]
    mask = (torch.arange(mp * page, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    idx = table.long()

    def library():
        # the gather and SDPA (B8: and the dequantization) as separate calls
        if int8:
            kq, ks, vq, vs = (t[idx] for t in pools)
            k_log = (kq.to(q.dtype) * ks[..., None].to(q.dtype))
            v_log = (vq.to(q.dtype) * vs[..., None].to(q.dtype))
        else:
            k_log, v_log = (t[idx] for t in pools)
        k_log, v_log = (x.reshape(b, mp * page, hkv, d).transpose(1, 2)
                        .repeat_interleave(h // hkv, dim=1)
                        for x in (k_log, v_log))
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k_log, v_log, attn_mask=mask)

    lib_err = float((library()[:, :, 0].float() - ref).abs().max())

    def call():
        return kernel(q, *pools, table, pos)

    # the record is the device time (a call is two short kernels behind a
    # Python wrapper), the back-to-back time beside it
    b2b_ms = cuda_ms(call, 50)
    kernel_ms = queued_ms(call)
    plain_ms = cuda_ms(lambda: plain(q, *pools, table, pos), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = paged_bound(q, pools, pos, int8)
    calls = "gather+dequant+SDPA, 3 calls" if int8 else "gather+SDPA, 2 calls"
    log(f"[kernel] {label} {shape}: max_abs_err={err:.3e} (limit "
        f"{PAGED_ATOL}) kernel_ms={kernel_ms:.4f} (queued behind a spin; "
        f"back-to-back calls {b2b_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} ({calls}, max_abs_err vs plain "
        f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    # the chunk rule (PA.split_pages): the same inputs at half (in whole
    # pages) and twice the rule's rows
    sp = PA.split_pages(page, pools[0].dtype)
    for pages in sorted({max(1, sp // 2), 2 * sp} - {sp}):
        other, other_err = paged_chunk_call(PA, q, pools, table, pos, pages,
                                            ref)
        log(f"[kernel] {label}: chunks of {pages * page} rows in place of "
            f"the rule's {sp * page}: max_abs_err={other_err:.3e}, queued "
            f"behind a spin {queued_ms(other):.4f} ms; the rule's queued "
            f"again {queued_ms(call):.4f} ms")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def paged_chunk_call(PA, q, pools, table, pos, pages, ref):
    """(a call of the split kernels with chunks of `pages` pages through
    the wrapper's C entry, on these inputs; its largest error against
    `ref`): the chunk rule's alternative, timed beside it."""
    import torch

    lib = PA._kernel_lib()
    int8 = len(pools) == 4
    fn = lib.mmk_paged_attention_int8 if int8 else lib.mmk_paged_attention
    b, h, d = q.shape
    _np, page, hkv, _d = pools[0].shape
    mp = table.shape[1]
    out = torch.empty((b, h, d), dtype=torch.float32, device="cuda")
    ws = torch.empty(b * h * -(-mp // pages) * (d + 2), dtype=torch.float32,
                     device="cuda")
    args = (q.data_ptr(), *(t.data_ptr() for t in pools), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, d, page, mp, pages,
            q.stride(0), q.stride(1), 1.0 / math.sqrt(d))

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"{fn.__name__} at {pages} pages a chunk: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    return call, float((out - ref).abs().max())


def paged_kernel_checks(PA):
    """Phase 3's B7/B8 cases: the serving shape (q [8, 12, 64] bf16, a
    129-page pool of 64-row pages, MP 16, positions from a seed with 0, 63,
    64 and 1023), f32 pools, a GQA pool (Hkv 4), D 32 with 16-row pages,
    and B8 over int8 pools from quantize_kv_row; returns {kernel: its
    largest error}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.quant import quantize_kv_row

    rng = np.random.default_rng(30)
    main_pos = [0, 63, 64, 1023] + rng.integers(0, 1024, 4).tolist()
    cases = [("main", 8, 12, 12, 64, PAGE, 16, torch.bfloat16, main_pos, 129),
             ("f32", 8, 12, 12, 64, PAGE, 16, torch.float32, main_pos, 129),
             ("gqa", 8, 12, 4, 64, PAGE, 16, torch.bfloat16, main_pos, 129),
             ("d32", 5, 4, 4, 32, 16, 8, torch.float32,
              [0, 15, 16, 127, 77], None)]
    errs = {"paged_decode_attention": 0.0, "paged_decode_attention_int8": 0.0}
    for name, b, h, hkv, d, page, mp, dtype, positions, n_pages in cases:
        q, k, v, table, pos = paged_inputs(b, h, hkv, d, page, mp, dtype,
                                           positions, seed=31, n_pages=n_pages)
        kq, ks = quantize_kv_row(k)
        vq, vs = quantize_kv_row(v)
        for key, pools in (("paged_decode_attention", (k, v)),
                           ("paged_decode_attention_int8", (kq, ks, vq, vs))):
            err = check_paged(PA, f"{key}[{name}]", q, pools, table, pos,
                              timed=False)["err"]
            errs[key] = max(errs[key], err)
    return errs


def _prefill_then_steps(module, prompt, split, kv_cache_dtype):
    """`generate`'s machinery: prefill prompt[:split], then one decode
    step per remaining prompt token; returns (next logits, cache, pos)."""
    import torch
    from mmlspark_tpu_torch.models import generation as G

    p = torch.as_tensor(prompt[:split], dtype=torch.int32, device="cuda")
    logits, cache = G._prefill_cache(module, p[None], kv_cache_dtype)
    cur, pos = logits[0, -1], split
    for t in prompt[split:]:
        cur, cache, pos = _step(module, int(t), cache, pos)
    return cur, cache, pos


def _step(module, tok, cache, pos):
    import torch

    lg, cache = module.decode_step(
        torch.tensor([[tok]], dtype=torch.int32, device="cuda"), cache, pos)
    return lg[0, 0], cache, pos + 1


def step_logits(module, prompt, toks, kv_cache_dtype, split=None):
    """The logits the reference reads before emitting toks[len(toks)]:
    `generate`'s prefill over the prompt (over prompt[:split] and then one
    decode step per remaining prompt token, with `split`), then one
    decode step per token of `toks`."""
    import torch

    with torch.inference_mode():
        cur, cache, pos = _prefill_then_steps(
            module, prompt, split or len(prompt), kv_cache_dtype)
        for t in toks:
            cur, cache, pos = _step(module, t, cache, pos)
    return cur


def split_generate(module, prompt, split, n, kv_cache_dtype):
    """Greedy tokens of a shared-prefix request as the batcher computes
    it with int8 pools: the prefix prefilled on its own, and the suffix
    attending over the QUANTIZED prefix rows (the JAX package's
    semantics; `generate`'s one prefill attends over them unquantized),
    fed here one decode step per token."""
    import torch

    toks = []
    with torch.inference_mode():
        cur, cache, pos = _prefill_then_steps(module, prompt, split,
                                              kv_cache_dtype)
        for i in range(n):
            toks.append(int(cur.argmax()))
            if i < n - 1:
                cur, cache, pos = _step(module, toks[-1], cache, pos)
    return toks


def compare_streams(label, module, prompts, got, refs, kv_cache_dtype,
                    splits=None):
    """Each stream against its reference tokens (`generate`'s, or
    `split_generate`'s where `splits` gives the prefix length).  A
    mismatch is a tie (printed, not failed) only where the reference's
    top-2 logit gap at the first differing step is under TIE_GAP."""
    splits = splits or [None] * len(prompts)
    for i, (prompt, g, r) in enumerate(zip(prompts, got, refs)):
        if g == r:
            continue
        step = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b),
                    min(len(g), len(r)))
        if step >= len(r) or step >= len(g):
            fail(f"{label}: stream {i} has {len(g)} tokens, generate "
                 f"{len(r)}")
        top2 = step_logits(module, prompt, r[:step], kv_cache_dtype,
                           splits[i]).float().topk(2).values
        gap = float(top2[0] - top2[1])
        if gap >= TIE_GAP:
            fail(f"{label}: stream {i} (prompt {len(prompt)}) differs from "
                 f"generate at step {step} where the top-2 logit gap is "
                 f"{gap:.3e}")
        log(f"[serve] {label}: stream {i} ties generate at step {step} "
            f"(top-2 gap {gap:.2e} < {TIE_GAP})")
    log(f"[serve] {label}: {len(got)} streams of {len(got[0])} tokens equal "
        f"their references on the card (generate(); int8 shared-prefix "
        f"requests split_generate()), ties aside")


def batch_fill_count() -> int:
    """Ticks so far: one `serving.batcher.batch_fill` observation each."""
    from mmlspark_tpu_torch.core import telemetry

    return telemetry.histogram("serving.batcher.batch_fill").snapshot()["count"]


def serve_exactness(card):
    """Phase 7a: f32 paged serving at GPT-small width (2 layers), plain
    and int8 pools, with a shared prefix, and over HTTP: every stream
    equals `generate()` on the card."""
    import threading
    import http.client

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import read_stream
    from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

    bundle = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                         dtype="float32", seed=0)
    module = G._module_for(bundle, torch.device("cuda"))
    vocab = EXACT_LM["vocab_size"]
    rng = np.random.default_rng(1)
    lens = [16, 900] + rng.integers(16, 901, EXACT_REQUESTS - 2).tolist()
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prefix = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
    suffixes = [rng.integers(0, vocab, n).astype(np.int32) for n in (1, 100)]
    full = prompts + [np.concatenate([prefix, sfx]) for sfx in suffixes]
    refs = {}
    for kvd in (None, "int8"):
        label = f"f32 paged serving, {kvd or 'f32'} pools"
        refs[kvd] = [G.generate(bundle, p[None], EXACT_NEW,
                                kv_cache_dtype=kvd)[0, len(p):].cpu().tolist()
                     for p in full]
        # int8 pools: the shared-prefix requests' own semantics
        splits = [None] * len(prompts) + [PREFIX_LEN if kvd else None] * 2
        for i, split in enumerate(splits):
            if split is not None:
                refs[kvd][i] = split_generate(module, full[i], split,
                                              EXACT_NEW, kvd)
        batcher = ContinuousBatcher(bundle, max_slots=EXACT_SLOTS, paged=True,
                                    page_size=PAGE, kv_cache_dtype=kvd)
        handle = batcher.register_prefix(prefix)
        batcher.start()
        try:
            zero_launches()
            ticks0 = batch_fill_count()
            t0 = time.perf_counter()
            streams = ([batcher.submit(p, EXACT_NEW) for p in prompts]
                       + [batcher.submit(sfx, EXACT_NEW, prefix=handle)
                          for sfx in suffixes])
            got = [st.tokens(timeout=STREAM_WAIT_S) for st in streams]
            wall = time.perf_counter() - t0
            launches, ticks = read_launches(), batch_fill_count() - ticks0
        finally:
            batcher.stop()
        key = "paged_decode_attention_int8" if kvd else "paged_decode_attention"
        log(f"[serve] {label}: {len(full)} requests (prompts {min(lens)}.."
            f"{max(lens)}, one {PREFIX_LEN}-token shared prefix with 2 "
            f"suffixes), {EXACT_NEW} new tokens each, {EXACT_SLOTS} slots: "
            f"{wall:.3f} s, {ticks} ticks, launches {launches}")
        if launches[key] != EXACT_LM["num_layers"] * ticks or ticks == 0:
            fail(f"{label}: {key} launched {launches[key]} times in "
                 f"{ticks} ticks of {EXACT_LM['num_layers']} layers")
        compare_streams(label, module, full, got, refs[kvd], kvd, splits)

    # the same requests over HTTP, from 4 concurrent clients
    query = (read_stream()
             .continuous_server(name="lm", path="/lm")
             .parse_request(schema=["prompt"])
             .generate_stream(bundle, max_new_tokens=EXACT_NEW,
                              max_slots=EXACT_SLOTS, paged=True,
                              page_size=PAGE)
             .options(batch_timeout_ms=5.0)
             .start())
    results = [None] * len(full)
    errors = []

    def client(c):
        try:
            conn = http.client.HTTPConnection(
                query.service_info.host, query.service_info.port,
                timeout=STREAM_WAIT_S)
            for i in range(c, len(full), 4):
                conn.request("POST", "/lm", body=json.dumps(
                    {"prompt": full[i].tolist()}).encode())
                resp = conn.getresponse()
                body = resp.read().decode()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {body[:200]}")
                results[i] = [int(t) for t in body.split()]
            conn.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=STREAM_WAIT_S)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or errors:
            fail(f"HTTP clients failed or hung: {errors}")
    finally:
        query.stop()
    log(f"[serve] HTTP: {len(full)} requests from 4 concurrent clients "
        f"through read_stream().continuous_server().generate_stream("
        f"paged=True) in {wall:.3f} s")
    compare_streams("HTTP f32 paged serving", module, full, results,
                    refs[None], None)
    G._MODULES.clear()
    torch.cuda.empty_cache()


def serving_path(A, PA, card):
    """Phase 7b, the serving configuration: ContinuousBatcher, paged, over
    chip_smoke's GPT-small LM (12 layers, bf16), 8 slots, 64-row pages (the
    default 129-page pool), 16 requests of 16..900-token prompts and 64 new
    tokens; once with bf16 pools (B7) and once with int8 pools (B8).
    Returns ({kernel: launches}, {kernel: timing row from the live pools},
    B4's largest error on the admission prefills' own q/k/v)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import batcher as SB

    layers = LM["num_layers"]
    bundle = TorchBundle("transformer_lm", LM, input_shape=(16,), seed=0)
    module = G._module_for(bundle, torch.device("cuda"))
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 901, SERVE_REQUESTS)
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    total = {k: 0 for k in KERNELS}
    rows = {}
    flash_err = 0.0
    for kvd in (None, "int8"):
        key = "paged_decode_attention_int8" if kvd else "paged_decode_attention"
        label = f"serving {kvd or 'bf16'} pools"
        batcher = SB.ContinuousBatcher(bundle, max_slots=SERVE_SLOTS,
                                       paged=True, page_size=PAGE,
                                       kv_cache_dtype=kvd).start()
        # spies for the counted run: prefill forwards (with each row's
        # argmax), one tick's live attention inputs, pages in use per tick
        prefills, captured, pages_used, flash_checks = [], {}, [], []
        real_prefill, real_step = SB._prefill_kv, batcher._step
        real_kernel, real_flash = getattr(PA, key), A.flash_attention_fwd

        def prefill_spy(module_, toks, kv_cache_dtype=None):
            logits, kv = real_prefill(module_, toks, kv_cache_dtype)
            prefills.append((toks.cpu().numpy(),
                             logits.argmax(-1).cpu().numpy()))
            return logits, kv

        def step_spy(tok, pos, table):
            pages_used.append(batcher._np - 1 - len(batcher._free))
            return real_step(tok, pos, table)

        def kernel_spy(q, *rest):
            # layer 0 of the 40th tick: slots are full and recycled
            if "args" not in captured and len(pages_used) == 40:
                captured["args"] = tuple(t.clone() for t in (q, *rest))
            return real_kernel(q, *rest)

        def flash_spy(q, k, v, causal):
            # every admission prefill's B4 launch (its kp rows at its
            # bucket) held against the plain version on the same q/k/v
            out, lse = real_flash(q, k, v, causal)
            ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
            flash_checks.append((tuple(q.shape), float((out - ref).abs().max()),
                                 float((lse - ref_lse).abs().max())))
            return out, lse

        SB._prefill_kv, batcher._step = prefill_spy, step_spy
        setattr(PA, key, kernel_spy)
        A.flash_attention_fwd = flash_spy
        try:
            zero_launches()
            ticks0 = batch_fill_count()
            t0 = time.perf_counter()
            streams = [batcher.submit(p, SERVE_NEW) for p in prompts]
            got = [st.tokens(timeout=STREAM_WAIT_S) for st in streams]
            first_s = time.perf_counter() - t0
            launches, ticks = read_launches(), batch_fill_count() - ticks0
        finally:
            SB._prefill_kv = real_prefill
            batcher._step = real_step
            setattr(PA, key, real_kernel)
            A.flash_attention_fwd = real_flash
        want = dict(NO_LAUNCHES, flash_attention_fwd=layers * len(prefills))
        want[key] = layers * ticks
        log(f"[serve] {label}: {SERVE_REQUESTS} requests (prompts "
            f"{lens.min()}..{lens.max()}), {SERVE_NEW} new tokens each, "
            f"{SERVE_SLOTS} slots, 12 layers bf16: first round {first_s:.3f}"
            f" s, {ticks} ticks, {len(prefills)} admission prefill "
            f"forwards, launches {launches}")
        if launches != want or ticks == 0:
            fail(f"{label}: launches {launches}, expected {want} ({key} "
                 f"once per layer per tick, B4 once per layer per admission "
                 f"prefill, B1 never)")
        err = max(e for _s, e, _l in flash_checks)
        lse_err = max(e for _s, _e, e in flash_checks)
        log(f"[serve] {label}: B4 on its {len(flash_checks)} admission "
            f"prefill launches' own q/k/v (shapes "
            f"{sorted(set(s for s, _e, _l in flash_checks))}): max_abs_err="
            f"{err:.3e} (limit {ATTN_ATOL['bfloat16']}) lse_err={lse_err:.3e}"
            f" (limit {LSE_ATOL}) against the plain version")
        if err > ATTN_ATOL["bfloat16"] or lse_err > LSE_ATOL:
            fail(f"{label}: B4 disagrees with its plain version on an "
                 f"admission prefill (max abs err {err:.3e}, lse "
                 f"{lse_err:.3e})")
        flash_err = max(flash_err, err)
        if any(len(t) != SERVE_NEW for t in got) or \
                min(min(t) for t in got) < 0 or \
                max(max(t) for t in got) >= LM["vocab_size"]:
            fail(f"{label}: stream lengths {[len(t) for t in got]} or "
                 f"tokens outside the vocabulary")
        for i, (p, toks) in enumerate(zip(prompts, got)):
            hit = [am[r, len(p) - 1] for tk, am in prefills
                   for r in range(tk.shape[0])
                   if tk.shape[1] >= len(p) and (tk[r, :len(p)] == p).all()]
            if not hit or hit[0] != toks[0]:
                fail(f"{label}: stream {i}'s first token {toks[0]} is not "
                     f"the argmax of its prefill logits ({hit[:1]})")
        agree = []
        with torch.inference_mode():
            for p, toks in zip(prompts, got):
                seq = torch.as_tensor(np.concatenate([p, toks[:-1]]),
                                      device="cuda")[None]
                pred = module(seq)[0][0, len(p) - 1:].argmax(-1).cpu()
                agree.append(float((pred.numpy() == np.asarray(toks)).mean()))
        log(f"[serve] {label}: first tokens equal the argmax of their "
            f"prefill logits; teacher-forced agreement with a prefill "
            f"forward over prompt + tokens: mean {np.mean(agree):.4f}, min "
            f"{min(agree):.4f} (bf16, informational)")
        rows[key] = check_paged(PA, f"{key}[live pools, tick 40, layer 0]",
                                captured["args"][0], captured["args"][1:-2],
                                captured["args"][-2], captured["args"][-1],
                                timed=True)
        del captured
        pool_bytes = sum(t.numel() * t.element_size()
                         for layer in batcher._cache for t in layer)
        page_bytes = pool_bytes // batcher._np
        dense_bytes = (pool_bytes // batcher._np) * SERVE_SLOTS * \
            (LM["max_len"] // PAGE)
        log(f"[serve] {label}: KV pools {pool_bytes / 2**20:.1f} MiB for "
            f"{batcher._np} pages; dense max_slots x max_len cache "
            f"{dense_bytes / 2**20:.1f} MiB; pages in use at most "
            f"{max(pages_used)} = {max(pages_used) * page_bytes / 2**20:.1f} "
            f"MiB")
        walls, tick_counts = [], []
        for _ in range(3):
            ticks0 = batch_fill_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for st in [batcher.submit(p, SERVE_NEW) for p in prompts]:
                st.tokens(timeout=STREAM_WAIT_S)
            walls.append(time.perf_counter() - t0)
            tick_counts.append(batch_fill_count() - ticks0)
        tps = [SERVE_REQUESTS * SERVE_NEW / w for w in walls]
        host_ms = [w * 1e3 / n for w, n in zip(walls, tick_counts)]
        log(f"[serve] {label}: 3 rounds: {min(tps):.0f}..{max(tps):.0f} "
            f"tokens/s aggregate; {min(host_ms):.3f}..{max(host_ms):.3f} ms "
            f"per tick on the host clock (admission prefills included; "
            f"ticks {tick_counts}) on {card}")
        kern = []
        for _ in range(3):
            ticks0 = batch_fill_count()

            def one_round():
                for st in [batcher.submit(p, SERVE_NEW) for p in prompts]:
                    st.tokens(timeout=STREAM_WAIT_S)

            # B7's or B8's two kernels (split, merge)
            busy = profiled_kernel_ms(one_round, PAGED_KERNEL_NAMES
                                      + ("flash_fwd",))
            n = batch_fill_count() - ticks0
            if busy is not None:
                paged_ms = sum(busy[1][k] for k in PAGED_KERNEL_NAMES)
                kern.append((busy[0] / n, paged_ms / busy[0],
                             busy[1]["flash_fwd"] / busy[0], busy[2] / n))
        if kern:
            log(f"[serve] {label}: 3 profiled rounds: kernel time "
                f"{min(k[0] for k in kern):.3f}..{max(k[0] for k in kern):.3f}"
                f" ms per tick against {min(k[3] for k in kern):.3f}.."
                f"{max(k[3] for k in kern):.3f} ms of profiled wall per tick;"
                f" the paged kernel's share of kernel time "
                f"{min(k[1] for k in kern):.4f}..{max(k[1] for k in kern):.4f}"
                f", B4's {min(k[2] for k in kern):.4f}.."
                f"{max(k[2] for k in kern):.4f}")
        else:
            log(f"[serve] {label}: the profiler saw no device time "
                "(kernel time per tick not measured)")
        batcher.stop()
        for k in KERNELS:
            total[k] += launches[k]
        del batcher
        torch.cuda.empty_cache()
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return total, rows, flash_err


def lm_train_flops(batch, seq, e, layers, vocab, mlp=4) -> float:
    """FLOPs of one LM train step as tools/roofline.py `analyze_lm_train`
    counts them (a copy of its formula): the forward's matmuls — qkv,
    attention (4 B S^2 e, no causal halving), proj and the MLP per layer,
    and the LM head — times 3 for forward plus backward."""
    per_layer = (2.0 * batch * seq * e * 3 * e + 4.0 * batch * seq * seq * e
                 + 2.0 * batch * seq * e * e
                 + 4.0 * batch * seq * e * mlp * e)
    return 3.0 * (layers * per_layer + 2.0 * batch * seq * e * vocab)


def rel_err(a, b) -> float:
    """Relative L2 error of tensor a against tensor b, in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def lm_grads(module, toks):
    """{name: f32 gradient or None} of one next-token loss.backward()."""
    from mmlspark_tpu_torch.models.training import lm_loss

    logits, _taps = module(toks)
    lm_loss(logits, toks).backward()
    grads = {n: None if p.grad is None else p.grad.float()
             for n, p in module.named_parameters()}
    for p in module.parameters():
        p.grad = None
    return grads


def lm_train_path(card):
    """Phase 8a; returns {kernel: launches} of the counted run."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.bundle import get_builder, init_state_dict
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    cfg = dict(LM, max_len=TRAIN_SEQ)
    layers = cfg["num_layers"]
    builder = get_builder("transformer_lm")
    t0 = time.perf_counter()
    state = TR.init_train_state(builder(**cfg), TR.adam(TRAIN_LR), seed=0,
                                compute_dtype="bfloat16")
    n_params = sum(p.numel() for p in state.module.parameters())
    log(f"[train] GPT-small TransformerLM {cfg}, {n_params / 1e6:.1f} M f32 "
        f"parameters, bf16 working copy, Adam {TRAIN_LR}: ready in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ)).astype(
            np.int32)).cuda()

    # first-step gradients through the kernels against the same step
    # through full_attention, on the same weights and tokens (not counted)
    ref_module = builder(**cfg, attn_fn=functools.partial(full_attention,
                                                          causal=True))
    ref_module.load_state_dict(state.module.state_dict())
    ref_module = ref_module.to("cuda", torch.bfloat16)
    got = lm_grads(state.work, toks)
    ref = lm_grads(ref_module, toks)
    del ref_module
    missing = sorted(n for n, g in got.items() if g is None)
    if missing or sorted(got) != sorted(ref):
        fail(f"LM train step: parameters without a gradient: {missing}")
    rels = {n: rel_err(g, ref[n]) for n, g in got.items()}
    worst = max(rels, key=rels.get)
    log(f"[train] first-step gradients of all {len(rels)} parameters through "
        f"B4/B5/B6 vs through full_attention (bf16 both): worst rel_l2="
        f"{rels[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rels.values()))):.3e} (limit "
        f"{TRAIN_GRAD_RTOL})")
    if rels[worst] > TRAIN_GRAD_RTOL:
        fail(f"LM train step: {worst}'s gradient disagrees with the "
             f"full_attention step (rel_l2 {rels[worst]:.3e})")
    del got, ref
    torch.cuda.empty_cache()

    # a 2-layer f32 step on the card against the same step on the CPU
    small = dict(LM, num_layers=2, max_len=128)
    weights = {k: torch.from_numpy(v) for k, v in init_state_dict(
        builder(**small), seed=5).items()}
    small_toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, small["vocab_size"], (2, 128)).astype(np.int32))
    side = {}
    for dev in ("cuda", "cpu"):
        module = builder(**small)
        module.load_state_dict(weights)
        module = module.to(dev)
        logits, _taps = module(small_toks.to(dev))
        loss = TR.lm_loss(logits, small_toks.to(dev))
        loss.backward()
        side[dev] = (loss.item(), {n: p.grad.cpu() for n, p in
                                   module.named_parameters()})
    loss_rel = abs(side["cuda"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    grad_rel = max(rel_err(g, side["cpu"][1][n])
                   for n, g in side["cuda"][1].items())
    log(f"[train] 2-layer f32 LM step (batch 2 x 128) on the card vs the "
        f"CPU: loss rel {loss_rel:.3e} (limit {TRAIN_CPU_LOSS_RTOL}), worst "
        f"gradient rel_l2 {grad_rel:.3e} (limit {TRAIN_CPU_GRAD_RTOL})")
    if loss_rel > TRAIN_CPU_LOSS_RTOL or grad_rel > TRAIN_CPU_GRAD_RTOL:
        fail("the f32 LM step on the card disagrees with the CPU's")
    del side

    # the counted run: one warm-up step and TRAIN_STEPS timed steps of
    # make_lm_train_epoch on one repeated batch
    epoch = TR.make_lm_train_epoch()
    batch = toks[None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state, loss0 = epoch(state, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses, step_s = [loss0], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = epoch(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = TRAIN_STEPS + 1
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * steps,
                flash_attention_bwd_dkdv=layers * steps,
                flash_attention_bwd_dq=layers * steps)
    losses = torch.cat(losses).cpu().numpy()
    log(f"[train] {steps} steps (1 warm-up, {warm_s * 1e3:.1f} ms): launches "
        f"{launches}; losses {np.array2string(losses, precision=4)}")
    if launches != want:
        fail(f"the LM train path launched the kernels {launches} times, "
             f"expected {want} (B4, B5 and B6 once per layer per step)")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        fail(f"LM train losses not finite or not falling: {losses}")
    med = float(np.median(step_s))
    flops = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, cfg["embed_dim"], layers,
                           cfg["vocab_size"])
    log(f"[train] LM step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, fwd + bwd + "
        f"Adam, CUDA-synchronised host clock): {min(step_s) * 1e3:.3f}.."
        f"{max(step_s) * 1e3:.3f} ms over {TRAIN_STEPS} steps, median "
        f"{med * 1e3:.3f} ms = {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; "
        f"{flops / 1e12:.3f} TFLOP a step (tools/roofline.py's count) = "
        f"MFU {flops / med / BF16_FLOPS:.4f} against {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s; peak memory {peak_gib:.2f} GiB on {card}")
    busy = profiled_kernel_ms(lambda: epoch(state, batch),
                              ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"])
    if busy is None:
        log("[train] profiled step: the profiler saw no device time (kernel "
            "time a step not measured)")
    else:
        total_ms, by_name, wall_ms = busy
        log(f"[train] profiled step: compute kernels {total_ms:.3f} ms on the "
            f"device (a step's wall {wall_ms:.3f} ms, busy share "
            f"{total_ms / wall_ms:.3f}), of which " + " ".join(
                f"{n} {ms:.3f} ms ({ms / total_ms:.4f})"
                for n, ms in by_name.items()))
    del state, epoch, batch
    torch.cuda.empty_cache()
    return launches


def cifar_train_path(card):
    """Phase 8b; returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.resnet import resnet18

    state = TR.init_train_state(resnet18(num_classes=10), TR.sgd(0.1, 0.9),
                                seed=0, compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((CIFAR_STEPS, CIFAR_BATCH, 32, 32, 3),
                         device="cuda", generator=gen)
    labels = torch.randint(0, 10, (CIFAR_STEPS, CIFAR_BATCH), device="cuda",
                           generator=gen, dtype=torch.int32)
    epoch = TR.make_train_epoch(10)
    state, _m = epoch(state, images[:3], labels[:3])  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    state, ms = epoch(state, images, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    losses = ms["loss"].cpu().numpy()
    log(f"[cifar] ResNet-18 (bf16, SGD 0.1 / 0.9) {CIFAR_STEPS} steps of "
        f"batch {CIFAR_BATCH} at 32x32 in {dt:.3f} s = "
        f"{CIFAR_STEPS * CIFAR_BATCH / dt:.0f} samples/s on {card}; launches "
        f"{launches}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if launches != NO_LAUNCHES:
        fail(f"the CIFAR train path launched ported kernels: {launches}")
    if not np.isfinite(losses).all():
        fail(f"CIFAR train losses not finite: {losses}")
    busy = profiled_kernel_ms(lambda: epoch(state, images[:5], labels[:5]),
                              [])
    if busy is not None:
        log(f"[cifar] profiled 5 steps: compute kernels {busy[0] / 5:.3f} ms "
            f"a step on the device against {busy[2] / 5:.3f} ms of wall "
            f"(busy share {busy[0] / busy[2]:.3f})")
    del state, images, labels
    torch.cuda.empty_cache()
    return launches


def deep_vision_path(card):
    """Phase 8c; returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (DV_CLASSES, 3))
    labels = rng.integers(0, DV_CLASSES, DV_ROWS)
    noise = rng.normal(0, 20, (DV_ROWS, 32, 32, 3))
    images = np.clip(palette[labels][:, None, None, :] + noise, 0,
                     255).astype(np.uint8)
    table = Table({"image": list(images), "label": labels})
    zero_launches()
    t0 = time.perf_counter()
    model = DeepVisionClassifier(backbone="resnet18", batch_size=DV_BATCH,
                                 epochs=DV_EPOCHS, seed=0).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = read_launches()
    t0 = time.perf_counter()
    out = model.transform(table)
    score_s = time.perf_counter() - t0
    launches = read_launches()
    steps = DV_EPOCHS * math.ceil(DV_ROWS / DV_BATCH)
    chunks = math.ceil(DV_ROWS / 64)
    hist = np.asarray(model.loss_history)
    acc = float((np.asarray(out["prediction"]) == labels).mean())
    log(f"[deep_vision] DeepVisionClassifier(resnet18).fit: {DV_ROWS} uint8 "
        f"32x32 images, {DV_CLASSES} classes, batch {DV_BATCH}, {DV_EPOCHS} "
        f"epochs ({steps} steps) in {fit_s:.3f} s = "
        f"{steps * DV_BATCH / fit_s:.0f} samples/s; loss_history "
        f"{np.array2string(hist, precision=4)}; transform {score_s:.3f} s, "
        f"accuracy on the table {acc:.4f}; launches fit {fit_launches}, "
        f"fit + transform {launches} on {card}")
    if fit_launches != dict(NO_LAUNCHES, affine_resample=steps) or \
            launches != dict(NO_LAUNCHES, affine_resample=steps + chunks):
        fail(f"DeepVisionClassifier: B1 launched {fit_launches} / "
             f"{launches}, expected once a step ({steps}) and once a "
             f"scoring chunk ({chunks})")
    if not np.isfinite(hist).all() or hist[-1] >= hist[0]:
        fail(f"DeepVisionClassifier loss_history not finite or not "
             f"falling: {hist}")
    probs = np.asarray(out["probability"])
    if probs.shape != (DV_ROWS, DV_CLASSES) or not np.isfinite(probs).all():
        fail(f"DeepVisionModel probabilities {probs.shape}")
    torch.cuda.empty_cache()
    return launches


def unroll_bound(x) -> tuple:
    """(bound_ms, bound_by) of one normalize+unroll: the f32 batch read
    once and the f32 rows written once, against a subtract and a multiply
    an element at the f32 peak."""
    n = x.numel()
    t_bytes = 2 * n * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_unroll(K, shape, mean, std, seed, timed=False):
    """B2 against its plain version at one shape; with `timed`, also the
    kernel, plain and library times beside the bound."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, device="cuda", generator=gen) * 255.0
    got = K.fused_normalize_unroll(x, mean, std)
    ref = K.fused_normalize_unroll_plain(x, mean, std)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"unroll {shape}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    log(f"[kernel] fused_normalize_unroll f32{list(shape)}: "
        f"max_abs_err={err:.3e} (bound {UNROLL_ATOL})")
    if err > UNROLL_ATOL:
        fail(f"unroll {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e} > {UNROLL_ATOL})")
    if not timed:
        return {"err": err}
    b, c = shape[0], shape[3]
    mean4 = torch.tensor(mean, device="cuda").expand(c).view(1, c, 1, 1)
    inv4 = (1.0 / torch.tensor(std, dtype=torch.float64, device="cuda")
            ).float().expand(c).view(1, c, 1, 1)
    lib_out = torch.empty((b, c, shape[1], shape[2]), device="cuda")

    def library():
        # stock ops: the subtract reads the permuted view and writes the
        # CHW planes, then an in-place multiply
        torch.sub(x.permute(0, 3, 1, 2), mean4, out=lib_out)
        return lib_out.mul_(inv4).view(b, -1)

    lib_err = float((library() - ref).abs().max())
    calls = {"kernel": lambda: K.fused_normalize_unroll(x, mean, std),
             "plain": lambda: K.fused_normalize_unroll_plain(x, mean, std),
             "library": library}
    ev = {k: cuda_ms(f, 20) for k, f in calls.items()}
    kernel_ms, plain_ms, library_ms = (queued_ms(f) for f in calls.values())
    bound_ms, bound_by = unroll_bound(x)
    log(f"[kernel] fused_normalize_unroll f32{list(shape)}: device time "
        f"(calls queued behind a spin) kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (torch.sub(x.permute(0,3,1,2), mean, "
        f"out=) + mul_(inv); agrees: {lib_err <= UNROLL_ATOL}, "
        f"max_abs_err={lib_err:.3e}); CUDA events over back-to-back calls "
        f"{ev['kernel']:.4f} / {ev['plain']:.4f} / {ev['library']:.4f}; "
        f"bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms if lib_err <= UNROLL_ATOL else None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def rle_cases(images):
    """The byte-exactness cases of the decode: the worst case (phase 4's
    64 uniform-random 224x224 images as one chunk) and the JAX package's
    cases (tests/test_wire_codec.py:20-31)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {
        "uniform_64x224x224x3": np.stack(images[1::len(SIZES)]),
        "zeros": np.zeros((4, 32, 32, 3), np.uint8),
        "quantized": (rng.integers(0, 6, (3, 16, 16, 3)) * 40
                      ).astype(np.uint8),
        "noise": rng.integers(0, 255, (2, 17, 13)).astype(np.uint8),
        "long_runs": np.repeat(np.arange(5, dtype=np.uint8),
                               1000).reshape(10, 500),
        "float32": rng.integers(0, 3, (64,)).astype(np.float32) * 0.5,
        "single": np.array([7], np.uint8),
    }


def check_rle(W, name, arr, timed=False):
    """B3 against its plain version and the raw chunk, exact to the byte;
    with `timed`, also the kernel, plain and library times beside the
    bound.  Returns the largest byte difference (0) and the times."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    p = W.rle_encode(arr)
    enc_s = time.perf_counter() - t0
    v = torch.from_numpy(p.values).cuda()
    e = torch.from_numpy(p.ends).cuda()
    got = W.decode_bytes(v, e, p.n_pad)
    ref = W.decode_bytes_plain(v, e, p.n_pad)
    raw = got.cpu().numpy()
    err = int(np.abs(raw.astype(np.int16)
                     - ref.cpu().numpy().astype(np.int16)).max())
    exact = raw[:p.nbytes_raw].tobytes() == np.ascontiguousarray(arr).tobytes()
    log(f"[kernel] rle_decode {name} {arr.dtype}{list(arr.shape)}: R={len(p.values)} "
        f"n_pad={p.n_pad} ratio={W.rle_ratio(p):.3f} encode {enc_s:.3f} s; "
        f"max_byte_diff vs plain={err}, equals the raw chunk: {exact}")
    if err or not exact:
        fail(f"rle_decode {name}: the decode is not exact to the byte")
    if not timed:
        return {"err": float(err)}
    counts = torch.diff(e.long(), prepend=torch.zeros(1, dtype=torch.int64,
                                                      device="cuda"))
    calls = {"kernel": lambda: W.decode_bytes(v, e, p.n_pad),
             "plain": lambda: W.decode_bytes_plain(v, e, p.n_pad),
             "library": lambda: torch.repeat_interleave(
                 v, counts, output_size=p.n_pad)}
    ev = {k: cuda_ms(f, 20) for k, f in calls.items()}
    kernel_ms, plain_ms, library_ms = (queued_ms(f) for f in calls.values())
    # the runs the chunk needs: up to the one holding byte n_pad - 1 (the
    # power-of-two padding runs after it are never read)
    r_used = int(np.searchsorted(p.ends, p.n_pad - 1, side="right")) + 1
    nbytes = r_used * 5 + p.n_pad
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] rle_decode {name}: device time (calls queued behind a "
        f"spin) "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (torch.repeat_interleave(values, "
        f"counts, output_size=n_pad)); CUDA events over back-to-back calls "
        f"{ev['kernel']:.4f} / {ev['plain']:.4f} / {ev['library']:.4f}; "
        f"bound_ms={bound_ms:.4f} (bytes: 5 R_used + n_pad, R_used={r_used}"
        f" of R={len(p.values)}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": float(err), "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


def image_stage_pipeline(S, TorchModel, bundle, device=None, fuse=None):
    """Example 19's chain at the featurizer's size, the ImageNet eval crop:
    ImageTransformer -> UnrollImage -> TorchModel (the `pool` tap)."""
    from mmlspark_tpu_torch import Pipeline

    chain = S.ImageTransformer(fuse=fuse, device=device).resize(
        256, 256).center_crop(IMG, IMG).blur(2.0, 2.0).flip()
    return Pipeline([
        chain,
        S.UnrollImage(output_col="features", mean=list(MEAN_BGR),
                      std=list(STD_BGR), device=device),
        TorchModel(bundle=bundle, input_col="features", fetch_node="pool",
                   batch_size=BATCH, device=device)])


def image_stage_path(K, images, table, repo, card):
    """Phase 10 (a); returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.ops import image_stages as S

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    t0 = time.perf_counter()
    model = image_stage_pipeline(S, TorchModel, bundle).fit(table)
    log(f"[stages] Pipeline.fit (runs the two image stages once) "
        f"{time.perf_counter() - t0:.3f} s")
    zero_launches()
    t0 = time.perf_counter()
    out = model.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = np.asarray(out["output"])
    log(f"[stages] transform {first_s:.3f} s; launches {launches}")
    want = dict(NO_LAUNCHES, affine_resample=len(SIZES),
                fused_normalize_unroll=1)
    if launches != want:
        fail(f"the image-stage path launched the kernels {launches} times, "
             f"expected {want} (B1 once per input shape group, B2 once for "
             f"the one 224x224 group, nothing inside TorchModel)")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"image-stage features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("the image-stage path changed the row order")

    # the ImageTransformer's kernel path against the plain composition on
    # the card, at the JAX package's limits (test_fused_pipeline.py:65-71)
    chain_k, unroll = model.stages[0], model.stages[1]
    rows_k = chain_k.transform(table)["image"]
    chain_p = image_stage_pipeline(S, TorchModel, bundle,
                                   fuse=False).stages[0]
    K.LAUNCHES = 0
    rows_p = chain_p.transform(table)["image"]
    if K.LAUNCHES:
        fail("the fuse=False ImageTransformer launched the resample kernel")
    diffs = [np.abs(a["data"].astype(np.int16) - b["data"].astype(np.int16))
             for a, b in zip(rows_k, rows_p)]
    lsb = max(int(d.max()) for d in diffs)
    share = sum(int((d > 0).sum()) for d in diffs) / sum(d.size for d in diffs)
    log(f"[stages] ImageTransformer kernel rows vs the plain composition "
        f"on the card: max {lsb} LSB (bound 1), share of differing pixel "
        f"values {share:.2e}")
    if lsb > 1 or any(a["data"].shape != (IMG, IMG, 3) for a in rows_k):
        fail("the ImageTransformer's kernel rows disagree with the plain "
             "composition")

    # UnrollImage against B2's plain version on the same rows
    vecs = np.asarray(list(unroll.transform(Table({"image": rows_k}))[
        "features"]))
    batch = torch.from_numpy(np.stack([r["data"] for r in rows_k])).cuda()
    plain = K.fused_normalize_unroll_plain(batch.float(), MEAN_BGR,
                                           STD_BGR).cpu().numpy()
    err_unroll = float(np.abs(vecs - plain).max())
    log(f"[stages] UnrollImage vectors vs B2's plain version: "
        f"max_abs_err={err_unroll:.3e} (bound {UNROLL_ATOL}); dtype "
        f"{vecs.dtype}")
    if err_unroll > UNROLL_ATOL or vecs.dtype != np.float64:
        fail("UnrollImage's vectors disagree with B2's plain version")

    # the whole pipeline, bf16 on the card against f32 on the CPU, on a
    # ResNet-50 whose BatchNorms are all random (as phase 4)
    few_table = Table({"image": [images[i] for i in range(4)]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        pipe = image_stage_pipeline(S, TorchModel, check_bundle, device=dev)
        side[dev] = np.asarray(pipe.fit(few_table).transform(few_table)[
            "output"])
    err_cpu = rel_l2(side["cuda"], side["cpu"])
    log(f"[stages] features (random-BatchNorm ResNet-50, bf16 on the card) "
        f"vs an f32 CPU run of the whole pipeline on 4 images: "
        f"rel_l2={err_cpu:.3e} (bound {CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("image-stage features disagree with the f32 CPU run")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(table)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    log(f"[stages] Pipeline(ImageTransformer -> UnrollImage -> TorchModel "
        f"resnet50 pool), {N_IMAGES} images, 3 runs: images/s min "
        f"{N_IMAGES / walls[-1]:.0f}, median {N_IMAGES / walls[1]:.0f}, "
        f"max {N_IMAGES / walls[0]:.0f} (walls {walls[0]:.4f}-"
        f"{walls[-1]:.4f} s) on {card}")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler dropped the kernels of the first milliseconds of a
        # session late in this process (B1's 3 launches open the path)
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        model.transform(table)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_us, by_us = device_events_us(
        prof, ["affine_resample", "normalize_unroll"], copies=False)
    copy_us = device_events_us(prof, [], copies=True)[0] - total_us
    seen = {n: c for n, (_us, c) in by_us.items()}
    if seen != {"affine_resample": len(SIZES), "normalize_unroll": 1}:
        log(f"[stages] profiled run: the profiler saw {seen} of the path's "
            f"kernel launches, not all (shares not measured)")
    else:
        b1, b2 = by_us["affine_resample"][0], by_us["normalize_unroll"][0]
        rest = total_us - b1 - b2
        log(f"[stages] profiled run: compute kernels {total_us / 1e3:.3f} ms "
            f"on the device, of which B1 {b1 / 1e3:.4f} ms "
            f"({b1 / total_us:.4f}), B2 {b2 / 1e3:.4f} ms "
            f"({b2 / total_us:.4f}), the rest (the ResNet-50 forward and the "
            f"stages' casts) {rest / 1e3:.3f} ms ({rest / total_us:.4f}); "
            f"copies {copy_us / 1e3:.3f} ms; the profiled run's wall "
            f"{wall_ms:.3f} ms; kernels / median unprofiled wall = "
            f"{total_us / (walls[1] * 1e6):.3f}")
    del model
    torch.cuda.empty_cache()
    return launches, err_unroll


def compressed_wire_path(W, card):
    """Phase 10 (c); returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry

    rng = np.random.default_rng(0)
    blk = 8
    chunks = [(rng.integers(0, 6, (RLE_CHUNK, RLE_SIDE, RLE_SIDE // blk, 1))
               * 40).astype(np.uint8).repeat(blk, axis=2).repeat(3, axis=3)
              for _ in range(RLE_CHUNKS)]
    t0 = time.perf_counter()
    payloads = [W.rle_encode(c) for c in chunks]
    enc_s = time.perf_counter() - t0
    feed = DeviceFeed(torch.device("cuda"), telemetry=FeedTelemetry())
    feed.put_group([payloads[0]])  # warm the ring slot
    tel = feed.telemetry = FeedTelemetry()
    zero_launches()
    t0 = time.perf_counter()
    outs, means = [], []
    for p in payloads:
        (x,) = feed.put_group([p])
        outs.append(x)
        means.append(x.float().mean(dim=(1, 2, 3)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = tel.snapshot()
    ratio = snap["wire_bytes_raw"] / snap["wire_bytes_sent"]
    log(f"[wire] {RLE_CHUNKS} compressed groups of {RLE_CHUNK}x{RLE_SIDE}x"
        f"{RLE_SIDE}x3 uint8: R={len(payloads[0].values)} runs a chunk, "
        f"wire ratio {ratio:.3f} ({snap['wire_bytes_raw']:.0f} raw / "
        f"{snap['wire_bytes_sent']:.0f} sent bytes), host encode "
        f"{enc_s:.3f} s, put_group + decode + mean {wall:.4f} s; launches "
        f"{launches} on {card}")
    if launches != dict(NO_LAUNCHES, rle_decode=RLE_CHUNKS):
        fail(f"the compressed wire launched the kernels {launches} times, "
             f"expected rle_decode once per chunk ({RLE_CHUNKS})")
    if snap["compressed_groups"] != RLE_CHUNKS:
        fail(f"compressed_groups {snap['compressed_groups']}")
    for c, x in zip(chunks, outs):
        if x.dtype != torch.uint8 or tuple(x.shape) != c.shape or \
                x.cpu().numpy().tobytes() != c.tobytes():
            fail("a decoded chunk differs from its raw chunk")
    plain_means = [feed.put(c).float().mean(dim=(1, 2, 3)) for c in chunks]
    if not all(torch.equal(a, b) for a, b in zip(means, plain_means)):
        fail("the compressed chunks' means differ from the plain put's")
    log("[wire] every decoded chunk equals its raw chunk byte for byte; "
        "the f32 means equal the plain put path's")
    return launches, chunks[0]


def ycc_bound(layout, planes) -> tuple:
    """(bound ms, "bytes") of C2 on one image: its planes read once and
    the BGR image written once, over the card's memory rate (a few integer
    operations a byte: far below the compute bound)."""
    nbytes = sum(p.size for p in planes) + layout.height * layout.width * 3
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_ycc(native, blobs):
    """Phase 11 (c): C2 against its plain version on every colour
    fixture's nvJPEG planes, byte for byte, and against the decoder's own
    output; timed at the JPEG path's three image sizes (one of each,
    summed).  Returns the record's numbers."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.jpeg_color import ycc_to_bgr, ycc_to_bgr_plain

    timed = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    sizes_timed = set()
    err = 0
    for name in sorted(blobs):
        got = native.decode_jpeg_planes(blobs[name])
        if got is None or len(got[1]) != 3:
            continue  # gray: no C2; CMYK: refused
        layout, planes = got
        args = ([torch.from_numpy(p).cuda() for p in planes], layout.factors,
                layout.height, layout.width, layout.color)
        kern = ycc_to_bgr(*args)
        plain = ycc_to_bgr_plain(*args)
        torch.cuda.synchronize()
        decoded = native.decode_jpeg_bgr(blobs[name])
        e = int((kern.int() - plain.int()).abs().max())
        err = max(err, e)
        same_route = np.array_equal(kern.cpu().numpy(), decoded)
        log(f"[c2] {name} {layout.height}x{layout.width} factors "
            f"{layout.factors} planes {[p.shape for p in planes]}: kernel vs "
            f"plain max abs diff {e}; kernel == the decoder's pixels: "
            f"{same_route}")
        if e != 0 or not same_route:
            fail(f"C2 on {name}: the kernel differs from its plain version "
                 f"({e}) or from the decode ({same_route})")
        hw = (layout.height, layout.width)
        if name.startswith("bench_") and hw not in sizes_timed:
            sizes_timed.add(hw)
            ms = queued_ms(lambda: ycc_to_bgr(*args))
            plain_ms = cuda_ms(lambda: ycc_to_bgr_plain(*args), 10)
            bound, _ = ycc_bound(layout, planes)
            log(f"[c2] {hw}: kernel {ms:.4f} ms (queued behind a spin), "
                f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes) on "
                f"one image")
            timed = {"ms": timed["ms"] + ms,
                     "plain_ms": timed["plain_ms"] + plain_ms,
                     "bound_ms": timed["bound_ms"] + bound}
    if len(sizes_timed) != len(SIZES):
        fail(f"C2 timed at {sorted(sizes_timed)}, not the three sizes")
    return dict(timed, err=err, bound_by="bytes", library_ms=None)


def _state_numbers(state):
    """{name: host tensor} of every number a TrainState holds: masters and
    buffers, optimizer state, the bf16 working copy, the step."""
    out = {f"module/{k}": v.detach().cpu().clone()
           for k, v in state.module.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"optimizer/{i}/{k}"] = v.detach().cpu().clone()
    for i, p in enumerate(state.work.parameters()):
        out[f"work/{i}"] = p.detach().cpu().clone()
    return out


def _max_diff(a, b) -> tuple:
    """(leaves not bit-equal, max abs difference) of two number dicts."""
    import torch

    if sorted(a) != sorted(b):
        fail(f"the states hold other leaves: {sorted(set(a) ^ set(b))}")
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    diff = max([float((a[k].double() - b[k].double()).abs().max())
                for k in bad] or [0.0])
    return bad, diff


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _sub, files in os.walk(path) for f in files)


def resumable_train_path(card):
    """Phase 11 (a); returns {kernel: launches} of the counted runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.checkpoint import CheckpointManager
    from mmlspark_tpu_torch.models.guard import TrainingGuard
    from mmlspark_tpu_torch.models.resnet import resnet18
    from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan,
                                                 InjectedCrash)

    steps_per_epoch = CIFAR_STEPS // 2
    rng = np.random.default_rng(0)
    n = steps_per_epoch * CIFAR_BATCH
    images = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    root = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(ROOT, "build"))

    def fresh():
        return TR.init_train_state(resnet18(num_classes=10),
                                   TR.sgd(0.1, 0.9), seed=0,
                                   compute_dtype="bfloat16")

    def fit(name, **kw):
        kw = dict(dict(epochs=2, checkpoint_every=RESUME_EVERY, seed=0), **kw)
        step = None if "step_factory" in kw else TR.make_train_step(10)
        return TR.fit_epochs_resumable(step, fresh(), images, labels,
                                       CIFAR_BATCH, os.path.join(root, name),
                                       **kw)

    try:
        zero_launches()
        t0 = time.perf_counter()
        ref, ref_m = fit("ref")
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        crash = FaultPlan(seed=1).on("training.step", nth=[RESUME_KILL_AT],
                                     error=InjectedCrash)
        try:
            with FAULTS.arm(crash):
                fit("kill")
            fail("the injected kill at step "
                 f"{RESUME_KILL_AT} did not stop fit_epochs_resumable")
        except InjectedCrash:
            pass
        kept = sorted(int(d) for d in os.listdir(os.path.join(root, "kill"))
                      if d.isdigit())
        resumes = telemetry.counters().get("training.resume", 0)
        res, res_m = fit("kill")
        torch.cuda.synchronize()
        resumed = telemetry.counters().get("training.resume", 0) - resumes
        launches = read_launches()
        bad, diff = _max_diff(_state_numbers(ref), _state_numbers(res))
        log(f"[resume] ResNet-18 CIFAR (bf16, SGD 0.1 / 0.9, batch "
            f"{CIFAR_BATCH}) through fit_epochs_resumable, {CIFAR_STEPS} "
            f"steps, a checkpoint every {RESUME_EVERY}: uninterrupted "
            f"{ref_s:.3f} s, loss {ref_m['loss']:.6f}; killed at step "
            f"{RESUME_KILL_AT} (checkpoints left {kept}), resumed "
            f"({resumed} resume) to step {res.step}, loss "
            f"{res_m['loss']:.6f}; {len(bad)} leaves differ, max abs diff "
            f"{diff:.3e}; launches {launches} on {card}")
        if kept != [RESUME_EVERY, 2 * RESUME_EVERY] or resumed != 1:
            fail(f"the kill left checkpoints {kept}, resumed {resumed}")
        if bad or res.step != ref.step or res_m != ref_m:
            fail(f"the resumed run is not the uninterrupted one bit for "
                 f"bit: {bad[:5]} (max abs diff {diff:.3e})")
        if launches != NO_LAUNCHES:
            fail(f"the CIFAR train path launched ported kernels: {launches}")

        # the guard drill: a poisoned batch before the first periodic
        # checkpoint rolls back to the floor checkpoint (step 0)
        guard = TrainingGuard(hang_timeout_s=600.0)
        rollbacks = telemetry.counters().get("training.rollback", 0)
        drill = FaultPlan(seed=5).on("training.loss_nan", nth=[RESUME_NAN_AT])
        with FAULTS.arm(drill):
            g_state, g_m = fit("guard", guard=guard, step_factory=lambda s:
                               TR.make_train_step(10, lr_scale=s))
        with open(os.path.join(root, "guard", "quarantine.json")) as f:
            quarantined = json.load(f)["quarantined"]
        spans = [sp for sp in telemetry.recent_spans()
                 if sp.get("name") == "training.guard.rollback"]
        restored = spans[-1]["attrs"].get("restored_step") if spans else None
        log(f"[resume] guard drill: training.loss_nan at step "
            f"{RESUME_NAN_AT}: quarantined {sorted(guard.quarantined)}, "
            f"rollbacks {guard.rollbacks} (to step {restored}), lr scale "
            f"{guard.lr_scale}, final step {g_state.step}, loss "
            f"{g_m['loss']:.6f}; quarantine.json {quarantined}")
        if (guard.quarantined != {RESUME_NAN_AT} or guard.rollbacks != 1 or
                telemetry.counters().get("training.rollback", 0)
                != rollbacks + 1 or restored != 0 or
                quarantined != [RESUME_NAN_AT] or
                g_state.step != CIFAR_STEPS - 1 or
                not math.isfinite(g_m["loss"])):
            fail("the guard drill did not quarantine, roll back to the "
                 "floor and finish")
        if not all(torch.isfinite(v).all() for v in
                   _state_numbers(g_state).values()):
            fail("the guard drill left a non-finite number in the state")

        # checkpoint costs: a save of the final state, its verified
        # restore into a live state, the verification alone
        mgr = CheckpointManager(os.path.join(root, "cost"))
        t0 = time.perf_counter()
        mgr.save(ref, step=CIFAR_STEPS)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(root, "cost", str(CIFAR_STEPS)))
        hist = telemetry.histogram("checkpoint.verify.latency")
        v0 = hist.snapshot()
        target = fresh()
        t0 = time.perf_counter()
        mgr.restore(CIFAR_STEPS, template=target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        v1 = hist.snapshot()
        verify_s = v1["sum"] - v0["sum"]
        bad, _ = _max_diff(_state_numbers(ref), _state_numbers(target))
        log(f"[resume] checkpoint of the ResNet-18 state: {nbytes} bytes "
            f"in {len(os.listdir(os.path.join(root, 'cost', str(CIFAR_STEPS))))}"
            f" files, save {save_s:.4f} s (synchronous, fsync'd), restore "
            f"{restore_s:.4f} s of which crc32 verification {verify_s:.4f} s;"
            f" restored state bit-equal: {not bad}")
        if bad:
            fail(f"a checkpoint round trip changed {bad[:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def deep_vision_resume_path(card):
    """Phase 11 (b); returns {kernel: launches} of the counted fits."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

    blobs, _digests = jpeg_fixtures()
    names = sorted(n for n in blobs if n.startswith("bench_"))
    column = [blobs[names[i % len(names)]] for i in range(DVJ_ROWS)]
    labels = np.array([i % len(names) % 2 for i in range(DVJ_ROWS)])
    table = Table({"image": column, "label": labels})
    root = tempfile.mkdtemp(prefix="dv-", dir=os.path.join(ROOT, "build"))
    steps = math.ceil(DVJ_ROWS / DVJ_BATCH)
    kw = dict(backbone="resnet18", height=IMG, width=IMG,
              batch_size=DVJ_BATCH, seed=0)
    counted = dict(NO_LAUNCHES)
    try:
        runs = {}
        for name, epochs, ckpt in (("full", 2, ""), ("first", 1, root),
                                   ("resumed", 2, root)):
            zero_launches()
            t0 = time.perf_counter()
            runs[name] = DeepVisionClassifier(
                epochs=epochs, checkpoint_dir=ckpt, **kw).fit(table)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
            trained = epochs if name != "resumed" else 1
            want = dict(NO_LAUNCHES, affine_resample=steps * trained,
                        ycc_to_bgr=DVJ_ROWS)
            log(f"[dv-resume] {name}: DeepVisionClassifier(resnet18, "
                f"{IMG}x{IMG}, batch {DVJ_BATCH}, epochs={epochs}"
                f"{', checkpoint_dir' if ckpt else ''}) on {DVJ_ROWS} JPEG "
                f"bytes rows in {dt:.3f} s; loss_history "
                f"{runs[name].loss_history}; launches {launches}")
            if launches != want:
                fail(f"DeepVisionClassifier {name}: launches {launches}, "
                     f"expected {want} (B1 once a step, C2 once a row)")
            counted = {k: counted[k] + launches[k] for k in KERNELS}
        a = runs["full"].bundle.state_dict
        b = runs["resumed"].bundle.state_dict
        bad = [k for k in a if not np.array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]))]
        diff = max([float(np.abs(np.asarray(a[k], np.float64)
                                 - np.asarray(b[k], np.float64)).max())
                    for k in bad] or [0.0])
        log(f"[dv-resume] 1 + 1 epochs on one checkpoint_dir "
            f"(checkpoints {sorted(os.listdir(root))}) against 2 epochs: "
            f"{len(bad)} tensors differ, max abs diff {diff:.3e} on {card}")
        if bad or runs["resumed"].loss_history != \
                runs["full"].loss_history[1:] or \
                runs["first"].loss_history != runs["full"].loss_history[:1]:
            fail(f"the resumed DeepVisionClassifier fit is not the "
                 f"uninterrupted one: {bad[:5]} (max abs diff {diff:.3e})")
        if not all(math.isfinite(v) for v in runs["full"].loss_history):
            fail("DeepVisionClassifier on JPEG bytes: non-finite loss")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counted


def ptxas_entries(report: str):
    """[(entry, registers, spill store bytes, spill load bytes)] from an
    `nvcc -Xptxas -v` report."""
    out, entry, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1))) + spills)
            entry, spills = None, (0, 0)
    return out


def hopper_report(_build, A) -> None:
    """Registers, spills and shared memory of the TMA/wgmma kernels (B4, B5
    and B6 on the bf16, D <= 128 route); fails on a spill."""
    import ctypes

    smem = {}  # kernel name -> {64: bytes, 128: bytes}
    for lib_name, kernel, fn in (
            ("flash_attention_fwd", "flash_fwd_hopper_kernel",
             "mmk_flash_attention_fwd_hopper_smem"),
            ("flash_attention_bwd", "flash_bwd_dkdv_hopper_kernel",
             "mmk_flash_attention_bwd_dkdv_hopper_smem"),
            ("flash_attention_bwd", "flash_bwd_dq_hopper_kernel",
             "mmk_flash_attention_bwd_dq_hopper_smem")):
        f = getattr(_build.library(lib_name), fn)
        f.argtypes, f.restype = [ctypes.c_int], ctypes.c_int
        smem[kernel] = {64: f(64), 128: f(128)}
    seen = set()
    for lib_name in ("flash_attention_fwd", "flash_attention_bwd"):
        for entry, regs, st, ld in ptxas_entries(
                _build.ptxas_report(lib_name)):
            kernel = next((k for k in smem if k in entry), None)
            if kernel is None:
                continue
            dp = 64 if "ILi64E" in entry else 128
            seen.add((kernel, dp))
            log(f"[build] {lib_name} Hopper kernel {entry}: {regs} registers "
                f"a thread at launch (setmaxnreg: consumer warpgroup 216, "
                f"producer warpgroup 40), spill stores {st} B, spill loads "
                f"{ld} B, dynamic shared memory {smem[kernel][dp]} B a "
                f"block (D <= {dp}), two blocks an SM")
            if st or ld:
                fail(f"{entry} spills registers ({st} B stores, {ld} B loads)")
    if len(seen) != 2 * len(smem):
        fail(f"the ptxas reports lack Hopper kernels: saw {sorted(seen)}")


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
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

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
    # the decoder library (nvJPEG with the C2 kernel) builds beside the
    # kernels of csrc/, all at once
    import threading
    from mmlspark_tpu_torch import native

    decoder = {}

    def build_decoder():
        t = time.perf_counter()
        try:
            decoder["ok"] = native.jpeg_available()
        except native.DecoderError as e:
            decoder["error"] = str(e)
        decoder["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build_decoder)
    t0 = time.perf_counter()
    builder.start()
    secs = _build.build()
    builder.join()
    log(f"[build] {len(secs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s: {secs}; the JPEG decoder "
        f"({native.jpeg_backend()}) in {decoder['s']:.2f} s")
    if not decoder.get("ok") or native.jpeg_backend() != "nvjpeg":
        fail(f"the nvJPEG decoder with the C2 kernel did not build: "
             f"{decoder.get('error') or native.build_error()}")
    for entry, regs, st, ld in ptxas_entries(native.build_log()):
        log(f"[build] native jpeg_ycc.cu {entry}: {regs} registers, spill "
            f"stores {st} B, loads {ld} B")
        if st or ld:
            fail(f"{entry} spills registers")
    for name in secs:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    hopper_report(_build, A)
    # the kernels redesigned last (B8's split instantiations, B1's tile
    # route) ship without spills, as the Hopper kernels do
    for name in ("paged_attention", "resize_normalize"):
        entries = ptxas_entries(_build.ptxas_report(name))
        spilled = [e for e in entries if e[2] or e[3]]
        log(f"[build] {name}: {len(entries)} kernels, registers "
            f"{min(e[1] for e in entries)}..{max(e[1] for e in entries)}, "
            f"{len(spilled)} with spills")
        if spilled:
            fail(f"{name} spills registers: {spilled}")

    # ---- 3. kernel check -----------------------------------------------
    main_shapes = [(BATCH, h, w, 3) for h, w in SIZES]
    checks = [check_resample(K, s, "uint8", seed=i)
              for i, s in enumerate(main_shapes)]
    extra = [check_resample(K, (7, 333, 517, 3), "uint8", seed=7),
             check_resample(K, (5, 97, 131, 1), "float32", seed=8),
             # DeepVisionClassifier (phase 8c): a fit step's batch and a
             # scoring chunk, 32x32 uint8 kept at 32x32
             check_resample(K, (DV_BATCH, 32, 32, 3), "uint8", seed=9,
                            out_hw=(32, 32)),
             check_resample(K, (64, 32, 32, 3), "uint8", seed=17,
                            out_hw=(32, 32))] + [
        # ragged store edges (a row of 7 x 31 x 4 and of 7 x 31 x 3
        # values), the pixel route by the rule (a large uint8 downscale, a
        # wide f32 input), and two composed chains: phase 10's (resize,
        # center crop, blur, flip) and a crop with both flips
        check_resample(K, shape, dtype, seed=40 + i, out_hw=hw, timed=False)
        for i, (shape, dtype, hw) in enumerate([
            ((2, 19, 23, 4), "uint8", (7, 31)),
            ((3, 19, 23, 3), "float32", (7, 31)),
            ((2, 1500, 2000, 3), "uint8", (IMG, IMG)),
            ((2, 600, 1600, 3), "float32", (IMG, IMG))])] + [
        check_resample(K, (16, h, w, 3), "uint8", seed=50 + i, timed=False,
                       plan=K.affine_plan(K.freeze_stages(chain), h, w, 3))
        for i, (h, w, chain) in enumerate([
            (320, 240, [("resize", {"height": 256, "width": 256}),
                        ("centerCrop", {"height": IMG, "width": IMG}),
                        ("blur", {"height": 2.0, "width": 2.0}),
                        ("flip", {})]),
            (333, 517, [("crop", {"x": 40, "y": 21, "height": 300,
                                  "width": 400}),
                        ("resize", {"height": IMG, "width": IMG}),
                        ("flip", {"flipLeftRight": True,
                                  "flipUpDown": True})])])]
    # B4 at the ViT-B/16 chunk and the LM prefill (the main paths'
    # shapes), then a ragged causal f32 and a D = 32 shape
    attn_main = [
        check_attention(A, (BATCH, 196, 12, 64), "bfloat16", False, seed=10),
        check_attention(A, (LM_BATCH, LM_PROMPT, 12, 64), "bfloat16", True,
                        seed=11)]
    attn_extra = [
        check_attention(A, (3, 77, 5, 64), "float32", True, seed=12),
        check_attention(A, (8, 128, 4, 32), "bfloat16", True, seed=13),
        # the batcher's admission prefills: kp rows at a power-of-two bucket
        check_attention(A, (SERVE_SLOTS, 1024, 12, 64), "bfloat16", True,
                        seed=14),
        check_attention(A, (1, 16, 12, 64), "bfloat16", True, seed=15),
        # the LM train forward (phase 8a)
        check_attention(A, (TRAIN_BATCH, TRAIN_SEQ, 12, 64), "bfloat16",
                        True, seed=16)]
    # B7/B8 at the serving shape and beside it (their times are taken on
    # the serving run's live pools, phase 7b)
    paged_err = paged_kernel_checks(PA)
    # B5/B6 at the LM train layer (timed), a ViT-B/16 chunk, a ragged f32,
    # a D 32 and a D 128 shape
    bwd_main = check_attention_bwd(A, (TRAIN_BATCH, TRAIN_SEQ, 12, 64),
                                   "bfloat16", True, seed=20, timed=True)
    bwd_extra = [
        check_attention_bwd(A, (BATCH, 196, 12, 64), "bfloat16", False,
                            seed=21),
        check_attention_bwd(A, (3, 77, 5, 64), "float32", True, seed=22),
        check_attention_bwd(A, (2, 128, 4, 32), "float32", False, seed=23),
        check_attention_bwd(A, (4, 256, 4, 128), "bfloat16", True, seed=24)]

    # ---- 4-6. the paths (4b: JPEG bytes) ----------------------------------
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(*SIZES[i % 3], 3), dtype=np.uint8)
              for i in range(N_IMAGES)]
    table = Table({"image": images, "id": np.arange(N_IMAGES)})
    repo = ModelRepo(os.path.join(ROOT, "build", "model_repo"))
    n_chunks = sum(math.ceil(N_IMAGES / len(SIZES) / BATCH) for _ in SIZES)
    paths = [resnet_path(K, A, images, table, repo, n_chunks, card),
             jpeg_path(repo, n_chunks, card),
             vit_path(K, A, images, table, repo, n_chunks, card),
             lm_path(K, A, card)]

    # ---- 7. decode serving -----------------------------------------------
    serve_exactness(card)
    serve_launches, live, serve_flash_err = serving_path(A, PA, card)
    paths.append(serve_launches)

    # ---- 8. training -----------------------------------------------------
    paths += [lm_train_path(card), cifar_train_path(card),
              deep_vision_path(card)]

    # ---- 10. image stages and compressed wire ----------------------------
    stage_launches, unroll_path_err = image_stage_path(K, images, table,
                                                       repo, card)
    unroll_checks = [
        check_unroll(K, (N_IMAGES, IMG, IMG, 3), MEAN_BGR, STD_BGR, seed=30,
                     timed=True),
        check_unroll(K, (5, 37, 53, 1), (0.25,), (3.0,), seed=31),
        check_unroll(K, (3, 24, 24, 3), (120.0,), (64.0,), seed=32)]
    wire_launches, bench_chunk = compressed_wire_path(W, card)
    rle_main = check_rle(W, "feed_bench", bench_chunk, timed=True)
    rle_extra = [check_rle(W, name, arr, timed=name == "uniform_64x224x224x3")
                 for name, arr in rle_cases(images).items()]
    paths += [stage_launches, wire_launches]

    # ---- 11. resumable training and C2 ---------------------------------
    # both resume checks compare runs bit for bit: cuDNN's deterministic
    # algorithms from here on (cuBLAS's workspace is set at the top)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    paths += [resumable_train_path(card), deep_vision_resume_path(card)]
    from mmlspark_tpu_torch import native

    ycc = check_ycc(native, jpeg_fixtures()[0])
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}

    # ---- 9. record -----------------------------------------------------
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
        "max_abs_err": max([c["err"] for c in attn_main + attn_extra]
                           + [serve_flash_err]),
        # one ViT-B/16 chunk layer plus one LM prefill layer, summed;
        # the kernel's time queued behind a spin (the device alone)
        "ms": summed(attn_main, "ms"),
        "plain_ms": summed(attn_main, "plain_ms"),
        "bound_ms": summed(attn_main, "bound_ms"),
        "bound_by": bound_by(attn_main),
        "library_ms": summed(attn_main, "library_ms"),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"mmlspark_tpu/ops/paged_attention.py:{line}",
        "launches": launches[name],
        "max_abs_err": max(paged_err[name], live[name]["err"]),
        # one launch on the serving run's live pools (tick 40, layer 0)
        "ms": live[name]["ms"],
        "plain_ms": live[name]["plain_ms"],
        "bound_ms": live[name]["bound_ms"],
        "bound_by": live[name]["bound_by"],
        "library_ms": live[name]["library_ms"],
    } for name, line in (("paged_decode_attention", 167),
                         ("paged_decode_attention_int8", 250))] + [{
        "name": f"flash_attention_bwd_{which}",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"mmlspark_tpu/ops/attention_kernels.py:{line}",
        "launches": launches[f"flash_attention_bwd_{which}"],
        "max_abs_err": max(r[which]["err"] for r in [bwd_main] + bwd_extra),
        # one launch at the LM train layer (16, 1024, 12, 64) bf16 causal;
        # library_ms: SDPA's whole backward (dQ, dK and dV together)
        "ms": bwd_main[which]["ms"],
        "plain_ms": bwd_main[which]["plain_ms"],
        "bound_ms": bwd_main[which]["bound_ms"],
        "bound_by": bwd_main[which]["bound_by"],
        "library_ms": bwd_main[which]["library_ms"],
    } for which, line in (("dkdv", 278), ("dq", 348))] + [{
        "name": "fused_normalize_unroll",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/normalize_unroll.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:56",
        "launches": launches["fused_normalize_unroll"],
        "max_abs_err": max([c["err"] for c in unroll_checks]
                           + [unroll_path_err]),
        # one launch at the image-stage path's (192, 224, 224, 3) f32
        # group; library_ms: torch.sub over the permuted view + mul_
        "ms": unroll_checks[0]["ms"],
        "plain_ms": unroll_checks[0]["plain_ms"],
        "bound_ms": unroll_checks[0]["bound_ms"],
        "bound_by": unroll_checks[0]["bound_by"],
        "library_ms": unroll_checks[0]["library_ms"],
    }, {
        "name": "rle_decode",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/rle_decode.cu",
        "replaces": "mmlspark_tpu/ops/wire_codec.py:231",
        "launches": launches["rle_decode"],
        "max_abs_err": max(r["err"] for r in [rle_main] + rle_extra),
        # one launch at a feed_bench chunk (16x224x224x3 uint8);
        # library_ms: torch.repeat_interleave(values, counts, output_size)
        "ms": rle_main["ms"],
        "plain_ms": rle_main["plain_ms"],
        "bound_ms": rle_main["bound_ms"],
        "bound_by": rle_main["bound_by"],
        "library_ms": rle_main["library_ms"],
    }, {
        "name": "ycc_to_bgr",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/native/src/jpeg_ycc.cu",
        # no pallas_call: the JAX package's host libjpeg decode, whose
        # upsampling and colour conversion this kernel computes
        "replaces": "mmlspark_tpu/native/src/native.cpp:248",
        "launches": launches["ycc_to_bgr"],
        "max_abs_err": ycc["err"],
        # one image of each of the JPEG path's three sizes, summed; no
        # PyTorch call computes libjpeg's upsampling and conversion
        "ms": ycc["ms"],
        "plain_ms": ycc["plain_ms"],
        "bound_ms": ycc["bound_ms"],
        "bound_by": ycc["bound_by"],
        "library_ms": ycc["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
