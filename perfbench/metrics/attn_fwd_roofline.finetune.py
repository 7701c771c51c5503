"""attn_fwd_roofline.finetune: kernel B4 (flash-attention forward)
against its roofline in the traced fit.  Each attention call of a step
is (B, S, H, D) = (batch, tokens, heads, hidden / heads), one a layer;
its least time is the larger of its bytes at the HBM rate (q, k and v
read once in bf16, the float32 output written once) and its FLOPs at the
bf16 peak (4 B H S^2 D: the scores and the weighted values).  The kernel
time is the device time of the kernels named below."""
from perfbench.harness.device import BF16_FLOPS, HBM_BYTES_PER_S

NAME = "attn_fwd_roofline.finetune"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels B4, B5, B6"
MOVES = "train_step_ms"
KERNELS = ("flash_fwd",)


def call_shape(view):
    cfg = view.config
    h, w = cfg["image_size"]
    s = (h // cfg["patch_size"]) * (w // cfg["patch_size"])
    heads = cfg["num_attention_heads"]
    return int(view.mix["batch_size"]), s, heads, cfg["hidden_size"] // heads


def least_seconds(b, s, h, d):
    nbytes = 3 * b * s * h * d * 2 + b * s * h * d * 4
    flops = 4.0 * b * h * s * s * d
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    calls = sum(r.get("steps", 0) for r in view.traced) * \
        view.config["num_hidden_layers"]
    if not launches or seconds <= 0 or not calls:
        return None
    return 100.0 * calls * least_seconds(*call_shape(view)) / seconds
