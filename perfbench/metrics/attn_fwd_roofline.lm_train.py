"""attn_fwd_roofline.lm_train: kernel B4 (flash-attention forward,
causal) against its roofline in the traced calls of an LM cell.  Each
attention call of a step is (B, S, H, D) = (batch, tokens, query heads,
head_dim), one a "full_attention" layer, with K and V expanded to the H
query heads before the kernel; its least time is the larger of its bytes
at the HBM rate (q, k and v read once in bf16, the float32 output
written once) and its FLOPs at the bf16 peak (4 B H D S (S + 1) / 2: the
scores and the weighted values over the causal triangle, its diagonal
included).  The kernel time is the device time of the kernels named
below."""
from perfbench.harness.device import BF16_FLOPS, HBM_BYTES_PER_S

NAME = "attn_fwd_roofline.lm_train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels B4, B5, B6"
MOVES = "train_step_ms"
KERNELS = ("flash_fwd",)


def call_shape(view):
    cfg = view.config
    heads = cfg["num_attention_heads"]
    return (int(view.mix["batch_size"]), int(view.mix["seq_len"]), heads,
            cfg["hidden_size"] // heads)


def least_seconds(b, s, h, d):
    n = b * s * h * d
    nbytes = 3 * n * 2 + n * 4
    flops = 4.0 * b * h * d * s * (s + 1) / 2
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    layers = view.config.get("layer_types", []).count("full_attention")
    calls = sum(r.get("steps", 0) for r in view.traced) * layers
    if not launches or seconds <= 0 or not calls:
        return None
    return 100.0 * calls * least_seconds(*call_shape(view)) / seconds
