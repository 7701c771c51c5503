"""attn_bwd_roofline.finetune: kernels B5 (dK, dV) and B6 (dQ), summed,
against the roofline of the attention backward in the traced fit.  Each
call's least time is the larger of its bytes at the HBM rate (q, k, v
read once in bf16, the float32 output gradient read once, dq, dk and dv
written once in bf16) and its FLOPs at the bf16 peak (8 B H S^2 D: the
value and score gradients and the two products that give dq and dk,
nothing recomputed).  The kernel time is the device time of the kernels
named below."""
from perfbench.harness.device import BF16_FLOPS, HBM_BYTES_PER_S

NAME = "attn_bwd_roofline.finetune"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels B4, B5, B6"
MOVES = "train_step_ms"
KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")


def least_seconds(b, s, h, d):
    n = b * s * h * d
    nbytes = 3 * n * 2 + n * 4 + 3 * n * 2
    flops = 8.0 * b * h * s * s * d
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    cfg = view.config
    calls = sum(r.get("steps", 0) for r in view.traced) * \
        cfg["num_hidden_layers"]
    if not launches or seconds <= 0 or not calls:
        return None
    h, w = cfg["image_size"]
    s = (h // cfg["patch_size"]) * (w // cfg["patch_size"])
    heads = cfg["num_attention_heads"]
    shape = (int(view.mix["batch_size"]), s, heads,
             cfg["hidden_size"] // heads)
    return 100.0 * calls * least_seconds(*shape) / seconds
