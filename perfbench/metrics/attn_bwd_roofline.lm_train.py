"""attn_bwd_roofline.lm_train: kernels B5 (dK, dV) and B6 (dQ), summed,
against the roofline of the causal attention backward in the traced
calls of an LM cell.  Each call is (B, S, H, D) as in
attn_fwd_roofline.lm_train; its least time is the larger of its bytes at
the HBM rate (q, k, v and the output gradient read once in bf16, dq, dk
and dv written once in float32) and its FLOPs at the bf16 peak (8 B H D
S (S + 1) / 2: the value and score gradients and the two products that
give dq and dk over the causal triangle, nothing recomputed).  The
kernel time is the device time of the kernels named below."""
from perfbench.harness.device import BF16_FLOPS, HBM_BYTES_PER_S

NAME = "attn_bwd_roofline.lm_train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels B4, B5, B6"
MOVES = "train_step_ms"
KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")


def least_seconds(b, s, h, d):
    n = b * s * h * d
    nbytes = 4 * n * 2 + 3 * n * 4
    flops = 8.0 * b * h * d * s * (s + 1) / 2
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    cfg = view.config
    layers = cfg.get("layer_types", []).count("full_attention")
    calls = sum(r.get("steps", 0) for r in view.traced) * layers
    if not launches or seconds <= 0 or not calls:
        return None
    heads = cfg["num_attention_heads"]
    shape = (int(view.mix["batch_size"]), int(view.mix["seq_len"]), heads,
             cfg["hidden_size"] // heads)
    return 100.0 * calls * least_seconds(*shape) / seconds
