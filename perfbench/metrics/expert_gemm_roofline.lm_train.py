"""expert_gemm_roofline.lm_train: the held experts' grouped products
against their roofline in the traced calls.  A step runs, in each expert
layer, three products over the layer's held (token, slot) pairs P:
X [P, 2048] x w1, w3 [2048, 1792] and H [P, 1792] x w2 [1792, 2048], and
in the backward two more for each (the input's and the weight's
gradient), nine in all, each 2 P K N FLOPs.  Each product's least time is
the larger of its FLOPs at the bf16 peak and its bytes at the HBM rate:
the held experts' slabs of the weight read or written once, and the
pairs' rows of its two other operands, in bf16.  P is the traced calls'
`held_pairs` over their expert layers and steps, the mean a layer.  The
kernel time is the device time of the kernels whose names hold one of
KERNELS: on the card `torch._grouped_mm` launches, for each product, a
CUTLASS grouped GEMM, which the profiler names by its mangled name
(`..._ZN7cutlass13device_kernel...GroupProblemShape...`), and the small
`prepare_grouped_gemm_data` kernel that sets up its groups."""
from perfbench.harness.device import BF16_FLOPS, HBM_BYTES_PER_S

NAME = "expert_gemm_roofline.lm_train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "expert layer"
MOVES = "train_step_ms"
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def product_seconds(pairs: float, k: int, n: int, experts: int) -> float:
    """The least time of one grouped product of `pairs` rows of width k
    against `experts` [k, n] slabs (or of a backward product over the
    same three operands)."""
    flops = 2.0 * pairs * k * n
    nbytes = 2.0 * (experts * k * n + pairs * (k + n))
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def least_seconds(cfg: dict, held_pairs: float, layer_steps: int) -> float:
    """The roofline time of all the grouped products of `layer_steps`
    (expert layer, step) pairs that computed `held_pairs` pairs."""
    if not layer_steps:
        return 0.0
    p = held_pairs / layer_steps
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e = int(cfg["num_experts"])
    per_layer = 3 * (2 * product_seconds(p, d, f, e)
                     + product_seconds(p, f, d, e))
    return layer_steps * per_layer


def read(view):
    if view.trace is None:
        return None
    seconds, launches = view.trace.kernel_seconds(KERNELS)
    cfg = view.config
    expert_layers = len(cfg["layer_types"]) - int(cfg["num_dense_layers"])
    steps = sum(r.get("steps", 0) for r in view.traced)
    pairs = sum(r.get("held_pairs", 0) for r in view.traced)
    if not launches or seconds <= 0 or not pairs:
        return None
    return 100.0 * least_seconds(cfg, pairs, steps * expert_layers) / seconds
