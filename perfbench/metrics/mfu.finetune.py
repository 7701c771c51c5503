"""mfu.finetune: the whole training step's share of the card's bf16
peak: 3 x the forward's FLOPs (forward, and a backward of twice its
products) for every row of every step, over the fits' wall time, over
989 TFLOP/s (one H100 SXM, dense bf16, at 700 W; the run prints the
card's power limit)."""
from perfbench.harness.device import BF16_FLOPS

NAME = "mfu.finetune"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "train_step_ms"


def read(view):
    rows = sum(c.rec.get("steps", 0) for c in view.calls) * \
        int(view.mix["batch_size"])
    seconds = sum(c.seconds for c in view.calls)
    if not rows or seconds <= 0:
        return None
    flops = 3 * 2.0 * view.family.forward_macs(view.config) * rows
    return 100.0 * flops / seconds / BF16_FLOPS
