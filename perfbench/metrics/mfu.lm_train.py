"""mfu.lm_train: the whole training step's share of the card's bf16 peak:
3 x the forward's FLOPs (forward, and a backward of twice its products)
over the window's sequences, from the plain reference's `forward_macs`
with the expert part counted from the (token, slot) pairs the held
experts computed (the calls' `held_pairs`) and attention counted
causally, over the calls' wall time, over 989 TFLOP/s (one H100 SXM,
dense bf16, at 700 W; the run prints the card's power limit)."""
from perfbench.harness.device import BF16_FLOPS

NAME = "mfu.lm_train"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "train_step_ms"


def read(view):
    sequences = sum(c.rec.get("steps", 0) for c in view.calls) * \
        int(view.mix["batch_size"])
    pairs = sum(c.rec.get("held_pairs", 0) for c in view.calls)
    seconds = sum(c.seconds for c in view.calls)
    if not sequences or not pairs or seconds <= 0:
        return None
    macs = view.family.forward_macs(view.config, pairs,
                                    int(view.mix["seq_len"]), sequences)
    return 100.0 * 3 * 2.0 * macs / seconds / BF16_FLOPS
