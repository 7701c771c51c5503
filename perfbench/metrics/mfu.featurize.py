"""mfu.featurize: the whole forward's share of the card's bf16 peak:
the model's FLOPs an image (2 x the multiply-accumulates of every
convolution or matrix product, counted from the configuration's layer
shapes by its plain reference) times the images a second of the window,
over 989 TFLOP/s (one H100 SXM, dense bf16, at 700 W; the run prints the
card's power limit)."""
from perfbench.harness.device import BF16_FLOPS

NAME = "mfu.featurize"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "images_per_s"


def read(view):
    if not view.calls or view.window_s <= 0:
        return None
    images = sum(c.rec["rows"] for c in view.calls)
    flops = 2.0 * view.family.forward_macs(view.config) * images
    return 100.0 * flops / view.window_s / BF16_FLOPS
