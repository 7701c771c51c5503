"""step_device_ms.finetune: the median optimizer step on the card, from
the program's `training.step.device` records: each step's time between
a timing event recorded on the compute stream as it starts and one after
its update, read once the epoch's loss read has waited for the card.
Set-up, the feed and the host's gaps between steps are outside it.  The
window's fits, as `fit_setup_share.finetune` finds them; on a CPU the
program records no such steps and this reads nothing."""
import statistics

from perfbench.harness import spec

NAME = "step_device_ms.finetune"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "model step"
MOVES = "train_step_ms"


def read(view):
    fits = spec.metric_reader("fit_setup_share.finetune").window_fits(view)
    if fits is None:
        return None
    steps = [s["wall_s"] for f in fits for s in f
             if s["name"] == "training.step.device"]
    if not steps:
        return None
    return 1e3 * statistics.median(steps)
