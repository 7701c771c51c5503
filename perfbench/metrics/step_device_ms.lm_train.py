"""step_device_ms.lm_train: the median optimizer step on the card, from
the program's `training.step.device` records of the window's epochs:
each step's time between a timing event recorded on the compute stream
as it starts and one after its update, read after the epoch's one host
read of its losses.  A call's record names its epoch's trace
(`epoch_trace`); the feed, the loss read and the host's gaps between
steps are outside the steps.  On a CPU the program records no such
steps and this reads nothing."""
import statistics

NAME = "step_device_ms.lm_train"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "model step"
MOVES = "train_step_ms"


def read(view):
    try:
        from mmlspark_tpu_torch.core.telemetry import get_trace
    except ImportError:
        return None
    steps = [s["wall_s"] for c in view.calls if c.rec.get("epoch_trace")
             for s in get_trace(c.rec["epoch_trace"])
             if s["name"] == "training.step.device"]
    if not steps:
        return None
    return 1e3 * statistics.median(steps)
