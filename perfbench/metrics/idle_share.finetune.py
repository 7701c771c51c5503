"""idle_share.finetune: the share of the traced window in which no
operation ran on the device (one minus the union of the device's
kernels, copies and memsets over the window, from the profiler)."""
NAME = "idle_share.finetune"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_step_ms"


def read(view):
    t = view.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
