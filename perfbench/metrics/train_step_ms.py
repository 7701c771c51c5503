"""train_step_ms: the fits' whole wall time over all their optimizer
steps; what a fit does besides its steps (decoding, resizing, building
and initialising the module, copying the weights back) counts, because
users pay it."""
NAME = "train_step_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(view):
    steps = sum(c.rec.get("steps", 0) for c in view.calls)
    if not steps:
        return None
    return sum(c.seconds for c in view.calls) / steps * 1e3
