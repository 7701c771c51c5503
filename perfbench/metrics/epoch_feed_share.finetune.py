"""epoch_feed_share.finetune: the share of the fits' epochs that the
step loop spent waiting for the feed's next slice (the program's
`feed.next` spans over its `deep_vision.epoch` spans): assembling the
batches on the host pipeline, allocating the pinned rings and enqueueing
the copies, whatever the steps did not hide.  The window's fits, as
`fit_setup_share.finetune` finds them."""
from perfbench.harness import spec

NAME = "epoch_feed_share.finetune"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "feed"
MOVES = "train_step_ms"


def read(view):
    fits_reader = spec.metric_reader("fit_setup_share.finetune")
    fits = fits_reader.window_fits(view)
    if fits is None:
        return None
    epochs = sum(fits_reader.seconds(f, fits_reader.EPOCH) for f in fits)
    if epochs <= 0:
        return None
    return 100.0 * sum(fits_reader.seconds(f, "feed.next")
                       for f in fits) / epochs
