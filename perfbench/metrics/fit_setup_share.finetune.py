"""fit_setup_share.finetune: the share of the fits' time outside their
epochs: decoding, stacking the rows, building, initialising and placing
the module, copying the weights back.  It reads the program's own spans
(`deep_vision.fit` and its `deep_vision.epoch` children) from the span
ring of this process, for the untraced window's fits: the
`len(view.calls)` fits just before the traced ones, so set-up's warm fit
and the traced fit are left out.  `window_fits` is shared with the other
readers of these spans."""
NAME = "fit_setup_share.finetune"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "fit set-up"
MOVES = "train_step_ms"

ROOT = "deep_vision.fit"
EPOCH = "deep_vision.epoch"


def window_fits(view):
    """The spans of each of the window's fits, one list a fit in the
    order they ran, each holding its root and its epochs; None when the
    program records no such spans or the ring holds fewer fits."""
    try:
        from mmlspark_tpu_torch.core.telemetry import recent_spans
    except ImportError:
        return None
    ring = recent_spans()
    roots = [s for s in ring if s["name"] == ROOT]
    n, skip = len(view.calls), len(view.traced)
    if n == 0 or len(roots) < n + skip:
        return None
    chosen = roots[len(roots) - skip - n:len(roots) - skip]
    fits = {r["trace_id"]: [] for r in chosen}
    for s in ring:
        if s["trace_id"] in fits:
            fits[s["trace_id"]].append(s)
    out = [fits[r["trace_id"]] for r in chosen]
    for root, spans in zip(chosen, out):
        epochs = sum(1 for s in spans if s["name"] == EPOCH)
        if epochs != (root.get("attrs") or {}).get("epochs", epochs) \
                or not epochs:
            return None
    return out


def seconds(spans, name):
    return sum(s["wall_s"] for s in spans if s["name"] == name)


def read(view):
    fits = window_fits(view)
    if fits is None:
        return None
    total = sum(seconds(f, ROOT) for f in fits)
    if total <= 0:
        return None
    return 100.0 * (total - sum(seconds(f, EPOCH) for f in fits)) / total
