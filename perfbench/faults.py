"""Faults planted in the program, to show that `correct` catches them:
the CPU tests plant each in a tiny run, and `calibrate.py` reads each at
a cell's own size on the card.

featurize: `altered` (every feature 5% off where the backbone produces
it); `half_batch` (the backbone runs on the first half of each chunk and
the second half gets copies of its answers).
finetune: `unchanged` (the optimizer step leaves the parameters as they
were); `half_batch` (the loss is the mean over the first half of each
batch); `altered` (one example's loss ten times what it is).
On one card there is no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["FAULTS", "plant"]

FAULTS = {"featurize": ("altered", "half_batch"),
          "finetune": ("unchanged", "half_batch", "altered")}


def _bundle_apply(wrap):
    from mmlspark_tpu_torch.models.bundle import TorchBundle

    orig = TorchBundle.__dict__["apply"]
    TorchBundle.apply = staticmethod(wrap(orig.__func__))
    return lambda: setattr(TorchBundle, "apply", orig)


def _altered_features(apply):
    def run(module, batch):
        taps = apply(module, batch)
        return dict(taps, pool=taps["pool"] * 1.05)
    return run


def _half_batch_features(apply):
    def run(module, batch):
        n = batch.shape[0]
        h = (n + 1) // 2
        taps = apply(module, batch[:h])
        return {k: torch.cat([t, t[:n - h]]) if t.dim() and t.shape[0] == h
                else t for k, t in taps.items()}
    return run


def _per_example_ce(wrap):
    from mmlspark_tpu_torch.models import training

    orig = training._per_example_ce
    training._per_example_ce = wrap(orig)
    return lambda: setattr(training, "_per_example_ce", orig)


def _half_batch_loss(ce):
    def run(logits, labels):
        out = ce(logits, labels)
        h = out.shape[0] // 2
        return torch.cat([2 * out[:h], 0 * out[h:]])
    return run


def _altered_loss(ce):
    def run(logits, labels):
        out = ce(logits, labels)
        return torch.cat([10 * out[:1], out[1:]])
    return run


def _unchanged_step():
    orig = torch.optim.SGD.step

    def step(self, closure=None):
        kept = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = orig(self, closure)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups
                             for p in g["params"]), kept):
                p.copy_(k)
        return out

    torch.optim.SGD.step = step
    return lambda: setattr(torch.optim.SGD, "step", orig)


_PLANT = {
    ("featurize", "altered"): lambda: _bundle_apply(_altered_features),
    ("featurize", "half_batch"): lambda: _bundle_apply(_half_batch_features),
    ("finetune", "unchanged"): _unchanged_step,
    ("finetune", "half_batch"): lambda: _per_example_ce(_half_batch_loss),
    ("finetune", "altered"): lambda: _per_example_ce(_altered_loss),
}


@contextlib.contextmanager
def plant(driver: str, fault: str):
    undo = _PLANT[(driver, fault)]()
    try:
        yield
    finally:
        undo()
