"""The finetune entry: `DeepVisionClassifier.fit` over one labelled image
table, `fit` calls in a closed loop.

Set-up draws the table from the seed, builds the estimator with the mix's
recipe and the run's seed (its initial weights and its shuffle come from
it) and warms up with one whole fit.  Every fit, the warm one and the
window's, records its first three optimizer steps as the optimizer sees
them: each step's loss, the gradient of step 1 (SGD's momentum trace
after one step is that gradient) and the parameters' change after step
3, each leaf's norm.  Recording wraps `TrainState.apply_gradients` and
the per-example loss of `models/training.py` and reads what they hold; it
adds a copy of the initial parameters and a few norms a fit.

`verify` derives the same three steps with the plain float32 reference
once the window has closed: the stage's initial weights from the seed
(`reference/vit.py`), its shuffle (`np.random.default_rng(seed)`, one
permutation an epoch), PIL's resize of the rows of another size and the
featurizer's normalisation (`reference/preprocess.py`), then loss,
gradients and SGD with momentum.  It compares every recorded fit with
them: the loss gap of each step relative to the reference's loss, and by
the worst leaf the gap between the program's and the reference's norms of
the first gradient and of the change after three steps, relative to the
larger of that leaf's reference norm and the median leaf's.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import data, spec
from perfbench.harness.spans import Spans
from perfbench.reference import preprocess
from perfbench.reference.precision import ieee_fp32

CALL = "fit"
STEPS = 3          # optimizer steps the reference follows
MICRO = 32         # rows a reference micro-batch
ROUND_OFF = 1e-3   # a leaf's gradient under this share of the median's


class _Record:
    def __init__(self):
        self.losses: List[torch.Tensor] = []
        self.grad_norms: Dict[str, torch.Tensor] = {}
        self.change_norms: Dict[str, torch.Tensor] = {}
        self.init: Dict[str, torch.Tensor] = {}


class Recorder:
    """Wraps the trainer's optimizer step and per-example loss for the
    first STEPS steps of every train state, until `close()`."""

    def __init__(self):
        from mmlspark_tpu_torch.models import training

        self.records: List[_Record] = []
        self._training = training
        self._ce = training._per_example_ce
        self._apply = training.TrainState.apply_gradients
        self._last_ce = None
        attr = f"_perfbench_record_{id(self)}"
        rec = self

        def per_example_ce(logits, labels):
            out = rec._ce(logits, labels)
            rec._last_ce = out.detach()
            return out

        def apply_gradients(state, grad_norm=True):
            if state.step == 0:
                setattr(state, attr, _Record())
                rec.records.append(getattr(state, attr))
                getattr(state, attr).init = {
                    n: p.detach().clone()
                    for n, p in state.module.named_parameters()}
            r = getattr(state, attr, None)
            out = rec._apply(state, grad_norm)
            if r is not None and state.step <= STEPS:
                r.losses.append(rec._last_ce.mean())
                names = [n for n, _p in state.module.named_parameters()]
                params = [p.detach() for p in state.module.parameters()]
                if state.step == 1:
                    bufs = [state.optimizer.state[p].get("momentum_buffer")
                            for p in state.module.parameters()]
                    if all(b is not None for b in bufs):
                        r.grad_norms = dict(zip(names,
                                                torch._foreach_norm(bufs)))
                if state.step == STEPS:
                    diffs = torch._foreach_sub(params,
                                               [r.init[n] for n in names])
                    r.change_norms = dict(zip(names,
                                              torch._foreach_norm(diffs)))
                    r.init = {}
            return out

        training._per_example_ce = per_example_ce
        training.TrainState.apply_gradients = apply_gradients

    def close(self) -> None:
        self._training._per_example_ce = self._ce
        self._training.TrainState.apply_gradients = self._apply


class FinetuneCell:
    def __init__(self, ctx):
        from mmlspark_tpu_torch.core.schema import Table
        from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

        self.ctx = ctx
        cfg, mix = ctx.config, ctx.mix
        self.family = spec.family_module(cfg)
        self.table = data.image_tables(mix, ctx.seed, torch.device(ctx.device))[0]
        self.recorder = Recorder()
        h, w = cfg["image_size"]
        self.estimator = DeepVisionClassifier(
            backbone=cfg["port"]["builder"], height=h, width=w,
            batch_size=int(mix["batch_size"]), epochs=int(mix["epochs"]),
            learning_rate=float(mix["learning_rate"]),
            momentum=float(mix["momentum"]), seed=ctx.seed,
            device=ctx.device)
        self.input = Table({"image": self.table.column(),
                            "label": self.table.labels})
        self.steps = -(-len(self.table.rows) // int(mix["batch_size"])) \
            * int(mix["epochs"])
        self.spans = Spans()
        if ctx.trace:
            _annotate(self.spans)
        self.call()

    def call(self) -> Dict[str, object]:
        model = self.estimator.fit(self.input)
        losses = model.loss_history or []
        ok = len(losses) == int(self.ctx.mix["epochs"]) and all(
            np.isfinite(losses))
        return {"rows": len(self.table.rows) * int(self.ctx.mix["epochs"]),
                "steps": self.steps, "ok": bool(ok)}

    def counters(self) -> Dict[str, object]:
        return {}

    def release(self) -> None:
        self.spans.undo()
        self.recorder.close()
        self.estimator = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_steps(self, quant=None) -> Tuple[List[float], Dict, Dict]:
        """(losses, first-gradient norms, change norms after STEPS steps)
        of the plain reference, by leaf name."""
        cfg, mix = self.ctx.config, self.ctx.mix
        dev = torch.device(self.ctx.device)
        h, wd = cfg["image_size"]
        bs = int(mix["batch_size"])
        order = np.random.default_rng(self.ctx.seed).permutation(
            len(self.table.rows))
        w0 = {k: v.to(dev) for k, v in
              self.family.init_weights(cfg, self.ctx.seed).items()}
        w, buf, losses, g1 = dict(w0), {}, [], None
        labels = torch.from_numpy(np.asarray(self.table.labels)).to(dev)
        with ieee_fp32():
            for step in range(STEPS):
                sel = order[step * bs:(step + 1) * bs]

                def images(lo, hi, sel=sel):
                    rows = [self._resized(int(i), h, wd) for i in sel[lo:hi]]
                    x = torch.stack(rows).to(dev)
                    return preprocess.resize_normalize(x, h, wd)

                loss, grads = self.family.loss_and_grads(
                    w, images, labels[torch.from_numpy(sel).to(dev)], cfg,
                    MICRO, quant)
                losses.append(loss)
                if g1 is None:
                    g1 = {k: float(g.norm()) for k, g in grads.items()}
                self.family.sgd_momentum_step(
                    w, buf, grads, float(mix["learning_rate"]),
                    float(mix["momentum"]))
        change = {k: float((w[k] - w0[k]).norm()) for k in w}
        return losses, g1, change

    def _resized(self, i: int, h: int, w: int) -> torch.Tensor:
        x = torch.from_numpy(self.table.rows[i]).to(self.ctx.device)
        return preprocess.pil_bicubic_resize(x[None], h, w)[0]

    def verify(self, control=None) -> List[Tuple[str, float, float]]:
        """The numbers compared; with `control` (a rounding function) the
        reference computed at that precision takes the program's place."""
        records = self.recorder.records
        if control is not None:
            losses, g1, change = self.reference_steps(control)
            r = _Record()
            r.losses = [torch.tensor(x) for x in losses]
            r.grad_norms = {k: torch.tensor(v) for k, v in g1.items()}
            r.change_norms = {k: torch.tensor(v) for k, v in change.items()}
            records = [r]
        losses, g1, change = self.reference_steps()
        self.left_out = round_off_leaves(g1)
        return compare(records, losses, g1, change, self.ctx.limits)


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    if not names or any(n not in prog for n in names):
        return float("inf")
    median = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


def round_off_leaves(ref_g1: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is under ROUND_OFF of the
    median leaf's: they move by round-off alone."""
    median = float(np.median(list(ref_g1.values())))
    return sorted(n for n, g in ref_g1.items() if g < ROUND_OFF * median)


def compare(records, ref_losses, ref_g1, ref_change, limits
            ) -> List[Tuple[str, float, float]]:
    """The three numbers compared, each the worst over the recorded fits."""
    left_out = set(round_off_leaves(ref_g1))

    def moved(n):
        return n not in left_out

    loss_gap = grad_gap = change_gap = 0.0 if records else float("inf")
    for r in records:
        losses = [float(x) for x in r.losses]
        if len(losses) < len(ref_losses):
            loss_gap = grad_gap = change_gap = float("inf")
            continue
        loss_gap = max(loss_gap, max(abs(a - b) / abs(b) for a, b in
                                     zip(losses, ref_losses)))
        grad_gap = max(grad_gap, _leaf_gap(
            {k: float(v) for k, v in r.grad_norms.items()}, ref_g1))
        change_gap = max(change_gap, _leaf_gap(
            {k: float(v) for k, v in r.change_norms.items()}, ref_change,
            moved))
    return [("loss_gap", loss_gap, float(limits["loss_gap"])),
            ("grad_norm_gap", grad_gap, float(limits["grad_norm_gap"])),
            ("change_norm_gap", change_gap, float(limits["change_norm_gap"]))]


def _annotate(spans: Spans) -> None:
    """The program's own span annotations, and the benchmark's spans
    around the fit's layers: decoding the column, the host pipelines by
    their stages ("resize": rows of other sizes; "assemble": an epoch's
    batches, consumed by its steps, so it spans the epoch), initialising
    the module, the train state, the bundle of the result."""
    from mmlspark_tpu_torch.core.telemetry.device import (
        enable_device_annotations)
    from mmlspark_tpu_torch.io import pipeline
    from mmlspark_tpu_torch.models import bundle, deep_vision, training

    enable_device_annotations()
    spans.wrap(deep_vision, "_decode_column", "fit.decode_column")
    spans.wrap(pipeline.HostPipeline, "run",
               lambda pipe, *_a: "fit.pipeline." + "+".join(
                   s.name for s in pipe.stages), generator=True)
    spans.wrap(deep_vision, "_initial_state", "fit.initial_state")
    spans.wrap(training.TrainState, "create", "fit.train_state")
    spans.wrap(bundle.TorchBundle, "from_module", "fit.bundle_from_module")


def setup(ctx) -> FinetuneCell:
    return FinetuneCell(ctx)
