"""DeepVisionClassifier: end-to-end backbone fine-tuning as a pipeline stage.

Counterpart of the JAX package's `models/deep_vision.py` on one card:
the same Params and defaults (resnet18, 32x32, batch 64, SGD 0.05 /
momentum 0.9, ImageNet normalisation, seed 0), the same class mapping
(sorted label values), the same shuffle stream
(`np.random.default_rng(seed)`, one permutation an epoch) and the same
tail handling (the last batch padded to the full batch size with -1
labels of zero loss weight).  The input column takes image rows, HWC
arrays and encoded bytes; bytes decode through the port's own decoder
(`io.image.decode_cells`: libjpeg where its headers exist, nvJPEG with
the C2 kernel on the card's machine, PIL for other formats).  A training
row whose size differs from (height, width) is resized on the host by
PIL's `Image.resize((width, height))` with its default filter, on the
BGR -> RGB -> BGR round trip, on HostPipeline workers — the JAX
package's own call (PIL imports on both machines), so the pixels are
its pixels; rows already at that size skip the pipeline.  Each step
runs, as the JAX step does, `ImagePreprocess` (kernel B1 on the card:
cast, resize, normalise) -> the backbone in
train mode (bf16 compute over f32 state, models/training.py) -> weighted
softmax cross-entropy -> backward -> SGD.  Each epoch is fed in slices
of stacked uint8 batches through `DeviceFeed.stream`.

With `checkpoint_dir` the fit saves the state after each epoch, at step
= epochs completed (models/checkpoint.py: verified, synchronous), and a
fit on a directory that holds a checkpoint restores the latest one,
skips the epochs it covers and replays their shuffle draws, so a fit
resumed after an interruption ends where an uninterrupted fit ends.
The fit builds the backbone on the meta device and places it on its
device uninitialised (`bundle.DirectInit`) wherever `init_state_dict`'s
walk writes every parameter and buffer of the module (every registered
backbone): a background thread draws the initial weights from the seed
into one flat host buffer (pinned on the card) while the fit decodes and
stacks its rows, and one copy lands them, the same bits as
`init_state_dict` on a module the builder made.  Any other module (a
builder with a tensor the walk does not know) is built by its builder on
the host and initialised by `init_state_dict`, then moved.

A fit records its layers as spans of one trace: the root
`deep_vision.fit` (attributes backbone, rows, epochs, steps) over
`deep_vision.build` (the builder's constructor),
`deep_vision.draw` (attribute `bytes`; the direct path's draw, on its
thread), `deep_vision.decode`, `deep_vision.rows` (attribute `resized`:
the rows that went through the resize pipeline), `deep_vision.init`
(`_initial_state`; attribute `init_path`, "direct" or "module"),
`deep_vision.train_state`, one `deep_vision.epoch` an epoch,
`deep_vision.checkpoint` (with `checkpoint_dir`) and
`deep_vision.bundle`.  In an epoch each step's dispatch is a
`training.step` span, each wait for the feed's next slice a `feed.next`
span, and on the card each step's device time a `training.step.device`
span (`training.StepEvents`: timing events read after the epoch's loss
read, which already waits for the card).

`DeepVisionModel` scores through the port's `TorchModel` (B1 and the
bf16 forward); ragged sizes at scoring time are resized on the device.
The backbones are the registered vision builders: the ResNets, the ViTs
and the convnets of `models/convnets.py` (alexnet, vgg11, vgg16,
convnet_cifar; their dropout runs in the fit's train mode).
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name
from ..device import resolve_device
from ..io.image import decode_cells, image_row_to_array
from .bundle import (DirectInit, TorchBundle, _builder_kwargs, get_builder,
                     init_state_dict)
from .image_featurizer import IMAGENET_MEAN_BGR, IMAGENET_STD_BGR
from .torch_model import ImagePreprocess, TorchModel

__all__ = ["DeepVisionClassifier", "DeepVisionModel"]

def _decode_column(col) -> List[Optional[np.ndarray]]:
    """Image rows / encoded bytes / arrays -> HWC uint8 arrays (None for
    undecodable rows) — the ImageFeaturizer host contract."""
    cells = decode_cells(col)
    return [None if c is None else image_row_to_array(c) for c in cells]


def _to_hw(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Gray -> 3 channels, BGRA -> BGR, then a row of another size than
    (h, w) resized by PIL's default filter, as the JAX package does."""
    if a.ndim == 2:
        a = a[:, :, None]
    if a.shape[2] == 1:
        a = np.repeat(a, 3, axis=2)
    elif a.shape[2] > 3:
        a = a[:, :, :3]
    if a.shape[:2] == (h, w):
        return a
    from PIL import Image

    img = Image.fromarray(np.ascontiguousarray(a[:, :, ::-1]))  # BGR->RGB
    return np.asarray(img.resize((w, h)))[:, :, ::-1]


def _draw(direct: DirectInit, seed: int, pin_memory: bool, ctx
          ) -> Tuple[DirectInit, torch.Tensor]:
    """The direct path's draw, run on the fit's background thread as a
    `deep_vision.draw` span under the fit's root (`ctx`)."""
    with core_telemetry.span("deep_vision.draw", parent_ctx=ctx,
                             bytes=4 * direct.numel):
        return direct, direct.draw(seed, pin_memory=pin_memory)


def _initial_state(module: torch.nn.Module, seed: int,
                   draw: Optional[Future] = None) -> None:
    """The fit's initial weights: flax-style random init from `seed`
    (`bundle.init_state_dict`'s bits).  `draw`, on the direct path, is the
    future of `_draw` for `module`: this waits for it (raising what the
    draw raised) and lands it on the module's device."""
    if draw is None:
        init_state_dict(module, seed)
        return
    direct, flat = draw.result()
    direct.land(flat)


def _preprocess(height: int, width: int, normalize: bool) -> ImagePreprocess:
    mean = tuple(IMAGENET_MEAN_BGR) if normalize else None
    std = tuple(IMAGENET_STD_BGR) if normalize else None
    return ImagePreprocess(height, width, mean=mean, std=std)


@register_stage
class DeepVisionClassifier(Estimator):
    """Fine-tune a registered vision backbone (resnet18/34/50/101/152,
    alexnet, vgg11/16, convnet_cifar, vit_tiny/small/base) on (image,
    label) rows on one card."""

    backbone = Param("any registered vision builder (resnet18/34/50/101/152, "
                     "alexnet, vgg11/16, convnet_cifar, vit_tiny/small/base)",
                     default="resnet18")
    input_col = Param("image column (image rows / encoded bytes / arrays)",
                      default="image")
    label_col = Param("label column", default="label")
    prediction_col = Param("prediction column", default="prediction")
    probability_col = Param("probability column", default="probability")
    height = Param("training input height", default=32,
                   converter=TypeConverters.to_int)
    width = Param("training input width", default=32,
                  converter=TypeConverters.to_int)
    epochs = Param("training epochs", default=5, converter=TypeConverters.to_int)
    batch_size = Param("global batch size", default=64,
                       converter=TypeConverters.to_int)
    learning_rate = Param("SGD learning rate", default=0.05,
                          converter=TypeConverters.to_float)
    momentum = Param("SGD momentum", default=0.9,
                     converter=TypeConverters.to_float)
    normalize = Param("apply ImageNet mean/std normalization", default=True,
                      converter=TypeConverters.to_bool)
    seed = Param("shuffle/init seed", default=0, converter=TypeConverters.to_int)
    drop_na = Param("drop undecodable rows", default=True,
                    converter=TypeConverters.to_bool)
    checkpoint_dir = Param("checkpoint directory: saves per epoch and "
                           "resumes an interrupted fit from the latest step "
                           "(models/checkpoint.py)", default="")
    device = Param("'cuda' (default) or 'cpu'; without CUDA only an explicit "
                   "'cpu' runs", default=None)

    def _fit(self, table: Table) -> "DeepVisionModel":
        with core_telemetry.span("deep_vision.fit",
                                 backbone=self.backbone) as root:
            return self._fit_traced(table, root)

    def _fit_traced(self, table: Table, root) -> "DeepVisionModel":
        from ..io.feed import DeviceFeed
        from ..io.pipeline import HostPipeline, PipelineStage, pipeline_workers
        from .training import (StepEvents, TrainState, _per_example_ce,
                               scan_slice_steps, sgd)

        span = core_telemetry.span
        device = resolve_device(self.device)
        labels_raw = np.asarray(table[self.label_col])
        classes = sorted({v for v in labels_raw.tolist()})
        class_of = {v: i for i, v in enumerate(classes)}
        num_classes = len(classes)

        h, w = int(self.height), int(self.width)
        seed = int(self.seed)
        kwargs = _builder_kwargs(self.backbone, {"num_classes": num_classes},
                                 (h, w, 3))
        with span("deep_vision.build"):
            direct = DirectInit.build(self.backbone, kwargs, device)
            module = (get_builder(self.backbone)(**kwargs) if direct is None
                      else direct.module)
        # the direct path draws the weights on a background thread while
        # this one decodes and stacks the rows (both release the GIL)
        with ThreadPoolExecutor(1, thread_name_prefix="deep_vision.draw") \
                as pool:
            draw = None if direct is None else pool.submit(
                _draw, direct, seed, device.type == "cuda",
                core_telemetry.current_context())
            x, y = self._training_rows(table, labels_raw, class_of, h, w)
            root.attrs["rows"] = len(x)
            with span("deep_vision.init",
                      init_path="module" if direct is None else "direct"):
                _initial_state(module, seed, draw)
        with span("deep_vision.train_state"):
            state = TrainState.create(
                module, sgd(float(self.learning_rate), float(self.momentum)),
                compute_dtype="bfloat16", device=device)
        pre = _preprocess(h, w, self.normalize)

        def step(images_u8: torch.Tensor, labels: torch.Tensor):
            logits, _taps = state.work.train()(pre(images_u8))
            # -1 labels are batch padding: zero loss weight
            wgt = (labels >= 0).float()
            loss = (_per_example_ce(logits, labels) * wgt).sum() \
                / wgt.sum().clamp(min=1.0)
            loss.backward()
            state.apply_gradients(grad_norm=False)
            return loss.detach()

        step = core_telemetry.watch_compiles(step, name="deep_vision.epoch")
        bs = max(1, int(self.batch_size))
        rng = np.random.default_rng(int(self.seed))
        ckpt = None
        start_epoch = 0
        if self.checkpoint_dir:
            from .checkpoint import CheckpointManager

            ckpt = CheckpointManager(self.checkpoint_dir)
            latest = ckpt.latest_step()
            if latest is not None:
                # the manager's step IS the completed-epoch count, so a
                # resume never depends on this run's batch math; a dir
                # checkpointed at >= epochs yields zero further epochs
                # (clear it to retrain from scratch)
                with span("deep_vision.checkpoint", op="restore"):
                    ckpt.restore(latest, template=state)
                start_epoch = min(int(latest), int(self.epochs))
        # the shuffle stream must be reproducible across a resume: replay
        # the epochs already consumed
        for _ in range(start_epoch):
            rng.permutation(len(x))
        n_steps = -(-len(x) // bs)
        k = scan_slice_steps(n_steps, bs * int(np.prod(x.shape[1:])) + bs * 4)
        root.attrs["epochs"] = int(self.epochs) - start_epoch
        root.attrs["steps"] = n_steps * (int(self.epochs) - start_epoch)
        feed = DeviceFeed(device)
        events = StepEvents(device)
        history = []
        for _epoch in range(start_epoch, int(self.epochs)):
            order = rng.permutation(len(x))
            # pad the tail batch to the full batch size; -1 labels carry
            # zero loss
            pad = n_steps * bs - len(order)
            idx = np.concatenate([order, order[-1:].repeat(pad)])
            ypad = np.concatenate([y[order], np.full(pad, -1, np.int32)])

            def assemble(bounds, idx=idx, ypad=ypad):
                s, e = bounds
                sel = idx[s * bs:e * bs]
                return (x[sel].reshape(e - s, bs, *x.shape[1:]),
                        ypad[s * bs:e * bs].reshape(e - s, bs))

            pipe = HostPipeline([PipelineStage(
                "assemble", assemble, workers=pipeline_workers(2))])
            bounds = [(s, min(s + k, n_steps)) for s in range(0, n_steps, k)]
            with span("deep_vision.epoch", epoch=_epoch):
                slices = feed.stream(pipe.run(bounds))
                losses = []
                while True:
                    with span("feed.next"):
                        batch = next(slices, None)
                    if batch is None:
                        break
                    dxb, dyb = batch
                    for i in range(dxb.shape[0]):
                        with span("training.step"), events.step():
                            losses.append(step(dxb[i], dyb[i]))
                events.anchor()
                # the one host read of the epoch: it waits for the card
                history.append(float(torch.stack(losses).mean()))
                events.flush(time.time())
            if ckpt is not None:
                with span("deep_vision.checkpoint", op="save"):
                    ckpt.save(state, step=_epoch + 1)

        with span("deep_vision.bundle"):
            bundle = TorchBundle.from_module(self.backbone, state.module,
                                             kwargs, input_shape=(h, w, 3))
        return DeepVisionModel(
            bundle=bundle, classes=list(classes), input_col=self.input_col,
            prediction_col=self.prediction_col,
            probability_col=self.probability_col, height=h, width=w,
            normalize=self.normalize, loss_history=history,
            device=self.device)

    def _training_rows(self, table: Table, labels_raw: np.ndarray,
                       class_of: dict, h: int, w: int):
        """The decodable rows as one (n, h, w, 3) uint8 stack, and their
        class indices."""
        from ..io.pipeline import HostPipeline, PipelineStage, pipeline_workers

        span = core_telemetry.span
        with span("deep_vision.decode"):
            arrays = _decode_column(table[self.input_col])
        keep = [i for i, a in enumerate(arrays) if a is not None]
        if len(keep) < len(arrays) and not self.drop_na:
            raise ValueError("DeepVisionClassifier: undecodable rows and "
                             "drop_na=False")
        if not keep:
            raise ValueError("DeepVisionClassifier: no decodable training "
                             "rows in the input table")
        y = np.asarray([class_of[labels_raw[i].item()
                                 if hasattr(labels_raw[i], "item")
                                 else labels_raw[i]] for i in keep], np.int32)
        with span("deep_vision.rows") as sp:
            # PIL's resize releases the GIL: rows of another size run
            # thread-parallel through the input pipeline (order-preserving);
            # rows already at (h, w) take _to_hw inline
            other = [i for i in keep if arrays[i].shape[:2] != (h, w)]
            resized = {}
            if other:
                resize_pipe = HostPipeline([PipelineStage(
                    "resize", lambda i: _to_hw(arrays[i], h, w),
                    workers=pipeline_workers() if len(other) > 32 else 1)])
                resized = dict(zip(other, resize_pipe.run(other)))
            x = np.stack([resized[i] if i in resized
                          else _to_hw(arrays[i], h, w)
                          for i in keep]).astype(np.uint8)
            sp.attrs["resized"] = len(other)
        return x, y

    def transform_schema(self, columns: List[str]) -> List[str]:
        return list(columns) + [self.prediction_col, self.probability_col]


@register_stage
class DeepVisionModel(Model):
    """Fitted backbone: scores through the TorchModel executor (shared
    executor cache, pinned feed, B1 preprocessing on the card)."""

    bundle = ComplexParam("fine-tuned TorchBundle")
    classes = ComplexParam("label values by class index")
    input_col = Param("image column", default="image")
    prediction_col = Param("prediction column", default="prediction")
    probability_col = Param("probability column", default="probability")
    height = Param("input height", default=32, converter=TypeConverters.to_int)
    width = Param("input width", default=32, converter=TypeConverters.to_int)
    normalize = Param("ImageNet normalization", default=True,
                      converter=TypeConverters.to_bool)
    loss_history = ComplexParam("per-epoch mean training loss", default=None)
    device = Param("'cuda' (default) or 'cpu'; without CUDA only an explicit "
                   "'cpu' runs", default=None)

    def _transform(self, table: Table) -> Table:
        arrays = _decode_column(table[self.input_col])
        keep = np.array([a is not None for a in arrays])
        table = table.filter(keep)
        arrays = [a for a in arrays if a is not None]
        tmp = find_unused_column_name("__dv_feed__", table.column_names)
        feed = table.with_column(
            tmp, arrays if arrays else np.zeros(
                (0, self.height, self.width, 3), np.uint8))
        pre = _preprocess(int(self.height), int(self.width), self.normalize)
        logits_col = find_unused_column_name("__dv_logits__",
                                             table.column_names)
        scored = TorchModel(
            bundle=self.bundle, input_col=tmp, output_col=logits_col,
            fetch_node="logits", batch_size=64, preprocess=pre,
            group_by_shape=True, feed_dtype="uint8", device=self.device,
        ).transform(feed).drop(tmp)
        if len(scored) == 0:
            out = scored.drop(logits_col)
            out = out.with_column(self.probability_col,
                                  np.zeros((0, len(self.classes)), np.float32))
            return out.with_column(
                self.prediction_col,
                np.empty(0, dtype=np.asarray(self.classes).dtype))
        logits = np.stack(list(scored[logits_col])).astype(np.float32)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        preds = np.asarray(self.classes)[np.argmax(probs, axis=1)]
        out = scored.drop(logits_col)
        out = out.with_column(self.probability_col, probs)
        return out.with_column(self.prediction_col, preds)

    def transform_schema(self, columns: List[str]) -> List[str]:
        return list(columns) + [self.prediction_col, self.probability_col]
