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
its pixels.  Each step runs, as the JAX step does, `ImagePreprocess`
(kernel B1 on the card: cast, resize, normalise) -> the backbone in
train mode (bf16 compute over f32 state, models/training.py) -> weighted
softmax cross-entropy -> backward -> SGD.  Each epoch is fed in slices
of stacked uint8 batches through `DeviceFeed.stream`.

With `checkpoint_dir` the fit saves the state after each epoch, at step
= epochs completed (models/checkpoint.py: verified, synchronous), and a
fit on a directory that holds a checkpoint restores the latest one,
skips the epochs it covers and replays their shuffle draws, so a fit
resumed after an interruption ends where an uninterrupted fit ends.
`DeepVisionModel` scores through the port's `TorchModel` (B1 and the
bf16 forward); ragged sizes at scoring time are resized on the device.
The backbones are the registered vision builders: the ResNets, the ViTs
and the convnets of `models/convnets.py` (alexnet, vgg11, vgg16,
convnet_cifar; their dropout runs in the fit's train mode).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name
from ..device import resolve_device
from ..io.image import decode_cells, image_row_to_array
from .bundle import TorchBundle, _builder_kwargs, get_builder, init_state_dict
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


def _initial_state(module: torch.nn.Module, seed: int) -> None:
    """The fit's initial weights: flax-style random init from `seed`."""
    init_state_dict(module, seed)


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
        from ..io.feed import DeviceFeed
        from ..io.pipeline import HostPipeline, PipelineStage, pipeline_workers
        from .training import (TrainState, _per_example_ce, scan_slice_steps,
                               sgd)

        device = resolve_device(self.device)
        labels_raw = np.asarray(table[self.label_col])
        classes = sorted({v for v in labels_raw.tolist()})
        class_of = {v: i for i, v in enumerate(classes)}
        num_classes = len(classes)

        arrays = _decode_column(table[self.input_col])
        keep = [i for i, a in enumerate(arrays) if a is not None]
        if len(keep) < len(arrays) and not self.drop_na:
            raise ValueError("DeepVisionClassifier: undecodable rows and "
                             "drop_na=False")
        if not keep:
            raise ValueError("DeepVisionClassifier: no decodable training "
                             "rows in the input table")
        h, w = int(self.height), int(self.width)
        y = np.asarray([class_of[labels_raw[i].item()
                                 if hasattr(labels_raw[i], "item")
                                 else labels_raw[i]] for i in keep], np.int32)
        # PIL's resize releases the GIL: the ragged-input fixups run
        # thread-parallel through the input pipeline (order-preserving)
        resize_pipe = HostPipeline([PipelineStage(
            "resize", lambda i: _to_hw(arrays[i], h, w),
            workers=pipeline_workers() if len(keep) > 32 else 1)])
        x = np.stack(list(resize_pipe.run(keep))).astype(np.uint8)

        kwargs = _builder_kwargs(self.backbone, {"num_classes": num_classes},
                                 (h, w, 3))
        module = get_builder(self.backbone)(**kwargs)
        _initial_state(module, int(self.seed))
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
                ckpt.restore(latest, template=state)
                start_epoch = min(int(latest), int(self.epochs))
        # the shuffle stream must be reproducible across a resume: replay
        # the epochs already consumed
        for _ in range(start_epoch):
            rng.permutation(len(x))
        n_steps = -(-len(x) // bs)
        k = scan_slice_steps(n_steps, bs * int(np.prod(x.shape[1:])) + bs * 4)
        feed = DeviceFeed(device)
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
            losses = [step(dxb[i], dyb[i])
                      for dxb, dyb in feed.stream(pipe.run(bounds))
                      for i in range(dxb.shape[0])]
            history.append(float(torch.stack(losses).mean()))
            if ckpt is not None:
                ckpt.save(state, step=_epoch + 1)

        bundle = TorchBundle.from_module(self.backbone, state.module, kwargs,
                                         input_shape=(h, w, 3))
        return DeepVisionModel(
            bundle=bundle, classes=list(classes), input_col=self.input_col,
            prediction_col=self.prediction_col,
            probability_col=self.probability_col, height=h, width=w,
            normalize=self.normalize, loss_history=history,
            device=self.device)

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
