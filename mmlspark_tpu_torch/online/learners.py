"""Online hashed linear learners on the card.

Reference: vw/VowpalWabbitBase.scala:71-556 (per-partition native VW fed
hashed examples; spanning-tree AllReduce between passes; TrainingStats ns
timers), vw/VowpalWabbitClassifier.scala, VowpalWabbitRegressor.scala,
VowpalWabbitBaseModel.scala.

Counterpart of the JAX package's `online/learners.py`, with its Params,
defaults, output columns and statistics table.  The weight table
(2^bits f32) and AdaGrad's squared-gradient table live on the card; each
pass of per-example updates is one launch of kernel K1
(`ops/online_pass.py`, `csrc/online_pass.cu`), which walks the examples
in order with the reference's duplicate-index and padding semantics.
The rows are laid out for it once a fit (`plan_rows`).  Margins at
transform time are a gather and a row sum in PyTorch.

Each stage has a `device` Param: the card unless the caller passes
``device="cpu"``, where the pass is K1's plain loop.  Weights are numpy
arrays, so a JAX model's `weights` build this package's model as they
are.

`use_all_reduce=True` is the reference's spanning-tree averaging
(`_allreduce_pass`: a local scan a shard, then `pmean` of the weights at
the end of every pass; VowpalWabbitBase.scala:434-462, endPass :363-368)
over the data axis of the ambient mesh when a process group is up (one
rank a device; every rank passes the same table).  The rows pad with
all-zero rows — exact no-ops — to a multiple of the data degree; each
rank runs its contiguous block through K1, one launch a pass, then `w`
and `g2` are all-reduced as means and the loss sum and count as sums.
Without a group the data degree is 1.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import DEVICE_DOC, resolve_device
from ..ops.online_pass import online_pass, plan_rows
from .featurizer import sparse_to_padded

__all__ = [
    "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel",
    "VowpalWabbitRegressor",
    "VowpalWabbitRegressionModel",
]


def _predict_margin(w: torch.Tensor, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    return torch.sum(w[idx] * val, dim=-1)


def _rows(idx: np.ndarray, val: np.ndarray, device: torch.device):
    """Padded (n, A) uint32 / f32 rows as int64 / f32 tensors on device."""
    return (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(np.ascontiguousarray(val, np.float32),
                            device=device))


def _data_group(dev: torch.device):
    """(data group or None, data degree, this rank's coordinate, device)
    of the ambient mesh when a process group is up, else (None, 1, 0,
    dev)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0, dev
    from ..parallel.mesh import data_size, default_mesh

    mesh = default_mesh(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return (mesh.get_group("data"), data_size(mesh),
            mesh.get_local_rank("data"), dev)


def _end_of_pass(w, g2, loss_sum, count, nd: int, group) -> None:
    """The reference's end-of-pass `pmean` of w and g2 and `psum` of the
    loss sum and count, in place over the data group."""
    import torch.distributed as dist

    for t in (w, g2, loss_sum, count):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    w.div_(nd)
    g2.div_(nd)


class _VowpalWabbitBase(Estimator):
    features_col = Param("sparse features column", default="features")
    label_col = Param("label column", default="label")
    prediction_col = Param("prediction column", default="prediction")
    num_bits = Param("weight-table bits (dim = 2^bits)", default=18,
                     converter=TypeConverters.to_int)
    num_passes = Param("passes over the data", default=1,
                       converter=TypeConverters.to_int)
    learning_rate = Param("base learning rate", default=0.5,
                          converter=TypeConverters.to_float)
    l1 = Param("l1 (truncated gradient)", default=0.0,
               converter=TypeConverters.to_float)
    l2 = Param("l2 decay", default=0.0, converter=TypeConverters.to_float)
    use_all_reduce = Param("shard the pass over the mesh 'data' axis with "
                           "end-of-pass weight averaging", default=False,
                           converter=TypeConverters.to_bool)
    initial_model = ComplexParam("warm-start weights (np array)", default=None)
    device = Param(DEVICE_DOC, default=None)

    _loss = "squared"

    def _labels(self, table: Table) -> np.ndarray:
        raise NotImplementedError

    def _fit(self, table: Table) -> Model:
        dev = resolve_device(self.device)
        t_ingest0 = time.perf_counter_ns()
        col = table[self.features_col]
        meta = table.get_meta(self.features_col)
        bits = int(meta.get("num_bits", self.num_bits))
        dim = 1 << bits
        idx, val = sparse_to_padded(col)
        y = self._labels(table)
        t_ingest = time.perf_counter_ns() - t_ingest0

        init = self.get_or_default("initial_model")
        w = (torch.tensor(np.asarray(init, np.float32), device=dev)
             if init is not None else
             torch.zeros(dim, dtype=torch.float32, device=dev))
        g2 = torch.zeros(dim, dtype=torch.float32, device=dev)

        group, nd = None, 1
        if self.use_all_reduce:
            group, nd, rank, dev = _data_group(dev)
            # zero-pad to a multiple of the data axis: all-zero values make
            # the padded rows exact no-ops in the update and the loss count
            rem = (-len(idx)) % nd
            if rem:
                idx = np.concatenate([idx, np.zeros((rem, idx.shape[1]), idx.dtype)])
                val = np.concatenate([val, np.zeros((rem, val.shape[1]), val.dtype)])
                y = np.concatenate([y, np.zeros((rem,), y.dtype)])
            per = len(idx) // nd
            block = slice(rank * per, (rank + 1) * per)
            idx, val, y = idx[block], val[block], y[block]
            w, g2 = w.to(dev), g2.to(dev)

        t_learn0 = time.perf_counter_ns()
        plan = plan_rows(*_rows(idx, val, dev))
        yt = torch.as_tensor(y, device=dev)
        losses = []
        for _ in range(int(self.num_passes)):
            ls, ct = online_pass(w, g2, plan, yt, self.learning_rate,
                                 self.l1, self.l2, self._loss)
            ls, ct = ls.sum().reshape(1), ct.sum().reshape(1)
            if group is not None:
                _end_of_pass(w, g2, ls, ct, nd, group)
            losses.append(float(ls) / max(float(ct), 1.0))
        t_learn = time.perf_counter_ns() - t_learn0

        stats = Table({
            "pass": np.arange(len(losses)),
            "average_loss": np.asarray(losses, np.float64),
            "ingest_time_ns": np.full(len(losses), t_ingest, np.int64),
            "learn_time_ns": np.full(len(losses), t_learn, np.int64),
            "num_examples": np.full(len(losses), len(table), np.int64),
            "num_shards": np.full(len(losses), nd, np.int64),
        })
        return self._make_model(w.cpu().numpy(), stats)

    def _make_model(self, weights: np.ndarray, stats: Table) -> Model:
        raise NotImplementedError


class _VowpalWabbitModelBase(Model):
    features_col = Param("sparse features column", default="features")
    prediction_col = Param("prediction column", default="prediction")
    weights = ComplexParam("weight table (np array)")
    performance_statistics = ComplexParam("per-pass TrainingStats table",
                                          default=None)
    device = Param(DEVICE_DOC, default=None)

    def _margins(self, table: Table) -> np.ndarray:
        idx, val = sparse_to_padded(table[self.features_col])
        if len(idx) == 0:
            return np.zeros((0,), np.float32)
        dev = resolve_device(self.device)
        w = torch.tensor(np.asarray(self.weights, np.float32), device=dev)
        return _predict_margin(w, *_rows(idx, val, dev)).cpu().numpy()


@register_stage
class VowpalWabbitRegressor(_VowpalWabbitBase):
    """Online squared-loss regressor (reference VowpalWabbitRegressor.scala)."""

    _loss = "squared"

    def _labels(self, table: Table) -> np.ndarray:
        return np.asarray(table[self.label_col], np.float32)

    def _make_model(self, weights, stats):
        return VowpalWabbitRegressionModel(
            weights=weights, performance_statistics=stats,
            features_col=self.features_col, prediction_col=self.prediction_col,
            device=self.device,
        )


@register_stage
class VowpalWabbitRegressionModel(_VowpalWabbitModelBase):
    def _transform(self, table: Table) -> Table:
        return table.with_column(self.prediction_col, self._margins(table))


@register_stage
class VowpalWabbitClassifier(_VowpalWabbitBase):
    """Online logistic classifier; labels {0,1} mapped to {-1,+1}
    (reference VowpalWabbitClassifier.scala:116)."""

    probability_col = Param("probability column", default="probability")
    _loss = "logistic"

    def _labels(self, table: Table) -> np.ndarray:
        y = np.asarray(table[self.label_col], np.float32)
        return np.where(y > 0, 1.0, -1.0).astype(np.float32)

    def _make_model(self, weights, stats):
        return VowpalWabbitClassificationModel(
            weights=weights, performance_statistics=stats,
            features_col=self.features_col, prediction_col=self.prediction_col,
            probability_col=self.probability_col, device=self.device,
        )


@register_stage
class VowpalWabbitClassificationModel(_VowpalWabbitModelBase):
    probability_col = Param("probability column", default="probability")

    def _transform(self, table: Table) -> Table:
        margin = self._margins(table)
        prob = 1.0 / (1.0 + np.exp(-margin))
        out = table.with_column(self.probability_col, prob.astype(np.float32))
        return out.with_column(
            self.prediction_col, (prob > 0.5).astype(np.int64)
        )
