"""The featurize entry: `ImageFeaturizer.transform` over image tables, one
client in a closed loop, one table (a Spark partition) a call.

Set-up draws the backbone's weights on the device from the seed (the
configuration's layout, `reference/<family>.py`), hands them to the port
as a `TorchBundle` in the configuration's compute dtype, draws the mix's
pool of tables and warms up with transforms of the pool's tables (every
shape group of the mix) for the mix's `warmup_seconds`.  Each call transforms the next
table of the pool and keeps the features of a few rows drawn from the
seed; `verify` runs the plain float32 reference over those rows once the
window has closed and compares each with what the call returned (the
relative L2 gap of the row's features, the worst row compared).
"""
from __future__ import annotations

import itertools
import time
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import data, spec
from perfbench.harness.spans import Spans
from perfbench.reference import preprocess
from perfbench.reference.precision import ieee_fp32

CALL = "transform"
REF_BLOCK = 64  # rows a block of the reference


class FeaturizeCell:
    def __init__(self, ctx):
        from mmlspark_tpu_torch.core.schema import Table
        from mmlspark_tpu_torch.models.bundle import TorchBundle
        from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer

        self.ctx = ctx
        cfg, mix = ctx.config, ctx.mix
        self.family = spec.family_module(cfg)
        dev = torch.device(ctx.device)
        self.weights = data.make_weights(self.family.param_shapes(cfg),
                                         ctx.seed, dev)
        port = cfg["port"]
        self.bundle = TorchBundle(
            port["builder"], dict(port.get("kwargs", {})),
            state_dict={k: v.cpu().numpy() for k, v in self.weights.items()},
            input_shape=tuple(cfg["image_size"]) + (3,), dtype=cfg["dtype"])
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        self.pool = data.image_tables(mix, ctx.seed, dev)
        self.tables = [Table({"image": t.column()}) for t in self.pool]
        self.shape_counts = [Counter(r.shape for r in t.rows)
                             for t in self.pool]
        self.featurizer = ImageFeaturizer(
            bundle=self.bundle, batch_size=int(mix["batch_size"]),
            cut_output_layers=int(cfg["cut_output_layers"]),
            device=ctx.device)
        self.spans = Spans()
        if ctx.trace:
            _annotate(self.spans)
        self.rng = np.random.default_rng(data.sub_seed(ctx.seed, 5))
        self.sample_rows = int(mix["sample_rows_per_call"])
        self.samples: List[Tuple[int, int, np.ndarray]] = []
        self.n_calls = 0
        # warm-up: every shape group, then the pinned buffers and host
        # allocations of the feed settle over `warmup_seconds` of calls
        t0 = time.perf_counter()
        for i in itertools.count():
            self.featurizer.transform(self.tables[i % len(self.tables)])
            if i >= 1 and time.perf_counter() - t0 >= float(
                    mix.get("warmup_seconds", 0)):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def call(self) -> Dict[str, object]:
        k = self.n_calls % len(self.tables)
        self.n_calls += 1
        out = self.featurizer.transform(self.tables[k])
        feats = np.asarray(out[self.featurizer.output_col])
        n = len(self.pool[k].rows)
        ok = (feats.ndim == 2 and feats.shape[0] == n
              and bool(np.isfinite(feats).all()))
        if ok:
            for r in self.rng.choice(n, self.sample_rows, replace=False):
                self.samples.append((k, int(r), feats[r].copy()))
        return {"rows": n, "ok": ok, "shapes": self.shape_counts[k]}

    def counters(self) -> Dict[str, object]:
        from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY
        from mmlspark_tpu_torch.io.pipeline import PIPELINE_TELEMETRY

        return {"pipeline": PIPELINE_TELEMETRY.snapshot(),
                "feed": FEED_TELEMETRY.snapshot()}

    def release(self) -> None:
        from mmlspark_tpu_torch.models import torch_model

        self.spans.undo()
        self.featurizer = self.bundle = None
        torch_model._EXEC_CACHE.clear()  # the executor holds the weights
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_features(self, rows: List[Tuple[int, int]], quant=None
                           ) -> Dict[Tuple[int, int], torch.Tensor]:
        """The plain float32 features of (table, row) pairs, in blocks of
        one shape."""
        cfg = self.ctx.config
        dev = torch.device(self.ctx.device)
        w = {k: v.to(dev) for k, v in self.weights.items()}
        h, wd = cfg["image_size"]
        by_shape: Dict[tuple, List[Tuple[int, int]]] = {}
        for k, r in rows:
            by_shape.setdefault(self.pool[k].rows[r].shape, []).append((k, r))
        out = {}
        with torch.no_grad(), ieee_fp32():
            for keys in by_shape.values():
                for lo in range(0, len(keys), REF_BLOCK):
                    blk = keys[lo:lo + REF_BLOCK]
                    x = torch.from_numpy(np.stack(
                        [self.pool[k].rows[r] for k, r in blk])).to(dev)
                    x = preprocess.resize_normalize(x, h, wd)
                    f = self.family.features(w, x, cfg, quant).cpu()
                    out.update(zip(blk, f))
        return out

    def verify(self, control=None) -> List[Tuple[str, float, float]]:
        """The numbers compared; with `control` (a rounding function) the
        reference computed at that precision takes the program's place."""
        rows = sorted({(k, r) for k, r, _f in self.samples})
        ref = self.reference_features(rows)
        ctl = self.reference_features(rows, control) if control else None
        worst = 0.0 if self.samples else float("inf")
        for k, r, f in self.samples:
            want = ref[(k, r)].double()
            got = ctl[(k, r)] if ctl else torch.from_numpy(f)
            gap = float((got.double() - want).norm() / want.norm())
            worst = max(worst, gap)
        return [("features_rel_l2", worst,
                 float(self.ctx.limits["features_rel_l2"]))]


def _annotate(spans: Spans) -> None:
    """The program's own span annotations, and the benchmark's spans
    around the transform's layers: decoding the column, the grouped run
    (plan, assembly, feed), the feed engine and its wait for a chunk."""
    from mmlspark_tpu_torch.core.telemetry.device import (
        enable_device_annotations)
    from mmlspark_tpu_torch.io import feed, pipeline
    from mmlspark_tpu_torch.models import image_featurizer, torch_model

    enable_device_annotations()
    spans.wrap(image_featurizer, "decode_cells", "transform.decode_cells")
    spans.wrap(torch_model.TorchModel, "run_grouped",
               "transform.run_grouped")
    spans.wrap(feed.DeviceFeed, "run", "feed.run")
    spans.wrap(pipeline._PipelineFeedSource, "get", "feed.wait_chunk")


def setup(ctx) -> FeaturizeCell:
    return FeaturizeCell(ctx)
