"""TorchModel: batched model inference as a pipeline stage.

Counterpart of the JAX package's `TPUModel` (models/tpu_model.py), the
CNTKModel equivalent (deep-learning/.../CNTKModel.scala:88-545): the
weights move to the device once per (bundle, fetch, preprocess, device)
and inputs stream through minibatch -> pad-to-chunk-shape -> pinned
host->device copy -> ONE forward per chunk.  Feed/fetch-node addressing
(:229-371) maps to the bundle's named taps; input coercion (:450-466)
and output coercion (:468-493) are handled host-side.  Token models
(TransformerLM) take int32 rows of shape (S,) with `feed_dtype="int32"`,
as the JAX package's TPUModel does.

The bundle is a `TorchBundle` or a `FunctionBundle` (an arbitrary
`fn(variables, batch)`): either gives the executor its device-side state
(`bundle.module(device)`: a module, or the variables as tensors) and
its taps (`bundle.apply`), under the same taps rule and `device` Param.

Chunk sizing, padding and grouping (`chunk_plan`, `chunk_sizes`,
`pad_to_batch`, `run_grouped`) keep the JAX package's semantics exactly.
The device is the `device` Param: ``cuda`` unless the caller passes
``"cpu"`` (device.py).

Over a data mesh: when a process group is up (parallel/mesh.py's SPMD
substrate, one rank a device), `run_grouped` feeds a meshed
`DeviceFeed(mesh=default_mesh(device))`, as the JAX package's TPUModel
feeds its `default_mesh()`.  Every rank passes the same table; chunks
pad to a multiple of the data degree; each rank moves only its own rows,
runs the preprocess (kernel B1) and the backbone on that local shard, and
the outputs are gathered in rank order, so every rank returns the whole
column.  Without a group the single-device path runs; a transform never
starts a group of its own.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import resolve_device
from .bundle import FunctionBundle, TorchBundle

__all__ = ["TorchModel", "ImagePreprocess", "pad_to_multiple"]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0
                    ) -> Tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple (padded rows repeat the last row and are
    dropped after unbatching).  Returns (padded, original_len)."""
    n = arr.shape[axis]
    target = math.ceil(max(n, 1) / multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, mode="edge"), n


class ImagePreprocess:
    """Device-side image preprocessing ahead of the forward: uint8 HWC
    batch -> channel fix -> f32 -> linear resize -> normalize, the last
    three in one pass of the fused kernel
    (`ops.image_kernels.fused_resize_normalize`; the plain PyTorch
    version for a CPU batch).  The host only decodes; the uint8 feed
    moves 4x fewer bytes than f32.

    Picklable (plain attrs) so stages holding it serialize; `key` is a
    stable identity for the executor cache."""

    def __init__(self, height: int, width: int, mean=None, std=None):
        self.height = int(height)
        self.width = int(width)
        self.mean = tuple(float(m) for m in mean) if mean is not None else None
        self.std = tuple(float(s) for s in std) if std is not None else None

    @property
    def key(self):
        return ("img", self.height, self.width, self.mean, self.std)

    def fix_channels(self, batch: torch.Tensor) -> torch.Tensor:
        if batch.shape[-1] == 1:  # gray -> 3-channel
            return batch.repeat(1, 1, 1, 3)
        if batch.shape[-1] == 4:  # BGRA -> BGR
            return batch[..., :3].contiguous()
        return batch

    def mean_std(self, c: int):
        """Normalization applies only when mean is set (std alone is
        ignored), as in the JAX package."""
        if self.mean is not None:
            return self.mean, self.std or (1.0,) * len(self.mean)
        return (0.0,) * c, (1.0,) * c

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        from ..ops.image_kernels import fused_resize_normalize

        batch = self.fix_channels(batch)
        mean, std = self.mean_std(batch.shape[-1])
        return fused_resize_normalize(batch, self.height, self.width, mean, std)


# process-wide LRU cache: (bundle_id, fetch, preprocess key, device) ->
# (device module, forward).  Bounded so device-resident weights of
# retired models get released.
_EXEC_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_EXEC_CACHE_MAX = 8

_FEED_DTYPES = {"float32": np.float32, "uint8": np.uint8, "int32": np.int32}


def _gather_input(col: np.ndarray, input_shape,
                  dtype=np.float32) -> np.ndarray:
    """Rows (vectors / arrays / scalars) -> [B, ...] of the feed dtype,
    reshaping flat CHW vectors to the bundle's input shape when given
    (coerceDFAndFeedDict, CNTKModel.scala:450-466)."""
    if col.dtype != object:
        batch = np.asarray(col, dtype=dtype)
    else:
        batch = np.stack([np.asarray(v, dtype=dtype) for v in col])
    if input_shape is not None and batch.shape[1:] != tuple(input_shape):
        if int(np.prod(batch.shape[1:])) == int(np.prod(input_shape)):
            # flat CHW vector -> HWC image (UnrollImage layout, c*h*w)
            h, w, c = input_shape
            batch = batch.reshape(batch.shape[0], c, h, w).transpose(0, 2, 3, 1)
        else:
            raise ValueError(
                f"input rows of shape {batch.shape[1:]} incompatible with model "
                f"input {tuple(input_shape)}")
    return batch


def _data_mesh(device: torch.device):
    """The ambient data mesh when a process group is up (every rank on
    the data axis unless a MeshContext says otherwise), else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from ..parallel.mesh import default_mesh

    return default_mesh(device)


def _sharded_forward(forward, mesh):
    """`forward` on this rank's rows of a batch-sharded chunk; its output
    is this rank's block of a batch-sharded DTensor, which the feed
    gathers whole in rank order."""
    from ..io.shard_put import _global_tensor
    from ..parallel.mesh import batch_sharding, data_size

    dp = data_size(mesh)

    def run(x):
        y = forward(x.to_local())
        return _global_tensor(y, batch_sharding(mesh, y.dim()),
                              (y.shape[0] * dp,) + tuple(y.shape[1:]))

    return run


@register_stage
class TorchModel(Transformer):
    bundle = ComplexParam("TorchBundle (architecture + weights) or "
                          "FunctionBundle")
    input_col = Param("input column", default="features")
    output_col = Param("output column", default="output")
    fetch_node = Param("tap name or OUTPUT_i index to fetch", default=None)
    batch_size = Param("device minibatch size", default=64,
                       converter=TypeConverters.to_int)
    convert_output_to = Param("none|vector|array", default="vector")
    preprocess = ComplexParam(
        "device-side preprocess ahead of the forward (e.g. ImagePreprocess)",
        default=None)
    group_by_shape = Param(
        "group ragged input rows by shape, one chunk shape per group",
        default=False, converter=TypeConverters.to_bool)
    feed_dtype = Param("host->device transfer dtype (float32|uint8|int32 — "
                       "int32 for token-id models)", default="float32")
    pad_to_batch = Param(
        "always pad chunks to the full batch_size so every call shares ONE "
        "chunk shape — the serving setting",
        default=False, converter=TypeConverters.to_bool)
    feed_depth = Param(
        "host->device pipeline depth: chunks in flight",
        default=2, converter=TypeConverters.to_int)
    device = Param("'cuda' (default) or 'cpu'; without CUDA only an explicit "
                   "'cpu' runs", default=None)

    def __init__(self, bundle: Optional[Union[TorchBundle, FunctionBundle]]
                 = None, **kw):
        super().__init__(**kw)
        if bundle is not None:
            self.set(bundle=bundle)

    # ---- node addressing (CNTKModel.scala:229-371) --------------------
    def _fetch_name(self, bundle: TorchBundle) -> str:
        node = self.fetch_node
        names = bundle.layer_names or ["output"]
        if node is None:
            return names[0]
        if isinstance(node, int) or (isinstance(node, str) and node.startswith("OUTPUT_")):
            idx = node if isinstance(node, int) else int(node.split("_", 1)[1])
            return names[idx]
        return node

    def _executor(self, bundle: TorchBundle, fetch: str, device: torch.device):
        """Build (or reuse) the device module and forward for this bundle."""
        pre = self.preprocess
        pre_key = pre.key if pre is not None and hasattr(pre, "key") else None
        key = (bundle.bundle_id, fetch, pre_key, str(device))
        cached = _EXEC_CACHE.get(key)
        if cached is not None:
            _EXEC_CACHE.move_to_end(key)
            return cached
        module = bundle.module(device)

        def forward(batch: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                if pre is not None:
                    batch = pre(batch)
                taps = bundle.apply(module, batch)
                if fetch not in taps:
                    raise KeyError(
                        f"fetch node {fetch!r} not in model taps {list(taps)}")
                return taps[fetch].float()

        # the compile sentry flags steady-state new chunk shapes (the
        # pad_to_batch hazard) and names the shape
        _EXEC_CACHE[key] = (module, core_telemetry.watch_compiles(
            forward, name="tpu_model.forward"))
        while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
            _EXEC_CACHE.popitem(last=False)
        return _EXEC_CACHE[key]

    def _stacking_builder(self, rows):
        """build_chunk callable for run_grouped that stacks row arrays and
        coerces to the configured feed dtype."""
        dtype = _FEED_DTYPES[self.feed_dtype]
        return lambda _shape, sel: np.stack(
            [rows[i] for i in sel]).astype(dtype, copy=False)

    def chunk_plan(self, groups, dp: int = 1):
        """Lay out the chunk plan eagerly: [(sel, shape, pad_mult)] in feed
        order plus the flattened row feed_order."""
        plan = []  # (sel, shape, pad_mult) per chunk, in feed order
        for shape, idxs in groups.items():
            bs, pad_mult = self.chunk_sizes(len(idxs), dp)
            for start in range(0, len(idxs), bs):
                plan.append((idxs[start:start + bs], shape, pad_mult))
        return plan, [i for sel, _, _ in plan for i in sel]

    def chunk_sizes(self, n_rows: int, dp: int = 1):
        """(chunk_size, pad_multiple) for a group of n_rows: chunk size is
        batch_size rounded up to the data-parallel degree; multi-chunk
        groups pad every chunk (incl. the trailing one) to the full chunk
        size so the whole group shares ONE chunk shape, while a
        single-chunk group pads only to the dp multiple."""
        bs = -(-max(self.batch_size, dp) // dp) * dp
        if self.pad_to_batch:
            return bs, bs
        return bs, (bs if n_rows > bs else dp)

    def run_grouped(self, groups, build_chunk, forward, device):
        """Feed ordered shape groups through ONE bounded in-flight window
        and return (feed_order, rows-in-feed-order).  `build_chunk(shape,
        sel)` returns the stacked [len(sel), ...] chunk for those row
        indices; it runs on the HostPipeline's assembly workers, so
        several chunks assemble in parallel while the feed engine
        transfers earlier ones and the device computes.  `build_chunk`
        must be thread-safe.  Inside a process group the feed is meshed
        (module docstring): `forward` runs on each rank's local shard."""
        from ..io.feed import DeviceFeed
        from ..io.pipeline import HostPipeline, PipelineStage, pipeline_workers

        mesh = _data_mesh(device)
        dp = 1
        if mesh is not None:
            from ..parallel.mesh import data_size

            dp = data_size(mesh)
            forward = _sharded_forward(forward, mesh)
        plan, feed_order = self.chunk_plan(groups, dp)

        def assemble(item):
            sel, shape, pad_mult = item
            return pad_to_multiple(build_chunk(shape, sel), pad_mult, axis=0)

        pipe = HostPipeline([PipelineStage(
            "assemble", assemble,
            workers=pipeline_workers() if len(plan) > 1 else 1)])
        feed = DeviceFeed(device, mesh=mesh, depth=int(self.feed_depth))
        outs = feed.run(pipe.feed_source(plan), forward)
        return feed_order, [row for out in outs for row in out]

    def _transform(self, table: Table) -> Table:
        device = resolve_device(self.device)
        bundle: TorchBundle = self.bundle
        fetch = self._fetch_name(bundle)
        _module, forward = self._executor(bundle, fetch, device)

        col = table[self.input_col]
        n = len(col)
        if self.group_by_shape:
            # ragged rows: one chunk shape per distinct row shape, all
            # groups through one in-flight window, rows scattered back to
            # their original order
            groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
            arrays = [np.asarray(v) for v in col]
            for i, a in enumerate(arrays):
                groups.setdefault(a.shape, []).append(i)
        else:
            batch_np = _gather_input(
                col, bundle.input_shape,
                _FEED_DTYPES[self.feed_dtype]) if n else None
            arrays = list(batch_np) if n else []
            groups = OrderedDict({None: list(range(n))}) if n else OrderedDict()
        cells: List[Any] = [None] * n
        feed_order, out_rows = self.run_grouped(
            groups, self._stacking_builder(arrays), forward, device)
        for i, y in zip(feed_order, out_rows):
            cells[i] = y
        result = np.stack(cells) if n else np.zeros((0,))
        if self.convert_output_to == "vector" and result.ndim > 2:
            result = result.reshape(len(result), -1)
        return table.with_column(self.output_col, result)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.input_col not in columns:
            raise ValueError(f"TorchModel: missing input column '{self.input_col}'")
        return columns + [self.output_col]
