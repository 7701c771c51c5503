"""Decision tree: array-form structure, leaf-wise grower, device prediction.

The grower is best-first (leaf-wise) with `num_leaves` budget like LightGBM's
serial tree learner: a host loop over the device histogram builder
(`HistogramBuilder`); sibling histograms use the subtraction trick.  Trees
are stored as flat arrays so batched prediction is a fixed-depth gather loop
on the device (`predict_forest`) — no per-row Python.

Reference semantics: lightgbm/booster/LightGBMBooster.scala (tree model,
predict/leaf outputs), LightGBMBase trainCore loop (TrainUtils.scala:92-159).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .histogram import HistogramBuilder, SplitInfo, best_split, subtract_histogram, vote_features

__all__ = ["Tree", "TreeGrower", "GrowerConfig"]


@dataclass
class Tree:
    """Flat-array binary tree.  Internal nodes: split_feature >= 0; leaves:
    split_feature == -1 and `value` holds the output.  `threshold_bin` splits
    binned codes during training; `threshold_value` splits raw floats at
    inference (exported via BinMapper.bin_upper_value)."""

    split_feature: np.ndarray = field(default_factory=lambda: np.full(1, -1, np.int32))
    threshold_bin: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    threshold_value: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))
    left: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    right: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    value: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))
    gain: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))
    count: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float64))

    @property
    def num_nodes(self) -> int:
        return len(self.split_feature)

    @property
    def num_leaves(self) -> int:
        return int((self.split_feature < 0).sum())

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.num_nodes, np.int32)
        for i in range(self.num_nodes):
            f = self.split_feature[i]
            if f >= 0:
                depth[self.left[i]] = depth[i] + 1
                depth[self.right[i]] = depth[i] + 1
        return int(depth.max()) if self.num_nodes else 0

    # ---- prediction ----------------------------------------------------
    def predict_binned(self, binned) -> np.ndarray:
        """Vectorized traversal on binned codes (training-time path; dense
        codes or a sparse.SparseBinnedView)."""
        return self.value[self.predict_leaf_index_binned(binned)]

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Vectorized traversal on raw float features (inference path);
        NaN routes left (missing bin 0 satisfies every threshold)."""
        n = len(x)
        node = np.zeros(n, np.int32)
        for _ in range(max(self.max_depth, 1)):
            f = self.split_feature[node]
            internal = f >= 0
            if not internal.any():
                break
            fx = x[np.arange(n), np.maximum(f, 0)]
            # NaN routes left: the missing bin is 0, which every threshold_bin
            # satisfies (same rule as predict_leaf_index / predict_forest)
            go_left = np.where(np.isnan(fx), True, fx <= self.threshold_value[node])
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(internal, nxt, node)
        return self.value[node]

    def predict_leaf_index(self, x: np.ndarray) -> np.ndarray:
        """Terminal node index per row (predictLeaf parity,
        LightGBMBooster.scala predictLeaf)."""
        n = len(x)
        node = np.zeros(n, np.int32)
        for _ in range(max(self.max_depth, 1)):
            f = self.split_feature[node]
            internal = f >= 0
            if not internal.any():
                break
            fx = x[np.arange(n), np.maximum(f, 0)]
            go_left = np.where(np.isnan(fx), True, fx <= self.threshold_value[node])
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(internal, nxt, node)
        return node

    def predict_leaf_index_binned(self, binned) -> np.ndarray:
        """predict_leaf_index on bin codes (dense codes or a
        sparse.SparseBinnedView) — routes with threshold_bin."""
        n = len(binned)
        node = np.zeros(n, np.int32)
        for _ in range(max(self.max_depth, 1)):
            f = self.split_feature[node]
            internal = f >= 0
            if not internal.any():
                break
            fx = binned[np.arange(n), np.maximum(f, 0)].astype(np.int32)
            go_left = fx <= self.threshold_bin[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(internal, nxt, node)
        return node

    def to_dict(self) -> dict:
        return {
            "split_feature": self.split_feature.tolist(),
            "threshold_bin": self.threshold_bin.tolist(),
            "threshold_value": [float(v) for v in self.threshold_value],
            "left": self.left.tolist(),
            "right": self.right.tolist(),
            "value": self.value.tolist(),
            "gain": self.gain.tolist(),
            "count": self.count.tolist(),
        }

    @staticmethod
    def from_dict(d: dict) -> "Tree":
        return Tree(
            split_feature=np.asarray(d["split_feature"], np.int32),
            threshold_bin=np.asarray(d["threshold_bin"], np.int32),
            threshold_value=np.asarray(d["threshold_value"], np.float64),
            left=np.asarray(d["left"], np.int32),
            right=np.asarray(d["right"], np.int32),
            value=np.asarray(d["value"], np.float64),
            gain=np.asarray(d["gain"], np.float64),
            count=np.asarray(d["count"], np.float64),
        )


def tree_arrays_for_jit(trees: List[Tree], max_nodes: Optional[int] = None):
    """Pad a forest into stacked [T, max_nodes] host arrays for the device
    ensemble predictor (thresholds and values cast to f32)."""
    if not trees:
        return None
    m = max_nodes or max(t.num_nodes for t in trees)

    def pad(a, fill, dtype):
        out = np.full((len(trees), m), fill, dtype)
        for i, t in enumerate(trees):
            arr = getattr(t, a)
            out[i, : len(arr)] = arr
        return out

    return {
        "split_feature": pad("split_feature", -1, np.int32),
        "threshold_value": pad("threshold_value", 0.0, np.float32),
        "threshold_bin": pad("threshold_bin", 0, np.int32),
        "left": pad("left", 0, np.int32),
        "right": pad("right", 0, np.int32),
        "value": pad("value", 0.0, np.float32),
    }


def predict_forest(arrs, x, tree_weights, max_depth: int):
    """Ensemble prediction on the device: [T] trees × [N, F] rows -> [N].

    A fixed-depth traversal of all trees at once (a loop over depth of
    `torch.gather`s on [T, N] node indices) — the counterpart of
    LGBM_BoosterPredictForMat.  `arrs` are the `tree_arrays_for_jit`
    arrays as tensors on x's device; x is f32 [N, F]; NaN goes left."""
    sf, tv = arrs["split_feature"].long(), arrs["threshold_value"]
    lc, rc = arrs["left"].long(), arrs["right"].long()
    xt = x.t()                                               # [F, N]
    node = torch.zeros(sf.shape[0], x.shape[0], dtype=torch.long,
                       device=x.device)                      # [T, N]
    for _ in range(max_depth):
        f = sf.gather(1, node)
        fx = xt.gather(0, f.clamp(min=0))
        go_left = torch.isnan(fx) | (fx <= tv.gather(1, node))
        nxt = torch.where(go_left, lc.gather(1, node), rc.gather(1, node))
        node = torch.where(f >= 0, nxt, node)
    per_tree = arrs["value"].gather(1, node)                 # [T, N]
    return torch.einsum("tn,t->n", per_tree, tree_weights)


@dataclass
class GrowerConfig:
    num_leaves: int = 31
    max_depth: int = -1            # -1 = unlimited
    min_data_in_leaf: int = 20
    min_sum_hessian: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain: float = 0.0
    feature_fraction: float = 1.0
    voting: bool = False
    top_k: int = 20


class _LeafState:
    __slots__ = ("node_id", "hist", "split", "depth", "count")

    def __init__(self, node_id, hist, split, depth, count):
        self.node_id = node_id
        self.hist = hist
        self.split = split
        self.depth = depth
        self.count = count


class TreeGrower:
    """Grows one tree leaf-wise given gradients; owns no data (the
    HistogramBuilder holds the device-resident binned matrix).  The root
    histogram comes down to the host whole, once a tree (its totals);
    every node's split comes down as 32 bytes (`best_split`)."""

    def __init__(self, builder: HistogramBuilder, config: GrowerConfig,
                 bin_upper_value, rng: np.random.Generator):
        self.builder = builder
        self.cfg = config
        self.bin_upper_value = bin_upper_value
        self.rng = rng
        self._voted_mask = None

    def _find_split(self, hist) -> Optional[SplitInfo]:
        cfg = self.cfg
        f = self.builder.f
        feature_mask = np.ones(f, dtype=bool)
        if cfg.feature_fraction < 1.0:
            k = max(1, int(round(cfg.feature_fraction * f)))
            feature_mask[:] = False
            feature_mask[self.rng.choice(f, k, replace=False)] = True
        if self._voted_mask is not None:
            feature_mask &= self._voted_mask
        return best_split(
            hist, cfg.lambda_l1, cfg.lambda_l2, cfg.min_data_in_leaf,
            cfg.min_sum_hessian, cfg.min_gain, feature_mask,
        )

    def _leaf_value(self, grad_sum, hess_sum) -> float:
        cfg = self.cfg
        g = np.sign(grad_sum) * max(abs(grad_sum) - cfg.lambda_l1, 0.0)
        return float(-g / (hess_sum + cfg.lambda_l2 + 1e-15))

    def grow(self, grad_np, hess_np, weight_np, binned_host: np.ndarray) -> Tree:
        cfg = self.cfg
        n = len(grad_np)
        grad, hess, weight = self.builder.device_arrays(grad_np, hess_np, weight_np)
        node_of_row = np.zeros(n, np.int32)

        # arrays grown as python lists, packed at the end
        sf, tb, tv, lc, rc, val, gains, counts = ([], [], [], [], [], [], [], [])

        def new_node():
            sf.append(-1); tb.append(0); tv.append(0.0)
            lc.append(0); rc.append(0); val.append(0.0); gains.append(0.0); counts.append(0.0)
            return len(sf) - 1

        root = new_node()
        root_mask = self.builder.node_mask(np.ones(n, bool))
        self._voted_mask = None
        if cfg.voting and self.builder.mesh is not None:
            # PV-Tree-style voting once per tree at the root: each shard votes
            # its top-k features by local gain; the split search is then
            # restricted to the union.  Histograms stay fully merged so node
            # stats and sibling subtraction remain exact; on multi-host the
            # AllReduce would ship only the voted features' slabs.
            local = self.builder.build_local(grad, hess, weight, root_mask).cpu().numpy()
            self._voted_mask = vote_features(
                local, cfg.lambda_l1, cfg.lambda_l2, cfg.min_data_in_leaf,
                cfg.min_sum_hessian, cfg.top_k)
        root_hist = self._build(grad, hess, weight, root_mask)
        hist_np = root_hist.cpu().numpy()
        total = hist_np.sum(axis=(0, 1)) / max(self.builder.f, 1)
        counts[root] = float(total[2])
        val[root] = self._leaf_value(float(total[0]), float(total[1]))
        split = self._find_split(root_hist)

        heap: List = []
        serial = 0
        if split is not None:
            heapq.heappush(heap, (-split.gain, serial := serial + 1,
                                  _LeafState(root, root_hist, split, 0, counts[root])))

        binned = binned_host
        n_leaves = 1
        while heap and n_leaves < cfg.num_leaves:
            _, _, leaf = heapq.heappop(heap)
            if leaf.split is None:
                continue
            if cfg.max_depth > 0 and leaf.depth >= cfg.max_depth:
                continue
            s = leaf.split
            nid = leaf.node_id
            left_id, right_id = new_node(), new_node()
            sf[nid] = s.feature
            tb[nid] = s.bin_threshold
            tv[nid] = self.bin_upper_value(s.feature, s.bin_threshold)
            lc[nid], rc[nid] = left_id, right_id
            gains[nid] = s.gain
            val[left_id] = self._leaf_value(s.left_grad, s.left_hess)
            val[right_id] = self._leaf_value(s.right_grad, s.right_hess)
            counts[left_id], counts[right_id] = s.left_count, s.right_count

            in_node = node_of_row == nid
            go_left = in_node & (binned[:, s.feature].astype(np.int32) <= s.bin_threshold)
            node_of_row[go_left] = left_id
            node_of_row[in_node & ~go_left] = right_id
            n_leaves += 1

            if n_leaves >= cfg.num_leaves:
                break

            # build smaller child, derive sibling by subtraction
            left_smaller = s.left_count <= s.right_count
            small_id = left_id if left_smaller else right_id
            small_mask = self.builder.node_mask(node_of_row == small_id)
            small_hist = self._build(grad, hess, weight, small_mask)
            big_hist = subtract_histogram(leaf.hist, small_hist)
            l_hist, r_hist = (small_hist, big_hist) if left_smaller else (big_hist, small_hist)

            for child, h, cnt in ((left_id, l_hist, s.left_count),
                                  (right_id, r_hist, s.right_count)):
                if cnt < 2 * cfg.min_data_in_leaf:
                    continue
                child_split = self._find_split(h)
                if child_split is not None:
                    heapq.heappush(heap, (-child_split.gain, serial := serial + 1,
                                          _LeafState(child, h, child_split,
                                                     leaf.depth + 1, cnt)))

        return Tree(
            split_feature=np.asarray(sf, np.int32),
            threshold_bin=np.asarray(tb, np.int32),
            threshold_value=np.asarray(tv, np.float64),
            left=np.asarray(lc, np.int32),
            right=np.asarray(rc, np.int32),
            value=np.asarray(val, np.float64),
            gain=np.asarray(gains, np.float64),
            count=np.asarray(counts, np.float64),
        )

    def _build(self, grad, hess, weight, mask):
        return self.builder.build(grad, hess, weight, mask)
