"""Sparse (CSR) GBDT dataset path for high-dimensional hashed features.

The counterpart of the JAX package's `gbdt/sparse.py`: the host classes
are copies; the histogram build runs in PyTorch on the device.

The reference aggregates training rows into *either* dense or sparse (CSR)
native LightGBM datasets (lightgbm/dataset/DatasetAggregator.scala:69-515:
ChunkedArray rows -> LGBM_DatasetCreateFromMat / ...FromCSR) so hashed text
features never materialize densely.  Here:

  - `CSRMatrix`           host-side CSR container (+ ingestion from the
                          hashed `(indices, values)` columns emitted by
                          `online.featurizer.VowpalWabbitFeaturizer`).
  - `SparseBinMapper`     per-feature quantile binning fitted on *nonzero*
                          values only; the bin of the implicit zeros is
                          tracked per feature (`zero_bins_`).
  - `SparseBinnedView`    binned nonzeros in COO form with the same indexing
                          surface the tree grower uses on a dense binned
                          matrix (CSC column extraction for row routing,
                          key-bisection gather for tree traversal).
  - `SparseHistogramBuilder`  scatter-add histograms over the COO nonzeros
                          on the device with a linear "implicit zero"
                          fix-up: hist[f, zero_bin[f]] += node_total -
                          explicit_mass (linear, so it composes with the
                          cross-rank sum of row-shard histograms: over a
                          mesh each rank holds its row block's entries).

Memory model: training state is O(nnz) host + O(nnz) device for the COO
arrays, plus the [F, B, 3] histogram; nothing
is ever [N, F] dense.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import numpy as np
import torch

from .histogram import RowShardedBuilderBase, weighted_stats

__all__ = [
    "CSRMatrix",
    "SparseBinMapper",
    "SparseBinnedView",
    "SparseHistogramBuilder",
]


class CSRMatrix:
    """Minimal host CSR: float64 data, int64 indices/indptr, (n, f) shape."""

    def __init__(self, data, indices, indptr, shape):
        self.data = np.asarray(data, np.float64)
        self.indices = np.asarray(indices, np.int64)
        self.indptr = np.asarray(indptr, np.int64)
        self.shape = (int(shape[0]), int(shape[1]))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError("indptr length must be n_rows + 1")
        if len(self.indices) and self.indices.max() >= self.shape[1]:
            raise ValueError(
                f"feature index {int(self.indices.max())} out of range for "
                f"{self.shape[1]} features — was the scoring data hashed "
                "with more bits than the training data?")

    # ---- constructors --------------------------------------------------
    @staticmethod
    def from_dense(x: np.ndarray) -> "CSRMatrix":
        x = np.asarray(x, np.float64)
        n, f = x.shape
        mask = x != 0.0
        counts = mask.sum(axis=1)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(x[rows, cols], cols, indptr, (n, f))

    @staticmethod
    def from_pairs_column(col: np.ndarray, num_features: Optional[int] = None
                          ) -> "CSRMatrix":
        """Build from an object column of (indices, values) pairs — the
        hashed namespace format of VowpalWabbitFeaturizer (reference
        vw/VowpalWabbitFeaturizer.scala sparse output).  Duplicate indices
        within a row (hash collisions, e.g. from VowpalWabbitInteractions)
        are summed, matching the featurizer's sum_collisions semantics —
        required for the histogram implicit-zero fix-up to stay exact."""
        n = len(col)
        lens = np.fromiter((len(p[0]) for p in col), np.int64, count=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        nnz = int(indptr[-1])
        if nnz:
            indices = np.concatenate([np.asarray(p[0], np.int64) for p in col])
            data = np.concatenate([np.asarray(p[1], np.float64) for p in col])
        else:
            indices = np.empty(0, np.int64)
            data = np.empty(0, np.float64)
        if num_features is None:
            num_features = int(indices.max()) + 1 if nnz else 1
        elif nnz and indices.max() >= num_features:
            # must precede the dedup keying below, or out-of-range indices
            # would wrap into wrong (row, feature) cells instead of erroring
            raise ValueError(
                f"feature index {int(indices.max())} out of range for "
                f"{num_features} features — was the scoring data hashed "
                "with more bits than the training data?")
        # sum duplicate (row, index) pairs
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        keys = rows * np.int64(num_features) + indices
        uniq_keys, inv = np.unique(keys, return_inverse=True)
        if len(uniq_keys) != nnz:
            summed = np.zeros(len(uniq_keys), np.float64)
            np.add.at(summed, inv, data)
            rows = (uniq_keys // num_features).astype(np.int64)
            indices = (uniq_keys % num_features).astype(np.int64)
            data = summed
            lens = np.bincount(rows, minlength=n).astype(np.int64)
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=indptr[1:])
        return CSRMatrix(data, indices, indptr, (n, int(num_features)))

    # ---- container protocol -------------------------------------------
    def __len__(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return len(self.data)

    def take_rows(self, idx) -> "CSRMatrix":
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        lens = self.indptr[idx + 1] - self.indptr[idx]
        indptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=indptr[1:])
        nnz = int(indptr[-1])
        # vectorized ragged gather: absolute source position of every entry
        src = np.repeat(self.indptr[idx], lens) + \
            np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], lens)
        return CSRMatrix(self.data[src], self.indices[src], indptr,
                         (len(idx), self.shape[1]))

    def __getitem__(self, idx) -> "CSRMatrix":
        """Row selection with a bool mask or index array (the estimator's
        validation-split / numBatches slicing protocol)."""
        return self.take_rows(idx)

    def to_dense(self) -> np.ndarray:
        n, f = self.shape
        out = np.zeros((n, f), np.float64)
        rows = np.repeat(np.arange(n), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


class SparseBinMapper:
    """Per-feature quantile binning fitted on nonzero values.

    Bin-code convention matches the dense `BinMapper` (bin 0 = missing;
    values bin to `searchsorted(boundaries, v) + 1`) so codes stay monotone
    in raw value and `best_split` thresholds transfer unchanged.  The
    implicit zeros of each feature land in `zero_bins_[f]` — the histogram
    builder adds their mass there without ever materializing them.
    """

    def __init__(self, max_bin: int = 255, sample_count: int = 200_000,
                 seed: int = 0):
        if not 2 <= max_bin <= 255:
            raise ValueError("max_bin must be in [2, 255]")
        self.max_bin = int(max_bin)
        self.sample_count = int(sample_count)
        self.seed = int(seed)
        self.num_features_: int = 0
        self.boundaries_: List[np.ndarray] = []
        self.zero_bins_: np.ndarray = np.empty(0, np.int32)
        # no categorical support on the sparse path (hashed features are
        # already indicator/count-valued); kept for Booster duck-typing
        self.categories_: dict = {}
        self.categorical_features: list = []

    @property
    def num_bins(self) -> int:
        return self.max_bin + 1

    def fit(self, x: CSRMatrix) -> "SparseBinMapper":
        n, f = x.shape
        self.num_features_ = f
        # checked on the FULL data (the subsample could miss a NaN) and
        # again in transform: NaN stored values would otherwise silently
        # bin to the top bin, inverting the dense path's NaN-goes-left rule
        if np.isnan(x.data).any():
            raise ValueError("NaN stored values are not supported on the "
                             "sparse path (absent entries are zeros)")
        indices, data = x.indices, x.data
        if n > self.sample_count:
            rng = np.random.default_rng(self.seed)
            sub = x.take_rows(np.sort(rng.choice(n, self.sample_count, replace=False)))
            indices, data = sub.indices, sub.data
        # group nonzeros by feature (CSC ordering) and bin each group
        order = np.argsort(indices, kind="stable")
        sorted_feats = indices[order]
        sorted_vals = data[order]
        feat_ids, starts = np.unique(sorted_feats, return_index=True)
        ends = np.append(starts[1:], len(sorted_feats))
        empty = np.empty(0, np.float64)
        self.boundaries_ = [empty] * f
        for fid, s, e in zip(feat_ids, starts, ends):
            col = sorted_vals[s:e]
            uniq = np.unique(col)
            # the implicit zeros are part of the distribution: a boundary
            # must separate 0 from its nearest nonzero neighbors, else a
            # constant-valued indicator feature (the hashed-text common
            # case) would merge with its zeros into one unsplittable bin
            if len(uniq) <= self.max_bin - 2:
                merged = np.union1d(uniq, [0.0])
                bounds = (merged[:-1] + merged[1:]) / 2.0
            else:
                qs = np.linspace(0, 1, max(self.max_bin - 2, 2))[1:-1]
                bounds = np.unique(np.quantile(col, qs))
                seps = []
                neg = uniq[uniq < 0]
                pos = uniq[uniq > 0]
                if len(neg):
                    seps.append(neg.max() / 2.0)
                if len(pos):
                    seps.append(pos.min() / 2.0)
                bounds = np.unique(np.concatenate([bounds, seps]))
            self.boundaries_[int(fid)] = np.asarray(
                bounds[: self.max_bin - 1], np.float64)
        self.zero_bins_ = np.fromiter(
            (np.searchsorted(b, 0.0, side="left") + 1 for b in self.boundaries_),
            np.int32, count=f)
        return self

    def transform(self, x: CSRMatrix) -> "SparseBinnedView":
        """Bin the nonzeros and pack them into a COO view."""
        if x.shape[1] != self.num_features_:
            raise ValueError(
                f"expected {self.num_features_} features, got {x.shape[1]}")
        if np.isnan(x.data).any():
            raise ValueError("NaN stored values are not supported on the "
                             "sparse path (absent entries are zeros)")
        nnz = x.nnz
        order = np.argsort(x.indices, kind="stable")
        sorted_feats = x.indices[order]
        sorted_vals = x.data[order]
        feat_ids, starts = np.unique(sorted_feats, return_index=True)
        ends = np.append(starts[1:], nnz)
        sorted_codes = np.empty(nnz, np.uint8)
        for fid, s, e in zip(feat_ids, starts, ends):
            b = self.boundaries_[int(fid)]
            sorted_codes[s:e] = (
                np.searchsorted(b, sorted_vals[s:e], side="left") + 1
            ).astype(np.uint8)
        codes = np.empty(nnz, np.uint8)
        codes[order] = sorted_codes
        return SparseBinnedView(x, codes, self.zero_bins_, self.num_bins)

    def fit_transform(self, x: CSRMatrix) -> "SparseBinnedView":
        return self.fit(x).transform(x)

    def bin_upper_value(self, feature: int, bin_idx: int) -> float:
        """Same export rule as the dense BinMapper (goes-left if x <= value)."""
        bounds = self.boundaries_[feature]
        i = bin_idx - 1
        if i < 0:
            return -np.inf
        if i >= len(bounds):
            return np.inf
        return float(bounds[i])

    def encode_categoricals(self, x):
        return x  # no categoricals on the sparse path

    # ---- persistence ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "kind": "sparse",
            "max_bin": self.max_bin,
            "num_features": self.num_features_,
            "boundaries": [b.tolist() for b in self.boundaries_],
            "zero_bins": self.zero_bins_.tolist(),
        }

    @staticmethod
    def from_dict(d: dict) -> "SparseBinMapper":
        m = SparseBinMapper(d["max_bin"])
        m.num_features_ = d["num_features"]
        m.boundaries_ = [np.asarray(b, np.float64) for b in d["boundaries"]]
        m.zero_bins_ = np.asarray(d["zero_bins"], np.int32)
        return m


class SparseBinnedView:
    """Binned CSR exposed through the dense-binned-matrix indexing surface.

    The tree grower routes rows with `binned[:, feature]` (CSC column
    extraction, O(nnz_col)) and trees predict with `binned[rows, features]`
    (bisection over feature-major (f, row) keys, O(Q log nnz)); absent
    entries resolve to the feature's zero bin.  The COO arrays
    (`row_nz`/`feat_nz`/`bin_nz`, CSR row-major order) are what the
    histogram builder ships to device — O(nnz), never [N, F] or [N, K].
    """

    def __init__(self, csr: CSRMatrix, codes: np.ndarray,
                 zero_bins: np.ndarray, num_bins: int):
        n, f = csr.shape
        self.shape = (n, f)
        self.num_bins = int(num_bins)
        self.zero_bins = np.asarray(zero_bins, np.int32)
        self.indptr = csr.indptr
        lens = np.diff(csr.indptr)
        self.row_nz = np.repeat(np.arange(n, dtype=np.int32), lens)
        self.feat_nz = csr.indices.astype(np.int32)
        self.bin_nz = codes
        # CSC ordering for O(nnz_col) dense-column extraction + keyed gather
        order = np.argsort(csr.indices, kind="stable")
        self._csc_rows = self.row_nz[order]
        self._csc_bins = codes[order]
        feats = csr.indices[order]
        self._csc_ptr = np.searchsorted(feats, np.arange(f + 1))
        # feature-major, row-minor keys are globally sorted in CSC order
        self._keys = feats.astype(np.int64) * np.int64(n + 1) + self._csc_rows

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return np.dtype(np.uint8)

    @property
    def nnz(self) -> int:
        return len(self.bin_nz)

    def column(self, feature: int) -> np.ndarray:
        """Dense bin-code column [N] (absent rows = the zero bin)."""
        out = np.full(self.shape[0], self.zero_bins[feature], np.int32)
        s, e = self._csc_ptr[feature], self._csc_ptr[feature + 1]
        out[self._csc_rows[s:e]] = self._csc_bins[s:e]
        return out

    def gather(self, rows: np.ndarray, features: np.ndarray) -> np.ndarray:
        """Per-row code of a per-row feature: codes[rows[i], features[i]]."""
        rows = np.asarray(rows, np.int64)
        features = np.asarray(features, np.int64)
        if not len(self._keys):
            return self.zero_bins[features].copy()
        qk = features * np.int64(self.shape[0] + 1) + rows
        pos = np.searchsorted(self._keys, qk)
        safe = np.minimum(pos, len(self._keys) - 1)
        found = self._keys[safe] == qk
        return np.where(found, self._csc_bins[safe].astype(np.int32),
                        self.zero_bins[features])

    def __getitem__(self, key):
        rows, cols = key
        if np.isscalar(cols) or isinstance(cols, (int, np.integer)):
            col = self.column(int(cols))
            return col if isinstance(rows, slice) else col[rows]
        if isinstance(rows, slice):
            rows = np.arange(self.shape[0])[rows]
        return self.gather(np.asarray(rows), np.asarray(cols))


def build_histogram_coo(feat, bins, row, zero_bins, grad, hess, sample_weight,
                        node_mask, num_bins: int, num_features: int):
    """[F, B, 3] histogram from COO nonzeros + implicit-zero fix-up.

    feat/bins/row: [E] COO entries (feat == -1 marks padding); zero_bins:
    [F]; per-row arrays like the dense `build_histogram`.  Explicit mass
    scatter-adds by feature*B+bin (padding into one extra segment that is
    dropped); each feature's remaining node mass (total - explicit) is its
    implicit zeros and lands on zero_bins[f].  The fix-up's indices
    (arange(F), zero_bins) are unique, so a plain indexed add is exact.
    Accumulated in f64 and rounded to f32 once, as the dense build is.
    """
    hist, totals = coo_sums64(feat, bins, row, grad, hess, sample_weight,
                              node_mask, num_bins, num_features)
    return fix_zeros(hist, totals, zero_bins).to(grad.dtype)


def coo_sums64(feat, bins, row, grad, hess, sample_weight, node_mask,
               num_bins: int, num_features: int):
    """The f64 explicit-entry histogram [F, B, 3] and the node's f64
    totals [3] — the two linear parts a data-parallel build sums across
    ranks before the fix-up."""
    stacked = weighted_stats(grad, hess, sample_weight, node_mask)  # [N, 3]
    valid = feat >= 0
    ids = torch.where(valid, feat.long() * num_bins + bins.long(),
                      torch.full_like(feat, num_features * num_bins,
                                      dtype=torch.long))
    vals = stacked[row.long().clamp(min=0)] * valid[:, None]
    hist = torch.zeros(num_features * num_bins + 1, 3, dtype=stacked.dtype,
                       device=grad.device)
    hist.index_add_(0, ids, vals)
    return hist[:-1].view(num_features, num_bins, 3), stacked.sum(dim=0)


def fix_zeros(hist, totals, zero_bins):
    """Add each feature's implicit-zero mass (totals - explicit) at its
    zero bin."""
    explicit = hist.sum(dim=1)                                     # [F, 3]
    feats = torch.arange(hist.shape[0], device=hist.device)
    zb = zero_bins.long()
    hist[feats, zb] = hist[feats, zb] + (totals[None, :] - explicit)
    return hist


class SparseHistogramBuilder(RowShardedBuilderBase):
    """Duck-type of histogram.HistogramBuilder over a SparseBinnedView.

    The device residents are the O(nnz) COO arrays instead of the [N, F]
    dense codes (DatasetAggregator.scala's sparse variant).  Over a mesh
    each rank holds the COO entries of its own contiguous row block, with
    row indices local to the block (padded rows carry no entries); a
    build all-reduces the f64 explicit histogram and the node totals over
    the data group and applies the implicit-zero fix-up to the reduced
    sums, rounding to f32 once.
    """

    def __init__(self, view: SparseBinnedView, num_bins: int, mesh=None,
                 axis: str = "data", voting: bool = False, top_k: int = 20,
                 device=None):
        self.num_bins = int(num_bins)
        self.voting = bool(voting)
        self.top_k = int(top_k)
        n, self.f = view.shape
        self._shard_rows(n, mesh, axis, device)
        put = partial(torch.as_tensor, device=self.device)
        self.zero_bins = put(view.zero_bins)
        feat, bins, row = view.feat_nz, view.bin_nz, view.row_nz
        if mesh is not None:
            # this rank's contiguous row block's entry range (padded rows
            # lie beyond indptr's range and carry no entries)
            lo = min(self._block.start, n)
            hi = min(self._block.stop, n)
            e0, e1 = int(view.indptr[lo]), int(view.indptr[hi])
            feat, bins = feat[e0:e1], bins[e0:e1]
            row = (row[e0:e1] - self._block.start).astype(np.int32)
        self.feat, self.bins, self.row = put(feat), put(bins), put(row)

    def _sums(self, grad, hess, weight, mask):
        return coo_sums64(self.feat, self.bins, self.row, grad, hess, weight,
                          mask, self.num_bins, self.f)

    def build(self, grad, hess, weight, mask):
        hist, totals = self._sums(grad, hess, weight, mask)
        if self.mesh is not None:
            flat = self._all_reduce(torch.cat([hist.reshape(-1), totals]))
            hist = flat[:-3].view(hist.shape)
            totals = flat[-3:]
        return fix_zeros(hist, totals, self.zero_bins).to(grad.dtype)

    def build_local(self, grad, hess, weight, mask):
        hist, totals = self._sums(grad, hess, weight, mask)
        h = fix_zeros(hist, totals, self.zero_bins).to(grad.dtype)
        if self.mesh is None:
            return h[None]
        return self._all_gather(h)


def effective_sparse_max_bin(max_bin: int, num_features: int,
                             num_leaves: int = 31,
                             budget_bytes: float = 2e9) -> int:
    """Cap bins so the grower's working set of [F, B, 3] float32 histograms
    (one per open leaf, num_leaves of them at the worst) fits the budget —
    at 2^18 hashed features a 256-bin histogram alone is ~0.8 GB."""
    per_leaf = budget_bytes / max(num_leaves, 1)
    bins_budget = int(per_leaf / (max(num_features, 1) * 12)) - 1
    return max(3, min(int(max_bin), bins_budget))
