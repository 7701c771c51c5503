"""Quantile feature binning: raw float matrix -> uint8 bin codes.

The reference delegates binning to LightGBM's native `LGBM_DatasetCreate*`
(lightgbm/dataset/LightGBMDataset.scala:192) which builds per-feature bin
mappers from sampled data.  Here binning is a one-time host-side pass; the
binned matrix is what lives in device memory during training, cutting
memory 8x against f64 and making every histogram build an integer
scatter-add.

Missing values (NaN) get the dedicated bin 0, mirroring LightGBM's default
missing-bin handling.  Categorical features (declared by slot index, like
`categoricalSlotIndexes`, lightgbm/params/LightGBMParams.scala) are mapped
by frequency order instead of quantiles.  A host copy of the JAX
package's `gbdt/binning.py`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BinMapper"]

MISSING_BIN = 0


class BinMapper:
    """Per-feature quantile (or categorical-frequency) bin boundaries."""

    def __init__(
        self,
        max_bin: int = 255,
        categorical_features: Optional[Sequence[int]] = None,
        sample_count: int = 200_000,
        seed: int = 0,
    ):
        if not 2 <= max_bin <= 255:
            raise ValueError("max_bin must be in [2, 255]")
        self.max_bin = int(max_bin)
        self.categorical_features = sorted(set(categorical_features or []))
        self.sample_count = int(sample_count)
        self.seed = int(seed)
        # fitted state
        self.boundaries_: List[np.ndarray] = []       # per numeric feature: ascending thresholds
        self.categories_: Dict[int, Dict[float, int]] = {}  # per categorical feature: value -> bin
        self.num_features_: int = 0

    # ---- fit -----------------------------------------------------------
    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x, dtype=np.float64)
        n, f = x.shape
        self.num_features_ = f
        if n > self.sample_count:
            rng = np.random.default_rng(self.seed)
            x = x[rng.choice(n, self.sample_count, replace=False)]
        self.boundaries_ = []
        self.categories_ = {}
        cats = set(self.categorical_features)
        for j in range(f):
            col = x[:, j]
            col = col[~np.isnan(col)]
            if j in cats:
                # frequency-ordered category -> bin (1-based; 0 = missing/unseen)
                vals, counts = np.unique(col, return_counts=True)
                order = np.argsort(-counts)
                mapping = {}
                for rank, idx in enumerate(order[: self.max_bin - 1]):
                    mapping[float(vals[idx])] = rank + 1
                self.categories_[j] = mapping
                self.boundaries_.append(np.empty(0))
                continue
            if len(col) == 0:
                self.boundaries_.append(np.empty(0))
                continue
            # unique quantile boundaries; distinct-value fast path
            uniq = np.unique(col)
            if len(uniq) <= self.max_bin - 1:
                bounds = (uniq[:-1] + uniq[1:]) / 2.0
            else:
                qs = np.linspace(0, 1, self.max_bin)[1:-1]
                bounds = np.unique(np.quantile(col, qs))
            self.boundaries_.append(np.asarray(bounds, dtype=np.float64))
        return self

    @property
    def num_bins(self) -> int:
        """Total bins per feature incl. the missing bin (uniform across
        features so histograms are a dense [F, B] array on device)."""
        return self.max_bin + 1

    # ---- transform -----------------------------------------------------
    def transform(self, x: np.ndarray) -> np.ndarray:
        """float [N, F] -> uint8 bin codes [N, F]; NaN -> bin 0."""
        x = np.asarray(x, dtype=np.float64)
        n, f = x.shape
        if f != self.num_features_:
            raise ValueError(f"expected {self.num_features_} features, got {f}")
        out = np.zeros((n, f), dtype=np.uint8)
        for j in range(f):
            col = x[:, j]
            nan = np.isnan(col)
            if j in self.categories_:
                mapping = self.categories_[j]
                binned = np.zeros(n, dtype=np.int64)
                for v, b in mapping.items():
                    binned[col == v] = b
            else:
                # +1 shifts past the missing bin
                binned = np.searchsorted(self.boundaries_[j], col, side="left") + 1
            binned[nan] = MISSING_BIN
            out[:, j] = binned.astype(np.uint8)
        return out

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def bin_upper_value(self, feature: int, bin_idx: int) -> float:
        """Raw-value threshold for 'goes left if x <= value' at a split on
        `bin_idx` (used to export trees that predict on raw floats).

        Categorical features split on the frequency-ordered *bin code*, so the
        exported threshold is the bin index itself and inference must map raw
        category values through `encode_categoricals` first."""
        if feature in self.categories_:
            return float(bin_idx)
        bounds = self.boundaries_[feature]
        i = bin_idx - 1  # undo missing-bin shift
        if i < 0:
            return -np.inf
        if i >= len(bounds):
            return np.inf
        return float(bounds[i])

    def encode_categoricals(self, x: np.ndarray) -> np.ndarray:
        """Replace categorical columns of a raw float matrix with their bin
        codes (unseen/missing -> 0) so trees exported with bin-code
        thresholds evaluate correctly at inference."""
        if not self.categories_:
            return x
        x = np.array(x, dtype=np.float64, copy=True)
        for j, mapping in self.categories_.items():
            col = x[:, j]
            coded = np.zeros(len(col))
            for v, b in mapping.items():
                coded[col == v] = b
            coded[np.isnan(col)] = 0.0
            x[:, j] = coded
        return x

    # ---- persistence ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "max_bin": self.max_bin,
            "categorical_features": self.categorical_features,
            "num_features": self.num_features_,
            "boundaries": [b.tolist() for b in self.boundaries_],
            "categories": {str(k): {str(v): b for v, b in m.items()}
                           for k, m in self.categories_.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        m = BinMapper(d["max_bin"], d["categorical_features"])
        m.num_features_ = d["num_features"]
        m.boundaries_ = [np.asarray(b, dtype=np.float64) for b in d["boundaries"]]
        m.categories_ = {int(k): {float(v): int(b) for v, b in mm.items()}
                         for k, mm in d.get("categories", {}).items()}
        return m
