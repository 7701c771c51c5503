"""SAR: Smart Adaptive Recommendations (item-item collaborative filtering).

Reference: core recommendation/SAR.scala:36-260 (co-occurrence similarity
jaccard/lift, time-decayed user affinities) and SARModel.scala (178 LoC,
recommend-for-all-users via BLAS gemv over broadcast item factors).

Counterpart of the JAX package's `recommendation/sar.py`, with its
Params, defaults and output columns.  The reference computes
co-occurrence with DataFrame self-joins and scores users with per-row
gemv; here the binarized user-item matrix B lives on the card in f32,
co-occurrence C = Bᵀ B is one matmul (exact for 0/1 entries below 2^24
co-occurrences: full f32 products, `models/linear._full_f32`), jaccard
and lift divide by the raw counts with the support threshold on the raw
co-occurrence, and recommend-for-all-users is the (users × items) @
(items × items) product plus a top-k of the unseen items with
`jax.lax.top_k`'s order, ties to the lower index
(`ops/topk.topk_lower_index`): zero scores and masked seen items tie
often.  The affinities and similarities are numpy, as in the JAX
package, so its models' matrices build this package's.  Each stage has a
`device` Param: the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import DEVICE_DOC, resolve_device
from ..ops.topk import topk_lower_index

__all__ = ["SAR", "SARModel"]


def _cooccurrence(B: torch.Tensor) -> torch.Tensor:
    from ..models.linear import _full_f32

    with _full_f32():
        return B.T @ B


def _jaccard(C: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    denom = counts[:, None] + counts[None, :] - C
    return torch.where(denom > 0, C / torch.clamp(denom, min=1e-12), 0.0)


def _lift(C: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    denom = counts[:, None] * counts[None, :]
    return torch.where(denom > 0, C / torch.clamp(denom, min=1e-12), 0.0)


def _topk_unseen(scores: torch.Tensor, seen: torch.Tensor, k: int):
    """Mask already-seen items to -inf, take top-k per user."""
    masked = torch.where(seen > 0, float("-inf"), scores)
    return topk_lower_index(masked, k)


@register_stage
class SAR(Estimator):
    """Fit time-decayed affinities + item-item similarity.

    Expects integer-indexed user/item columns (use RecommendationIndexer
    first, as the reference pipelines do).
    """

    user_col = Param("user index column", default="user")
    item_col = Param("item index column", default="item")
    rating_col = Param("rating column", default="rating")
    timestamp_col = Param("optional timestamp column (seconds)", default="")
    similarity_function = Param("jaccard|lift|cooccurrence", default="jaccard")
    time_decay_coeff = Param("half-life in days for affinity decay", default=30,
                             converter=TypeConverters.to_int)
    support_threshold = Param("min co-occurrence support", default=4,
                              converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "SARModel":
        users = np.asarray(table[self.user_col], np.int64)
        items = np.asarray(table[self.item_col], np.int64)
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0
        ratings = (
            np.asarray(table[self.rating_col], np.float32)
            if self.rating_col in table
            else np.ones(len(table), np.float32)
        )

        ts_col = self.timestamp_col
        if ts_col and ts_col in table:
            ts = np.asarray(table[ts_col], np.float64)
            ref = ts.max()
            half_life_s = float(self.time_decay_coeff) * 86400.0
            decay = np.power(2.0, -(ref - ts) / half_life_s).astype(np.float32)
        else:
            decay = np.ones(len(table), np.float32)

        # affinity: sum of decayed ratings per (user, item)
        affinity = np.zeros((n_users, n_items), np.float32)
        np.add.at(affinity, (users, items), ratings * decay)

        # item-item co-occurrence on the card (one matmul).  Semantics
        # are reference-exact (SAR.scala:185-199, verified against the
        # committed sim_{count,jac,lift}{1,3} fixtures): the support
        # threshold zeroes entries whose RAW co-occurrence is below it —
        # including the diagonal (cooc(i,i) = occ(i)) — while surviving
        # entries divide by the raw counts; the diagonal is kept (seen-item
        # masking, not a zeroed diagonal, is what stops self-recommendation).
        dev = resolve_device(self.device)
        B = torch.as_tensor((affinity > 0).astype(np.float32), device=dev)
        C = _cooccurrence(B)
        counts = torch.diagonal(C)  # occ(i): co-occurrence with itself

        fn = self.similarity_function
        if fn == "jaccard":
            S = _jaccard(C, counts)
        elif fn == "lift":
            S = _lift(C, counts)
        elif fn == "cooccurrence":
            S = C
        else:
            raise ValueError(f"unknown similarity_function {fn!r}")
        S = torch.where(C >= float(self.support_threshold), S, 0.0)

        return SARModel(
            user_affinity=affinity,
            item_similarity=S.cpu().numpy(),
            user_col=self.user_col, item_col=self.item_col,
            rating_col=self.rating_col, device=self.device,
        )


@register_stage
class SARModel(Model):
    """Scores = affinity @ similarity; top-k with seen-item masking.

    Reference: SARModel.scala recommendForAllUsers / transform.
    """

    user_col = Param("user index column", default="user")
    item_col = Param("item index column", default="item")
    rating_col = Param("rating column", default="rating")
    prediction_col = Param("prediction column", default="prediction")
    user_affinity = ComplexParam("(n_users, n_items) affinity matrix")
    item_similarity = ComplexParam("(n_items, n_items) similarity matrix")
    device = Param(DEVICE_DOC, default=None)

    def _scores(self) -> torch.Tensor:
        from ..models.linear import _full_f32

        dev = resolve_device(self.device)
        A = torch.as_tensor(np.require(self.user_affinity, np.float32, "W"),
                            device=dev)
        S = torch.as_tensor(np.require(self.item_similarity, np.float32, "W"),
                            device=dev)
        with _full_f32():
            return A @ S

    def recommend_for_all_users(self, k: int = 10) -> Table:
        """Per-user top-k unseen items: Table(user, recommendations, scores)."""
        A = np.asarray(self.user_affinity)
        k = min(int(k), A.shape[1])  # top-k requires k <= item count
        scores = self._scores()
        vals, idx = _topk_unseen(scores, torch.as_tensor(
            (A > 0).astype(np.float32), device=scores.device), k)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        n_users = A.shape[0]
        recs = np.empty(n_users, dtype=object)
        scs = np.empty(n_users, dtype=object)
        for u in range(n_users):
            good = np.isfinite(vals[u])
            recs[u] = idx[u][good].astype(np.int64)
            scs[u] = vals[u][good].astype(np.float32)
        return Table({
            self.user_col: np.arange(n_users, dtype=np.int64),
            "recommendations": recs,
            "scores": scs,
        })

    def _transform(self, table: Table) -> Table:
        users = np.asarray(table[self.user_col], np.int64)
        items = np.asarray(table[self.item_col], np.int64)
        scores = self._scores().cpu().numpy()
        n_users, n_items = scores.shape
        ok = (users >= 0) & (users < n_users) & (items >= 0) & (items < n_items)
        out = np.zeros(len(table), np.float32)
        out[ok] = scores[users[ok], items[ok]]
        return table.with_column(self.prediction_col, out)
