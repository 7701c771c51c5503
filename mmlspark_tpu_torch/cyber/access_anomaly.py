"""AccessAnomaly: collaborative-filtering anomalous-access detection.

Reference: core python mmlspark/cyber/anomaly/collaborative_filtering.py
(988 LoC) — per-tenant ALS user/resource embeddings fit on observed access
(plus sampled complement pairs with zero affinity), scored as the
standardized NEGATIVE predicted affinity: high score = the model did not
expect this (user, resource) access.

Counterpart of the JAX package's `cyber/access_anomaly.py`, with its
Params, defaults and output columns.  `ComplementAccessTransformer` and
`AccessAnomalyModel._transform` are host copies, and the factors stay
numpy, so a model the JAX package fitted scores here.  The per-tenant ALS
sweep (`_als_step_sparse`) runs on the fit's `device` — the card unless
the caller passes ``device="cpu"`` — as stock PyTorch in full f32
(`models/linear._full_f32`): the Gram `YᵀY`, the `(nnz, r, r)` outer
products, `index_add_` in place of `jax.ops.segment_sum`, and one batched
`torch.linalg.solve` for every row factor.  The observed sums `A_obs` and
`b` accumulate in f64 and round to f32 once: CUDA's float `index_add_`
adds in no fixed order, and in f32 two card fits would differ in the last
bits, which ten sweeps carry into the factors; in f64 the rounding to f32
absorbs the order almost always.  The initial factors come from
`_initial_factors`, N(0, 0.1²) draws of a `torch.Generator` seeded with
`seed` on the host: the JAX package draws them with `jax.random`, which
PyTorch cannot reproduce (the tests inject the JAX draws there).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import DEVICE_DOC, resolve_device
from ..models.linear import _full_f32

__all__ = ["AccessAnomaly", "AccessAnomalyModel",
           "ComplementAccessTransformer"]


@register_stage
class ComplementAccessTransformer(Transformer):
    """Sample (user, res) pairs NOT present in the access table.

    Reference: cyber/anomaly/complement_access.py (148 LoC) — emits
    `complement_ratio` x len(table) unseen pairs per tenant.
    """

    tenant_col = Param("tenant column ('' = single tenant)", default="")
    user_col = Param("indexed user column", default="user")
    res_col = Param("indexed resource column", default="res")
    complement_ratio = Param("complement rows per observed row", default=1.0,
                             converter=TypeConverters.to_float)
    seed = Param("sampling seed", default=0, converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        rng = np.random.default_rng(int(self.seed))
        tenants = (
            np.asarray(table[self.tenant_col])
            if self.tenant_col and self.tenant_col in table
            else np.zeros(len(table), np.int64)
        )
        users = np.asarray(table[self.user_col], np.int64)
        ress = np.asarray(table[self.res_col], np.int64)
        out_t, out_u, out_r = [], [], []
        for t in np.unique(tenants):
            m = tenants == t
            seen = set(zip(users[m].tolist(), ress[m].tolist()))
            n_users = users[m].max() + 1
            n_res = ress[m].max() + 1
            want = int(m.sum() * float(self.complement_ratio))
            grid = n_users * n_res
            budget = grid - len(seen)
            want = min(want, max(budget, 0))
            # dense access matrices defeat rejection sampling; enumerate the
            # complement exactly when unseen pairs are scarce
            if budget <= 4 * want or budget < 0.05 * grid:
                all_keys = np.arange(grid, dtype=np.int64)
                seen_keys = np.fromiter(
                    (u * n_res + r for u, r in seen), np.int64, len(seen)
                )
                unseen = np.setdiff1d(all_keys, seen_keys,
                                      assume_unique=False)
                pick = rng.choice(len(unseen), size=want, replace=False)
                for key in unseen[pick]:
                    out_t.append(t)
                    out_u.append(int(key // n_res))
                    out_r.append(int(key % n_res))
            else:
                got = 0
                attempts = 0
                while got < want and attempts < 50 * max(want, 1):
                    u = int(rng.integers(n_users))
                    r = int(rng.integers(n_res))
                    attempts += 1
                    if (u, r) not in seen:
                        seen.add((u, r))
                        out_t.append(t)
                        out_u.append(u)
                        out_r.append(r)
                        got += 1
        data = {
            self.user_col: np.asarray(out_u, np.int64),
            self.res_col: np.asarray(out_r, np.int64),
        }
        if self.tenant_col:
            data[self.tenant_col] = np.asarray(out_t)
        return Table(data)


def _als_step_sparse(Y: torch.Tensor, row_idx: torch.Tensor,
                     col_idx: torch.Tensor, vals: torch.Tensor, c0: float,
                     l2: float, rank: int, n_rows: int) -> torch.Tensor:
    """Sparse weighted ALS sweep (Hu-Koren construction).

    Solves every row factor given column factors Y with weights:
    1 on observed (row_idx, col_idx) entries, c0 on everything else, and
    target values `vals` on observed entries (0 elsewhere).  Memory is
    O(nnz * rank^2 + n_rows * rank^2) — no dense (rows x cols) matrix.

    A_u = c0 * YᵀY + (1 - c0) * Σ_obs y_r y_rᵀ + l2 I
    b_u = Σ_obs a_ur y_r

    Y: (n_cols, rank) f32; row_idx, col_idx: (nnz,) int64; vals: (nnz,)
    f32, all on one device; returns the (n_rows, rank) f32 row factors.
    """
    with _full_f32():
        G = Y.T @ Y  # (rank, rank) shared gram
        y_obs = Y[col_idx].double()  # (nnz, rank)
        outer = y_obs[:, :, None] * y_obs[:, None, :]
        A_obs = torch.zeros(n_rows, rank, rank, dtype=torch.float64,
                            device=Y.device).index_add_(0, row_idx, outer)
        b = torch.zeros(n_rows, rank, dtype=torch.float64,
                        device=Y.device).index_add_(
                            0, row_idx, y_obs * vals.double()[:, None])
        A = (c0 * G[None] + (1.0 - c0) * A_obs.float()
             + l2 * torch.eye(rank, dtype=Y.dtype, device=Y.device))
        return torch.linalg.solve(A, b.float()[..., None])[..., 0]


def _initial_factors(seed: int, n_users: int, n_res: int, rank: int,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tenant's initial (user, resource) factors: N(0, 0.1²) f32 draws of
    a host `torch.Generator` seeded with `seed`, so the CPU and the card
    start from the same factors."""
    gen = torch.Generator().manual_seed(int(seed))
    X = torch.randn((n_users, rank), generator=gen, dtype=torch.float32) * 0.1
    Y = torch.randn((n_res, rank), generator=gen, dtype=torch.float32) * 0.1
    return X.to(device), Y.to(device)


@register_stage
class AccessAnomaly(Estimator):
    tenant_col = Param("tenant column ('' = single tenant)", default="")
    user_col = Param("indexed user column", default="user")
    res_col = Param("indexed resource column", default="res")
    likelihood_col = Param("optional access-count column", default="")
    output_col = Param("anomaly score column", default="anomaly_score")
    rank = Param("embedding rank", default=8, converter=TypeConverters.to_int)
    max_iter = Param("ALS sweeps", default=10, converter=TypeConverters.to_int)
    reg_param = Param("ALS l2", default=0.1, converter=TypeConverters.to_float)
    complement_ratio = Param("zero-affinity complement rows per observed row",
                             default=1.0, converter=TypeConverters.to_float)
    seed = Param("seed", default=0, converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "AccessAnomalyModel":
        dev = resolve_device(self.device)
        tenants = (
            np.asarray(table[self.tenant_col])
            if self.tenant_col and self.tenant_col in table
            else np.zeros(len(table), np.int64)
        )
        users = np.asarray(table[self.user_col], np.int64)
        ress = np.asarray(table[self.res_col], np.int64)
        counts = (
            np.asarray(table[self.likelihood_col], np.float64)
            if self.likelihood_col and self.likelihood_col in table
            else np.ones(len(table))
        )
        factors: Dict = {}
        stats: Dict = {}
        rank = int(self.rank)
        l2 = float(np.float32(self.reg_param))
        for t in np.unique(tenants):
            m = tenants == t
            u, r, c = users[m], ress[m], counts[m]
            n_users, n_res = int(u.max()) + 1, int(r.max()) + 1
            # dedupe observed pairs, summing counts (sparse COO)
            pair_key = u.astype(np.int64) * n_res + r
            uniq, inv = np.unique(pair_key, return_inverse=True)
            acc = np.zeros(len(uniq), np.float64)
            np.add.at(acc, inv, c)
            uu = (uniq // n_res).astype(np.int32)
            rr = (uniq % n_res).astype(np.int32)
            affinity = np.log1p(acc).astype(np.float32)
            # unobserved cells participate with weight complement_ratio and
            # target 0 (the reference samples explicit complement zeros);
            # the sparse sweep never materializes the dense matrix
            c0 = float(np.float32(
                min(max(float(self.complement_ratio), 0.0), 1.0)))
            uu_t = torch.as_tensor(uu.astype(np.int64), device=dev)
            rr_t = torch.as_tensor(rr.astype(np.int64), device=dev)
            a_t = torch.as_tensor(affinity, device=dev)
            X, Y = _initial_factors(int(self.seed), n_users, n_res, rank, dev)
            for _ in range(int(self.max_iter)):
                X = _als_step_sparse(Y, uu_t, rr_t, a_t, c0, l2, rank,
                                     n_users)
                Y = _als_step_sparse(X, rr_t, uu_t, a_t, c0, l2, rank, n_res)
            X, Y = X.cpu().numpy(), Y.cpu().numpy()
            factors[t] = (X, Y)
            # standardization stats over OBSERVED pairs' predicted affinity
            pred = np.einsum("ij,ij->i", X[uu], Y[rr])
            stats[t] = (float(pred.mean()), float(pred.std() + 1e-9))
        return AccessAnomalyModel(
            factors=factors, stats=stats,
            tenant_col=self.tenant_col, user_col=self.user_col,
            res_col=self.res_col, output_col=self.output_col,
        )


@register_stage
class AccessAnomalyModel(Model):
    tenant_col = Param("tenant column", default="")
    user_col = Param("indexed user column", default="user")
    res_col = Param("indexed resource column", default="res")
    output_col = Param("anomaly score column", default="anomaly_score")
    factors = ComplexParam("per-tenant (user_factors, res_factors)")
    stats = ComplexParam("per-tenant (mean, std) of observed affinity")

    def _transform(self, table: Table) -> Table:
        tenants = (
            np.asarray(table[self.tenant_col])
            if self.tenant_col and self.tenant_col in table
            else np.zeros(len(table), np.int64)
        )
        users = np.asarray(table[self.user_col], np.int64)
        ress = np.asarray(table[self.res_col], np.int64)
        out = np.zeros(len(table), np.float64)
        for t in np.unique(tenants):
            m = tenants == t
            if t not in self.factors:
                out[m] = np.nan
                continue
            X, Y = self.factors[t]
            mean, std = self.stats[t]
            u, r = users[m], ress[m]
            ok = (u >= 0) & (u < X.shape[0]) & (r >= 0) & (r < Y.shape[0])
            pred = np.zeros(m.sum())
            pred[ok] = np.einsum("ij,ij->i", X[u[ok]], Y[r[ok]])
            # unseen user/resource: affinity 0 (maximally unexpected)
            out[m] = -(pred - mean) / std
        return table.with_column(self.output_col, out)
