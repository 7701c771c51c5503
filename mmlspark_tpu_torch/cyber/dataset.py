"""Synthetic access-log factory for CyberML workloads.

Reference: core/src/main/python/mmlspark/cyber/dataset.py:11-163
(DataFactory) — three departments (hr/fin/eng) whose users access their
own department's resources plus a shared join resource, with generators
for clustered TRAINING data (in-department edges), INTRA-department test
data (new in-department pairs — should score normal), and
INTER-department test data (cross-department pairs — should score
anomalous).  The reference's AccessAnomaly tests are built on exactly
these three splits; tests/test_cyber.py mirrors that shape here.

Emits columnar Tables (user/res/likelihood) ready for IdIndexer +
AccessAnomaly instead of pandas DataFrames.

A copy of the JAX package's `cyber/dataset.py` for this package.
"""
from __future__ import annotations

import itertools
import random
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.schema import Table

__all__ = ["DataFactory"]


class DataFactory:
    def __init__(self, num_hr_users: int = 7, num_hr_resources: int = 30,
                 num_fin_users: int = 5, num_fin_resources: int = 25,
                 num_eng_users: int = 10, num_eng_resources: int = 50,
                 single_component: bool = True, seed: int = 42):
        self.hr_users = [f"hr_user_{i}" for i in range(num_hr_users)]
        self.hr_resources = [f"hr_res_{i}" for i in range(num_hr_resources)]
        self.fin_users = [f"fin_user_{i}" for i in range(num_fin_users)]
        self.fin_resources = [f"fin_res_{i}"
                              for i in range(num_fin_resources)]
        self.eng_users = [f"eng_user_{i}" for i in range(num_eng_users)]
        self.eng_resources = [f"eng_res_{i}"
                              for i in range(num_eng_resources)]
        # one resource everyone touches keeps the access graph a single
        # connected component (the reference's 'ffa' join resource)
        self.join_resources = ["ffa"] if single_component else []
        self.rand = random.Random(seed)

    def _table(self, tups: List[Tuple[str, str, float]]) -> Table:
        return Table({
            "user_id": np.asarray([t[0] for t in tups], object),
            "res_id": np.asarray([t[1] for t in tups], object),
            "likelihood": np.asarray([float(t[2]) for t in tups],
                                     np.float64),
        })

    def edges_between(self, users: Sequence[str], resources: Sequence[str],
                      ratio: float, full_node_coverage: bool,
                      not_set: Optional[Set[Tuple[str, str]]] = None,
                      ) -> List[Tuple[str, str, float]]:
        """Sample distinct (user, resource, weight) edges covering `ratio`
        of the bipartite graph; `full_node_coverage` keeps sampling until
        every node has at least one edge; `not_set` excludes pairs (so a
        test split never repeats a training pair)."""
        if not users or not resources:
            return []
        required = len(users) * len(resources) * ratio
        tups: List[Tuple[str, str, float]] = []
        seen: Set[Tuple[int, int]] = set()
        seen_u: Set[int] = set()
        seen_r: Set[int] = set()
        # dense ratios pre-materialize the pair universe (same
        # optimization as the reference :75); the sparse path caps its
        # rejection-sampling attempts — a not_set covering the whole
        # graph must return what exists, not spin forever
        cart = (list(itertools.product(range(len(users)),
                                       range(len(resources))))
                if ratio >= 0.5 else None)
        attempts_left = 50 * len(users) * len(resources)
        while (len(tups) < required
               or (full_node_coverage and (len(seen_u) < len(users)
                                           or len(seen_r) < len(resources)))):
            if cart is not None:
                if not cart:
                    break
                ii = self.rand.randint(0, len(cart) - 1)
                ui, ri = cart[ii]
                cart[ii] = cart[-1]
                cart.pop()
            else:
                attempts_left -= 1
                if attempts_left < 0:
                    break
                ui = self.rand.randint(0, len(users) - 1)
                ri = self.rand.randint(0, len(resources) - 1)
            pair = (users[ui], resources[ri])
            if (ui, ri) in seen or (not_set is not None and pair in not_set):
                continue
            seen.add((ui, ri))
            seen_u.add(ui)
            seen_r.add(ri)
            tups.append((*pair, float(self.rand.randint(500, 1000))))
        return tups

    def create_clustered_training_data(self, ratio: float = 0.25) -> Table:
        return self._table(
            self.edges_between(self.hr_users, self.join_resources, 1.0, True)
            + self.edges_between(self.fin_users, self.join_resources, 1.0,
                                 True)
            + self.edges_between(self.eng_users, self.join_resources, 1.0,
                                 True)
            + self.edges_between(self.hr_users, self.hr_resources, ratio,
                                 True)
            + self.edges_between(self.fin_users, self.fin_resources, ratio,
                                 True)
            + self.edges_between(self.eng_users, self.eng_resources, ratio,
                                 True))

    def create_clustered_intra_test_data(self,
                                         train: Optional[Table] = None
                                         ) -> Table:
        """NEW in-department pairs (never in `train`) — the should-score-
        normal split."""
        not_set = (set(zip(train["user_id"], train["res_id"]))
                   if train is not None else None)
        return self._table(
            self.edges_between(self.hr_users, self.hr_resources, 0.025,
                               False, not_set)
            + self.edges_between(self.fin_users, self.fin_resources, 0.05,
                                 False, not_set)
            + self.edges_between(self.eng_users, self.eng_resources, 0.035,
                                 False, not_set))

    def create_clustered_inter_test_data(self) -> Table:
        """Cross-department pairs — the should-score-anomalous split."""
        return self._table(
            self.edges_between(self.hr_users, self.fin_resources, 0.025,
                               False)
            + self.edges_between(self.hr_users, self.eng_resources, 0.025,
                                 False)
            + self.edges_between(self.fin_users, self.hr_resources, 0.05,
                                 False)
            + self.edges_between(self.fin_users, self.eng_resources, 0.05,
                                 False)
            + self.edges_between(self.eng_users, self.fin_resources, 0.035,
                                 False)
            + self.edges_between(self.eng_users, self.hr_resources, 0.035,
                                 False))
