"""Tie-aware comparison of a GBDT fit of the JAX package with the same fit
of mmlspark_tpu_torch (shared by the test_torch_gbdt*.py and
test_torch_online_stats.py files), or of a port fit on the card with the
same fit on the CPU (tests/test_torch_cuda.py and chip_smoke.py, which
import nothing of JAX: neither does this module).

Tree structure is discrete: XLA's CPU cumsum (a windowed reduction) does
not round as `torch.cumsum` does, so where two split candidates score
within rounding of each other — most often a pure node, whose every split
has an exact gain of 0 and an f32 gain of a few ulps of the node's
scores — the two engines may pick different ones.  So the JAX fit records
every `best_split` call (its histogram and result), and the port's fit
runs under `following_splits`, which compares each of its calls with the
JAX call of the same rank:

  - the two histograms must be the same node's, within `TOL` of the
    node's absolute mass channel by channel;
  - where the chosen splits differ, the two candidates' gains, recomputed
    in f64 on the JAX histogram, must lie within `TIE_GAP` of each other
    relative to the scores each gain sums, S(G_l, H_l) + S(G_r, H_r) +
    S(G, H) with S(g, h) = T(g)^2 / (h + lambda_l2) (f32 rounds each gain
    at that scale, not at the gain's own), and the JAX candidate must be
    valid on the port's histogram; a larger gap is a fault.  The tie is
    reported, and the port then takes the JAX candidate (its stats from
    the port's own histogram), so the rest of the fit stays comparable: a
    GOSS sample, for one, is chaotic in the last bits of the scores;
  - the port's gain must lie within `TIE_GAP` of the JAX gain at the same
    scale; the port's leaf heap then orders by the JAX gain, since two
    leaves whose gains are within rounding (pure nodes' noise gains, a
    few ulps each) are a tie of the same kind.

`compare_fits` then holds every tree equal (split feature, threshold bin,
children) with values at `TOL`.  A failed check raises AssertionError.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

TIE_GAP = 1e-5
TOL = 1e-4


def _hist64(hist, features=None):
    if features is not None:
        idx = np.asarray(features, np.int64)
        hist = hist[torch.as_tensor(idx) if hasattr(hist, "cpu") else idx]
    h = hist.cpu().numpy() if hasattr(hist, "cpu") else np.asarray(hist)
    return np.asarray(h, np.float64)


@contextlib.contextmanager
def recorded_splits(tree_module, features=None):
    """Record every `best_split` call of the grower in `tree_module` (the
    JAX package's gbdt.tree): [(hist f64, (l1, l2, ...), split)].

    `features` (sorted indices; a hashed space's active features, the
    only ones a split can use) keeps only those rows of each histogram."""
    calls = []
    orig = tree_module.best_split

    def rec(hist, l1, l2, min_data, min_hess, min_gain, feature_mask=None):
        split = orig(hist, l1, l2, min_data, min_hess, min_gain, feature_mask)
        calls.append((_hist64(hist, features),
                      (l1, l2, min_data, min_hess, min_gain), split))
        return split

    tree_module.best_split = rec
    try:
        yield calls
    finally:
        tree_module.best_split = orig


def _key(split):
    return None if split is None else (split.feature, split.bin_threshold)


def _score(g, h, l1, l2):
    t = np.sign(g) * max(abs(g) - l1, 0.0)
    return t * t / (h + l2 + 1e-15)


def gain64(hist, split, l1, l2, features=None):
    """(gain of `split` in f64 on `hist`, the magnitude of the scores it
    sums: S(G_l, H_l) + S(G_r, H_r) + S(G, H))."""
    node = hist[0].sum(axis=0)
    parent = _score(node[0], node[1], l1, l2)
    if split is None:
        return 0.0, parent
    row = split.feature if features is None else \
        int(np.searchsorted(features, split.feature))
    assert features is None or features[row] == split.feature
    cs = np.cumsum(hist[row], axis=0)
    left, right = cs[split.bin_threshold], cs[-1] - cs[split.bin_threshold]
    sl, sr = _score(left[0], left[1], l1, l2), _score(right[0], right[1],
                                                       l1, l2)
    return sl + sr - parent, sl + sr + parent


def _split_at(hist, ref, args):
    """The port's SplitInfo for the reference's candidate `ref` on the
    port's histogram (None for None)."""
    from mmlspark_tpu_torch.gbdt.histogram import SplitInfo, _split_scores

    if ref is None:
        return None
    l1, l2, min_data, min_hess, _ = args
    gain = float(_split_scores(hist, l1, l2, min_data, min_hess)[
        ref.feature, ref.bin_threshold])
    assert np.isfinite(gain), f"the reference's split {ref} is not valid " \
        "on the port's histogram"
    cs = torch.cumsum(hist[ref.feature], dim=0)
    left = cs[ref.bin_threshold]
    right = cs[-1] - left
    return SplitInfo(ref.feature, ref.bin_threshold, gain,
                     *map(float, left.tolist()), *map(float, right.tolist()))


def hist_err(got, want) -> float:
    """Largest difference of two [F, B, 3] histograms relative to the
    node's absolute mass, channel by channel (a root's gradient sum is
    near 0 by construction)."""
    scale = np.abs(want[0]).sum(axis=0)[None, None, :] + 1.0
    return float((np.abs(np.asarray(got) - want) / scale).max())


def _assert_hist_close(got, want, msg):
    err = hist_err(got, want)
    assert err <= TOL, f"{msg}: {err:.3g} of the node's mass off"


@contextlib.contextmanager
def following_splits(tree_module, ref_calls, label="", ref_trees=None,
                     features=None, prefix=False):
    """Run the port's grower (`tree_module`: the port's gbdt.tree) against
    the reference fit's recorded calls by the tie rule; yields (calls,
    ties).  `prefix`: the fit runs longer than the reference's, and only
    its first len(ref_calls) calls are held.

    `ref_trees` (the JAX booster's trees, for GOSS): each grown tree is
    held to the JAX tree of the same rank (structure exact, values at TOL)
    and then takes the JAX leaf values.  GOSS keeps the top rows by
    |gradient| with `argpartition`, which picks among exactly tied values
    (the rows of one leaf): a leaf value one ulp off reorders two leaves
    and draws another sample, so without this no tree after the first is
    comparable."""
    calls, ties = [], []
    orig = tree_module.best_split
    orig_grow = tree_module.TreeGrower.grow
    grown = []

    def grow(self, *args, **kwargs):
        tree = orig_grow(self, *args, **kwargs)
        ref = ref_trees[len(grown)]
        assert_tree_equal(ref, tree, f"{label} tree {len(grown)}")
        grown.append(tree)
        tree.value = np.array(ref.value, np.float64)
        return tree

    def rec(hist, l1, l2, min_data, min_hess, min_gain, feature_mask=None):
        split = orig(hist, l1, l2, min_data, min_hess, min_gain, feature_mask)
        k = len(calls)
        args = (l1, l2, min_data, min_hess, min_gain)
        if prefix and k >= len(ref_calls):
            return split
        assert k < len(ref_calls), f"{label}: more split calls than the " \
            f"reference fit's {len(ref_calls)}"
        jh, _, ref = ref_calls[k]
        h = _hist64(hist, features)
        _assert_hist_close(h, jh, f"{label}: split call {k}")
        g_jax, m_jax = gain64(jh, ref, l1, l2, features)
        if _key(split) != _key(ref):
            g_port, m_port = gain64(jh, split, l1, l2, features)
            gap = abs(g_jax - g_port) / max(m_jax, m_port, 1e-30)
            tie = {"call": k, "jax": _key(ref), "port": _key(split),
                   "gain_jax": g_jax, "gain_port": g_port,
                   "score_scale": max(m_jax, m_port), "relative_gap": gap}
            print(f"{label}: tie at split call {k}, steered: {tie}",
                  flush=True)
            assert gap <= TIE_GAP, f"{label}: the differing split is no " \
                f"tie: {tie}"
            ties.append(tie)
            split = _split_at(hist, ref, args)
        if split is not None:
            # the leaf heap orders by gain: near-equal gains of two leaves
            # are a tie too, so the port's heap takes the JAX gain
            assert abs(split.gain - ref.gain) <= TIE_GAP * max(m_jax, 1e-30), \
                (label, k, split.gain, ref.gain, m_jax)
            split = split._replace(gain=ref.gain)
        calls.append((h, args, split))
        return split

    tree_module.best_split = rec
    if ref_trees is not None:
        tree_module.TreeGrower.grow = grow
    try:
        yield calls, ties
    finally:
        tree_module.best_split = orig
        tree_module.TreeGrower.grow = orig_grow
    assert len(calls) == len(ref_calls), (label, len(calls), len(ref_calls))


def compare_fits(jax_booster, port_booster, label: str = "",
                 n_trees=None) -> None:
    """Every tree equal in structure, values within TOL; init scores and
    tree weights equal.  `n_trees`: only the first n_trees of each."""
    jt, pt = jax_booster.trees[:n_trees], port_booster.trees[:n_trees]
    assert len(jt) == len(pt), (label, len(jt), len(pt))
    np.testing.assert_allclose(port_booster.init_score,
                               jax_booster.init_score, rtol=1e-12)
    np.testing.assert_allclose(port_booster.tree_weights[:n_trees],
                               jax_booster.tree_weights[:n_trees],
                               rtol=1e-12)
    for t, (a, b) in enumerate(zip(jt, pt)):
        assert_tree_equal(a, b, f"{label} tree {t}")


def assert_tree_equal(a, b, msg):
    for k in ("split_feature", "threshold_bin", "left", "right",
              "threshold_value"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                      err_msg=f"{msg} {k}")
    np.testing.assert_allclose(b.value, a.value, rtol=TOL, atol=TOL,
                               err_msg=f"{msg} value")
