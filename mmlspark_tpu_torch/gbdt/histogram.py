"""Histogram builds and split finding — the GBDT hot loop on the device.

The counterpart of the JAX package's `gbdt/histogram.py`, in PyTorch on
the card.  A histogram build is a scatter-add (`index_add_`) of
`(g·w, h·w, w)` at `feature*B + bin`; the split search is one fused
function that scores every (feature, bin) threshold with cumulative sums
and returns the argmax and its left/right stats, so the host pulls 32
bytes a node.

The scatter-add accumulates in f64 and rounds to f32 once.  On CUDA
`index_add_` adds with atomics in no fixed order, and an f32 sum of a
bin that holds 500,000 rows drifts by hundreds of ulps with the order: a
1M-row root histogram on an H100 came 4.9e-4 of the node's mass off the
CPU's f32 sum, and two builds of it 1.88 apart in one bin.  In f64 the
order moves the sum by far less than one f32 ulp, so the card, the CPU
and two builds agree, and the sums stay within the JAX package's own
f32 rounding of its segment sum.

Data- and voting-parallel (`mesh` given): the SPMD counterpart of the
reference's `shard_map` + `psum`.  Every rank holds the same host rows
and keeps its zero-padded row block of the binned codes on its device;
a build is the local f64 scatter-add followed by one
`torch.distributed.all_reduce` (SUM, f64) over the mesh's data group,
rounded to f32 once — so the merged histogram is the single-device one
up to the order of f64 additions.  `build_local` all-gathers the ranks'
f32 histograms into the reference's [S, F, B, 3] for voting.

Gain math follows LightGBM: for a split of a node with stats (G, H),
  gain = S(G_l,H_l) + S(G_r,H_r) - S(G,H),
  S(g,h) = T(g)^2 / (h + lambda_l2),  T(g) = soft-threshold of g by lambda_l1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "build_histogram",
    "best_split",
    "SplitInfo",
    "HistogramBuilder",
]


class SplitInfo(NamedTuple):
    feature: int
    bin_threshold: int        # goes left if bin <= threshold
    gain: float
    left_grad: float
    left_hess: float
    left_count: float
    right_grad: float
    right_hess: float
    right_count: float


def build_histogram(binned, grad, hess, sample_weight, node_mask, num_bins):
    """[F, B, 3] histogram (grad, hess, count) of the rows where node_mask.

    binned: [N, F] uint8/int; grad/hess: [N] f32; sample_weight: [N] f32
    (bagging/goss weights, 0 = excluded); node_mask: [N] bool.
    """
    return histogram64(binned, grad, hess, sample_weight, node_mask,
                       num_bins).to(grad.dtype)


def histogram64(binned, grad, hess, sample_weight, node_mask, num_bins):
    """`build_histogram` before its one rounding: the f64 [F, B, 3] sums
    (what a data-parallel build reduces across ranks)."""
    n, f = binned.shape
    ids = binned.long() + torch.arange(
        f, dtype=torch.long, device=binned.device)[None, :] * num_bins
    stacked = weighted_stats(grad, hess, sample_weight, node_mask)  # [N, 3]
    vals = stacked[:, None, :].expand(n, f, 3).reshape(-1, 3)
    hist = torch.zeros(f * num_bins, 3, dtype=stacked.dtype,
                       device=grad.device)
    hist.index_add_(0, ids.reshape(-1), vals)
    return hist.view(f, num_bins, 3)


def weighted_stats(grad, hess, sample_weight, node_mask):
    """[N, 3] f64 rows (g·w, h·w, w) with w = sample_weight · node_mask
    (the product of two f32 values is exact in f64)."""
    w = (sample_weight * node_mask.to(sample_weight.dtype)).double()
    return torch.stack([grad.double() * w, hess.double() * w, w], dim=1)


def subtract_histogram(parent, child):
    """Sibling histogram via subtraction — LightGBM's classic trick that
    halves histogram work (build only the smaller child)."""
    return parent - child


def _soft_threshold(g, l1):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _split_scores(hist, lambda_l1, lambda_l2, min_data_in_leaf,
                  min_sum_hessian):
    """Per-(feature, bin-threshold) gain array [F, B]."""
    g = hist[:, :, 0]
    h = hist[:, :, 1]
    c = hist[:, :, 2]
    gl = torch.cumsum(g, dim=1)
    hl = torch.cumsum(h, dim=1)
    cl = torch.cumsum(c, dim=1)
    gt = gl[:, -1:]
    ht = hl[:, -1:]
    ct = cl[:, -1:]
    gr, hr, cr = gt - gl, ht - hl, ct - cl

    def leaf_score(gg, hh):
        t = _soft_threshold(gg, lambda_l1)
        return t * t / (hh + lambda_l2 + 1e-15)

    gain = leaf_score(gl, hl) + leaf_score(gr, hr) - leaf_score(gt, ht)
    valid = ((cl >= min_data_in_leaf) & (cr >= min_data_in_leaf)
             & (hl >= min_sum_hessian) & (hr >= min_sum_hessian))
    return torch.where(valid, gain, torch.full_like(gain, -torch.inf))


def _split_summary(hist, feature_mask, lambda_l1, lambda_l2,
                   min_data_in_leaf, min_sum_hessian):
    """One fused function per node: the argmax split (int32 flat index)
    and its gain and left/right stats as a [7] f32 vector."""
    scores = _split_scores(hist, lambda_l1, lambda_l2, min_data_in_leaf,
                           min_sum_hessian)
    masked = torch.where(feature_mask[:, None], scores,
                         torch.full_like(scores, -torch.inf))
    flat = masked.reshape(-1)
    idx = torch.argmax(flat)
    gain = flat[idx]
    b = hist.shape[1]
    feat = idx // b
    thr = idx % b
    # gather the winning feature FIRST, then scan one [B, 3] row — O(B),
    # not a second full [F, B, 3] cumsum (F can be a 2^18 hash space)
    cs = torch.cumsum(hist[feat], dim=0)
    left = cs[thr]
    right = cs[b - 1] - left
    # idx stays int32: float packing would corrupt splits once F*B > 2^24
    return idx.to(torch.int32), torch.cat([gain[None], left, right])


def best_split(
    hist: torch.Tensor,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: float,
    min_sum_hessian: float,
    min_gain: float,
    feature_mask: Optional[np.ndarray] = None,
) -> Optional[SplitInfo]:
    """Best (feature, bin) split of a node given its histogram, or None."""
    f, b, _ = hist.shape
    if feature_mask is None:
        feature_mask = np.ones(f, dtype=bool)
    idx, out = _split_summary(
        hist, torch.as_tensor(feature_mask, device=hist.device), lambda_l1,
        lambda_l2, min_data_in_leaf, min_sum_hessian)
    # one copy of 32 bytes: the int32 index rides in the f32 vector's bits
    packed = torch.cat([idx.reshape(1).view(torch.float32),
                        out.float()]).cpu().numpy()
    gain = float(packed[1])
    if not np.isfinite(gain) or gain <= min_gain:
        return None
    feat, thr = divmod(int(packed[:1].view(np.int32)[0]), b)
    return SplitInfo(
        feature=feat,
        bin_threshold=thr,
        gain=gain,
        left_grad=float(packed[2]),
        left_hess=float(packed[3]),
        left_count=float(packed[4]),
        right_grad=float(packed[5]),
        right_hess=float(packed[6]),
        right_count=float(packed[7]),
    )


class RowShardedBuilderBase:
    """Shared row-axis plumbing for the dense and sparse histogram
    builders: the rank's row block and the placement of the per-row
    gradient/hessian/weight/mask arrays on the builder's device.

    Without a mesh the block is every row.  With one, the rows pad with
    zeros to a multiple of the data degree and this rank keeps the
    contiguous block at its coordinate on the `axis` dimension — the
    reference's `P(axis)` row sharding, one block a rank."""

    mesh = None
    axis = "data"
    device = torch.device("cpu")
    _pad = 0
    _block = slice(None)

    def _shard_rows(self, n: int, mesh, axis: str, device) -> None:
        """Set the mesh, device, padding and this rank's row block."""
        self.mesh, self.axis, self.n = mesh, axis, n
        if mesh is None:
            self.device = resolve_device(device)
            self._pad, self._block, self.n_shards = 0, slice(None), 1
            return
        from ..parallel.mesh import as_device_mesh

        mesh = self.mesh = as_device_mesh(mesh)
        dev = resolve_device(device if device is not None
                             else mesh.device_type)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        dim = mesh.mesh_dim_names.index(axis)
        self.n_shards = mesh.size(dim)
        self.shard = mesh.get_local_rank(axis)
        self._pad = (-n) % self.n_shards
        self.rows_per_shard = (n + self._pad) // self.n_shards
        lo = self.shard * self.rows_per_shard
        self._block = slice(lo, lo + self.rows_per_shard)
        self._group = mesh.get_group(axis)

    def _pad_rows(self, arr, fill=0.0):
        if self._pad:
            pad_shape = (self._pad,) + arr.shape[1:]
            arr = np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])
        return arr

    def _local_rows(self, arr, fill=0.0):
        return np.ascontiguousarray(self._pad_rows(arr, fill)[self._block])

    def device_arrays(self, grad, hess, weight):
        """This rank's per-row arrays on the device, cast to f32 on the
        host first (as the JAX package does: its default x32 truncates the
        f64 numpy gradients, which `torch.as_tensor` would otherwise
        keep)."""
        return tuple(torch.as_tensor(self._local_rows(np.asarray(a, np.float32)),
                                     device=self.device)
                     for a in (grad, hess, weight))

    def node_mask(self, mask: np.ndarray):
        return torch.as_tensor(self._local_rows(np.asarray(mask, bool), False),
                               device=self.device)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the data group, in place (the reference's psum)."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group)
        return t

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[S, ...] of every rank's `t`, in rank order along the axis."""
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(parts, t.contiguous(), group=self._group)
        return torch.stack(parts)


class HistogramBuilder(RowShardedBuilderBase):
    """Owns the device-resident binned data and builds per-node
    histograms (`build_histogram` on `device`, which `resolve_device`
    resolves: the card unless 'cpu' is asked for).

    Data-parallel path (`mesh` given): rows are sharded over `axis`, one
    block a rank, and the ranks' f64 histograms are summed by an
    all-reduce over the axis's group — the collective standing in for
    LightGBM's TCP ring (reference lightgbm/LightGBMBase.scala:392-430).
    Voting-parallel (`voting=True`) additionally lets each shard vote its
    top-k features at the root from `build_local`
    (params/LightGBMParams.scala:17 `voting_parallel`)."""

    def __init__(self, binned: np.ndarray, num_bins: int, mesh=None,
                 axis: str = "data", voting: bool = False, top_k: int = 20,
                 device=None):
        self.num_bins = int(num_bins)
        self.voting = bool(voting)
        self.top_k = int(top_k)
        n, self.f = binned.shape
        self._shard_rows(n, mesh, axis, device)
        self.binned = torch.as_tensor(self._local_rows(binned, 0),
                                      device=self.device)

    def _local64(self, grad, hess, weight, mask):
        return histogram64(self.binned, grad, hess, weight, mask,
                           self.num_bins)

    def build(self, grad, hess, weight, mask):
        """grad/hess/weight/mask: device tensors from device_arrays/node_mask."""
        h = self._local64(grad, hess, weight, mask)
        if self.mesh is not None:
            h = self._all_reduce(h)
        return h.to(grad.dtype)

    def build_local(self, grad, hess, weight, mask):
        """Per-shard histograms stacked on a leading shard axis [S, F, B, 3]
        — the input to voting-parallel feature selection (every rank gets
        every shard's, in axis order)."""
        h = self._local64(grad, hess, weight, mask).to(grad.dtype)
        if self.mesh is None:
            return h[None]
        return self._all_gather(h)


def vote_features(
    local_hists: np.ndarray,
    lambda_l1: float,
    lambda_l2: float,
    min_data_in_leaf: float,
    min_sum_hessian: float,
    top_k: int,
) -> np.ndarray:
    """Voting-parallel feature pre-selection: each shard votes its top-k
    features by local best gain; returns the boolean union mask.  Only voted
    features' histograms then need the AllReduce — the comm-volume trade of
    LightGBM's `voting_parallel` tree learner."""
    s, f, b, _ = local_hists.shape
    mask = np.zeros(f, dtype=bool)
    for i in range(s):
        scores = _split_scores(
            torch.as_tensor(np.asarray(local_hists[i], np.float32)),
            lambda_l1, lambda_l2, min_data_in_leaf, min_sum_hessian).numpy()
        per_feature = scores.max(axis=1)
        k = min(top_k, f)
        top = np.argpartition(-per_feature, k - 1)[:k]
        mask[top[np.isfinite(per_feature[top])]] = True
    if not mask.any():
        mask[:] = True
    return mask
