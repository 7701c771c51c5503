"""Pipeline parallelism: the GPipe schedule over point-to-point hops.

Counterpart of the JAX package's `parallel/pipeline.py`.  P pipeline
stages hold their own slice of a stacked parameter tree (leading dim P),
microbatches stream through the stage chain with activations hopping
stage to stage — the classic bubble schedule (M + P - 1 ticks for M
microbatches; bubble fraction (P-1)/(M+P-1)).

The JAX package writes the schedule as one `lax.scan` whose hop is a
collective XLA places (`ppermute` / a roll of a pipe-sharded buffer).
The port is SPMD: each rank of the pipe axis is one stage, runs the
ticks in which it holds a microbatch (stage p holds microbatch t - p at
tick t), and the hop is a `batch_isend_irecv` pair over the axis's
process group at the end of every tick — each rank knows statically
which of its neighbours send and receive, so every send meets its
receive in the same tick.  `GPipe.backward` runs the ticks in reverse:
stage p back-propagates microbatch m one tick after stage p+1 did and
sends its input gradient to stage p-1, so one schedule serves the
forward and the explicit backward the 3D trainer drives
(models.training.make_lm_train_step_3d).

`pipeline_apply` / `gpipe_spmd_apply` run the schedule and hand every
rank of the axis the [M, mb, ...] outputs (broadcast from the last
stage); they are differentiable (`_GPipeApply`: its backward is the
reverse schedule).  Without a mesh `gpipe_spmd_apply` runs all P stages
on this rank, tick by tick — the single-device schedule.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .mesh import as_device_mesh
from .sharding_rules import tree_leaves_with_path, tree_map_with_path

__all__ = ["pipeline_apply", "gpipe_spmd_apply", "stack_stage_params",
           "GPipe"]


def stack_stage_params(per_stage_params):
    """[tree per stage] -> one tree with leading dim P (stage axis) — the
    layout `pipeline_apply` splits over the pipe axis."""
    first = per_stage_params[0]
    return tree_map_with_path(
        lambda _p, *xs: torch.stack([torch.as_tensor(x) for x in xs]),
        first, *per_stage_params[1:])


def _index_tree(tree, i: int):
    return tree_map_with_path(lambda _p, a: a[i], tree)


def _leading(stacked) -> set:
    return {int(a.shape[0]) for _p, a in tree_leaves_with_path(stacked)}


class GPipe:
    """One stage's side of the GPipe schedule over `n_stages` stages and
    `m` microbatches.  `stage` is this rank's index on the pipe axis;
    `group` its process group (None when n_stages == 1); activations are
    `act_shape` / `act_dtype` tensors on `device`.

    `forward(stage_fn, feed, sink, grad=False)`: stage 0 takes
    `feed(mi)` for microbatch mi, every stage applies `stage_fn`, the
    last stage hands each output to `sink(mi, out)`.  With `grad=True`
    the inputs stage p > 0 receives are leaves that require grad, and
    the per-microbatch graphs are kept for `backward(out_grads)`, which
    back-propagates them in reverse tick order: the last stage starts
    from `out_grads[mi]`, the gradient of its output — or, when `sink`
    returned a tensor (a 0-dim loss) and the grad is None, from that —
    and every stage sends its input gradient up the chain.  Returns stage 0's input gradients (stage 0 only)."""

    def __init__(self, n_stages: int, stage: int, m: int, group=None,
                 act_shape=None, act_dtype=None, device=None):
        import torch.distributed as dist

        self.n, self.p, self.m = int(n_stages), int(stage), int(m)
        self.group = group
        self.act_shape, self.act_dtype, self.device = act_shape, act_dtype, device
        self.prev = self.next = None
        if self.n > 1:
            if self.p > 0:
                self.prev = dist.get_global_rank(group, self.p - 1)
            if self.p < self.n - 1:
                self.next = dist.get_global_rank(group, self.p + 1)
        self._inp: Dict[int, torch.Tensor] = {}
        self._out: Dict[int, torch.Tensor] = {}

    @property
    def ticks(self) -> int:
        return self.m + self.n - 1

    def _active(self, stage: int, t: int) -> bool:
        return 0 <= t - stage < self.m and 0 <= stage < self.n

    def _hop(self, send: Optional[torch.Tensor], send_to, recv: bool,
             recv_from) -> Optional[torch.Tensor]:
        """One end-of-tick exchange: returns the received tensor."""
        import torch.distributed as dist

        ops: List = []
        buf = None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to,
                                  self.group))
        if recv:
            buf = torch.empty(self.act_shape, dtype=self.act_dtype,
                              device=self.device)
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return buf

    def forward(self, stage_fn: Callable, feed: Callable,
                sink: Optional[Callable] = None, grad: bool = False):
        received: Dict[int, torch.Tensor] = {}
        p = self.p
        for t in range(self.ticks):
            mi = t - p
            out = None
            if self._active(p, t):
                if p == 0:
                    inp = feed(mi)
                else:
                    inp = received.pop(mi)
                    if grad:
                        inp.requires_grad_()
                out = stage_fn(inp)
                tail = None
                if p == self.n - 1 and sink is not None:
                    tail = sink(mi, out)
                if grad:
                    # a sink that returns a tensor (a loss) is where the
                    # last stage's backward starts
                    self._inp[mi] = inp
                    self._out[mi] = out if tail is None else tail
            if self.n > 1:
                send = out.detach() if (out is not None and
                                        p < self.n - 1) else None
                want = p > 0 and self._active(p - 1, t)
                buf = self._hop(send, self.next, want, self.prev)
                if want:
                    received[t - (p - 1)] = buf

    def backward(self, out_grads) -> Dict[int, torch.Tensor]:
        p = self.p
        received: Dict[int, torch.Tensor] = {}
        in_grads: Dict[int, torch.Tensor] = {}
        for t in reversed(range(self.ticks)):
            mi = t - p
            g_in = None
            if self._active(p, t):
                out, inp = self._out.pop(mi), self._inp.pop(mi)
                g = out_grads[mi] if p == self.n - 1 else received.pop(mi)
                if g is None:
                    torch.autograd.backward(out)
                else:
                    torch.autograd.backward(out, g)
                if inp.requires_grad and inp.is_leaf:
                    g_in = inp.grad if inp.grad is not None else \
                        torch.zeros_like(inp)
                    in_grads[mi] = g_in
            if self.n > 1:
                send = g_in if p > 0 else None
                want = p < self.n - 1 and self._active(p + 1, t)
                buf = self._hop(send, self.prev, want, self.next)
                if want:
                    received[t - (p + 1)] = buf
        return in_grads if p == 0 else {}


class _GPipeApply(torch.autograd.Function):
    """[M, mb, ...] -> [M, mb, ...] through the schedule; the output is
    the last stage's, broadcast to the axis.  The backward sums the
    output gradients over the axis (every rank may have used the
    replicated output), runs the reverse schedule, and returns stage 0's
    input gradients (zeros elsewhere); stage parameters get their
    gradients accumulated by the inner backward."""

    @staticmethod
    def forward(ctx, x, stage_fn, pipe: GPipe, *params):
        import torch.distributed as dist

        outs: Dict[int, torch.Tensor] = {}
        with torch.enable_grad():
            pipe.forward(stage_fn,
                         lambda mi: x[mi].detach().requires_grad_(),
                         lambda mi, o: outs.__setitem__(mi, o), grad=True)
        if pipe.p == pipe.n - 1:
            ys = torch.stack([outs[i].detach() for i in range(pipe.m)])
        else:
            ys = torch.empty((pipe.m,) + tuple(pipe.act_shape),
                             dtype=pipe.act_dtype, device=pipe.device)
        if pipe.n > 1:
            dist.broadcast(ys, dist.get_global_rank(pipe.group, pipe.n - 1),
                           group=pipe.group)
        ctx.pipe, ctx.x_shape = pipe, x.shape
        ctx.n_params = len(params)
        return ys

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        pipe = ctx.pipe
        g = g.contiguous()
        if pipe.n > 1:
            dist.all_reduce(g, group=pipe.group)
        grads = pipe.backward({i: g[i] for i in range(pipe.m)}) \
            if pipe.p == pipe.n - 1 else pipe.backward({})
        gx = torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device)
        for i, gi in grads.items():
            gx[i] = gi
        return (gx, None, None) + (None,) * ctx.n_params


def _run(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh,
         axis: str) -> torch.Tensor:
    names = mesh.mesh_dim_names
    n_stages = mesh.size(names.index(axis))
    stage = mesh.get_local_rank(axis)
    local = _index_tree(stacked_params, stage)
    pipe = GPipe(n_stages, stage, x.shape[0], mesh.get_group(axis),
                 tuple(x.shape[1:]), x.dtype, x.device)
    params = [a for _p, a in tree_leaves_with_path(local)
              if torch.is_tensor(a) and a.requires_grad]
    return _GPipeApply.apply(x, lambda h: stage_fn(local, h), pipe, *params)


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, axis: str = "model") -> torch.Tensor:
    """Run `x [M, mb, ...]` microbatches through P chained stages.

    stage_fn(params_i, x) -> same-shaped activation; `stacked_params` has
    leading dim P == the size of `axis`, and stage i's weights are used
    on the rank at index i of the axis.  Returns [M, mb, ...] outputs on
    every rank of the axis, equal to applying the P stages sequentially
    to each microbatch."""
    mesh = as_device_mesh(mesh)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    leading = _leading(stacked_params)
    if leading != {n_stages}:
        raise ValueError(
            f"stacked_params leading dim(s) {sorted(leading)} must equal "
            f"mesh axis {axis!r} size {n_stages} — one stage per pipe "
            "rank (a clean multiple would silently run every k-th stage)")
    return _run(stage_fn, stacked_params, x, mesh, axis)


def gpipe_spmd_apply(stage_fn: Callable, stacked_params, x: torch.Tensor,
                     mesh=None, axis: str = "pipe",
                     batch_axis: str = "data") -> torch.Tensor:
    """The SAME M + P - 1 GPipe schedule as :func:`pipeline_apply`, with
    the JAX package's 3D-mesh defaults (`axis` "pipe"; `batch_axis` names
    the data axis the microbatch rows are split over — the caller passes
    this rank's rows, so nothing here uses it).

    ``x [M, mb, ...]`` microbatches; ``stacked_params`` leaves carry a
    leading stage dim P (further leading dims — the [P, K_blocks] layout
    of ``lm_params_to_3d`` — are stage-private).  With a mesh the stages
    run one a rank of `axis`; without one (or with an axis of size 1 and
    P > 1) every stage runs here, tick by tick.  Differentiable; returns
    [M, mb, ...] equal to applying the stages sequentially."""
    del batch_axis
    leading = _leading(stacked_params)
    if len(leading) != 1:
        raise ValueError(
            f"stacked_params leading dims differ: {sorted(leading)}")
    (p,) = leading
    mesh = as_device_mesh(mesh) if mesh is not None else None
    if mesh is not None and axis in mesh.mesh_dim_names:
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if size != p:
            raise ValueError(
                f"stacked_params leading dim {p} != mesh axis {axis!r} size "
                f"{size} — one stage per pipe rank")
        if size > 1:
            return _run(stage_fn, stacked_params, x, mesh, axis)
    # every stage on this rank: the schedule's ticks run the active
    # stages in order, which is each microbatch through stages 0..P-1
    stages = [_index_tree(stacked_params, i) for i in range(p)]
    ys = []
    for mi in range(x.shape[0]):
        h = x[mi]
        for sp in stages:
            h = stage_fn(sp, h)
        ys.append(h)
    return torch.stack(ys)
