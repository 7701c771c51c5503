"""The 3D-mesh LM trainer: data x tensor x pipe parallelism, SPMD.

The counterpart of the JAX package's `make_lm_train_step_3d` (its
`models/training.py`), which `models/training.py` re-exports.  The JAX
package writes one GSPMD program and lets XLA place the collectives; the
port runs one process per rank of a `MeshPlan` (parallel/mesh.py) and
places them itself, so the step computes the same function:

* **Layout.**  `lm_params_tree(module)` names a port TransformerLM's
  weights by the flax paths `models.bundle.from_flax_variables` maps
  them from, kernels in flax's [in, out] layout; `lm_params_to_3d`
  stacks the blocks [P_stages, K_blocks, ...] as the JAX package does;
  `shard_params(tree, plan, lm_3d_rules())` places every leaf as a
  DTensor by the JAX package's own rule table.  `init_lm_state_3d`
  keeps each rank's chunks as the f32 masters of a `TrainState3D`
  (optimizer over the chunks — SGD and Adam are elementwise — and a
  working copy at the compute dtype).
* **Data.**  tokens [A, M, mb, S] (every rank passes the same global
  batch): data rank d takes rows d*mb/D .. (d+1)*mb/D of every
  microbatch; gradients are summed over the data axis and divided by D
  (equal shares, so the mean of the local means is the global mean).
* **Tensor (megatron).**  Sharded by the table: qkv / q / kv / mlp_in
  split their output columns, proj / mlp_out their input rows, the head
  its vocabulary, MoE w_in / w_out their experts.  A block all-gathers
  its q/k/v projection, attends over this rank's heads (H/T of them),
  multiplies them by its proj rows and all-reduces the partial sum
  (`_ReduceFromTP`); the MLP runs its column block and all-reduces after
  mlp_out; an MoE layer runs its experts on the routed tokens and
  all-reduces.  The identity/all-reduce pair `_CopyToTP` keeps the
  gradients of the replicated activations whole, and a replicated
  parameter used by one rank's partial product (mlp_in's bias chunk, the
  router of an MoE layer) goes through it too, so every replicated
  parameter's gradient is whole on every rank.  The logits are
  all-gathered for the cross-entropy.
* **Pipe (GPipe).**  `parallel.pipeline.GPipe`: stage p runs its K
  blocks on microbatch t - p at tick t, activations hop to p+1 at the
  end of the tick, and the backward runs the ticks in reverse.  Stage 0
  embeds, the last stage takes ln_f, the head and the loss.  Leaves the
  pipe axis replicates (embed, ln_f, head) have their gradients summed
  over it.
* **Accumulation.**  A chunks run one after the other; gradients add up
  before ONE optimizer update with their mean.
* **Remat.**  Each block runs under `torch.utils.checkpoint` with the
  dots-saveable policy of the JAX package: matmul outputs are kept,
  everything else (GELU, LayerNorm, attention, the collectives)
  recomputes in the backward.
* **Metrics.**  `loss` (the mean next-token cross-entropy) and
  `grad_norm` (the global L2 norm: every sharded chunk counted once).

Attention inside the blocks is the model's own (`fused_attention`: B4
forward, B5/B6 backward on the card, the plain version on the CPU).  As
in the JAX package, MoE load-balance losses are not folded in here.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import telemetry as core_telemetry
from ..parallel.sharding_rules import (P, distribute,
                                       make_shard_and_gather_fns,
                                       match_partition_rules, path_name,
                                       spec_for, tree_leaves_with_path,
                                       tree_map_with_path)

__all__ = ["lm_params_tree", "load_lm_params", "lm_param_specs",
           "lm_params_to_3d", "lm_params_from_3d", "shard_params",
           "TrainState3D", "init_lm_state_3d", "gather_params",
           "make_lm_train_step_3d", "make_lm_resumable_step_3d"]

LN_EPS = 1e-6


# ------------------------------------------------------------ the layout

def _flax_paths(module: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """torch parameter name -> (flax path, stored transposed?), the
    inverse of `bundle.from_flax_variables` for a TransformerLM."""
    out: Dict[str, Tuple[str, bool]] = {}
    for mname, mod in module.named_modules():
        for pname, _p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            parts = mname.split(".") if mname else []
            if parts[:1] == ["blocks"]:
                parts = [f"block{parts[1]}"] + parts[2:]
            if isinstance(mod, nn.Embedding):
                leaf, tr = "embedding", False
            elif isinstance(mod, nn.LayerNorm):
                leaf, tr = ("scale" if pname == "weight" else "bias"), False
            elif isinstance(mod, nn.Linear):
                leaf, tr = ("kernel", True) if pname == "weight" else \
                    ("bias", False)
            elif pname in ("w_in", "w_out"):
                leaf, tr = pname, False
            else:
                raise KeyError(f"no flax path for parameter {name}")
            out[name] = ("/".join(parts + [leaf]), tr)
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def lm_params_tree(module: nn.Module) -> dict:
    """A port TransformerLM's parameters as the JAX package's flax tree
    (``{"tok_embed": {"embedding"}, "block0": {"qkv": {"kernel"}}, ...}``,
    kernels [in, out]); detached copies."""
    if getattr(module, "quant", False):
        raise ValueError("an int8 (quant=True) LM does not train")
    params = dict(module.named_parameters())
    return _nest({path: (params[name].detach().t() if tr else
                         params[name].detach()).clone()
                  for name, (path, tr) in _flax_paths(module).items()})


def load_lm_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax-layout tree (`lm_params_tree`'s shape) into `module`
    in place; returns it."""
    flat = {path_name(p): v for p, v in tree_leaves_with_path(tree)}
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, (path, tr) in _flax_paths(module).items():
            v = torch.as_tensor(flat[path])
            params[name].copy_(v.t() if tr else v)
    return module


def lm_param_specs(module: nn.Module, rules) -> Dict[str, P]:
    """torch parameter name -> the spec `rules` gives the flax leaf it is
    mapped from (shapes in the flax layout)."""
    params = dict(module.named_parameters())
    out = {}
    for name, (path, tr) in _flax_paths(module).items():
        p = params[name]
        leaf = p.t() if tr else p
        out[name] = spec_for(rules, path, leaf)
    return out


def lm_params_to_3d(params, num_layers: int, pipe: int):
    """Flax-layout LM tree -> the STACKED 3D-trainer layout:
    ``{"embed": {tok_embed[, pos_embed]}, "blocks": <stacked>, "out":
    {ln_f, head}}`` where every block leaf carries leading
    [P_stages, K_blocks] dims (stage p owns blocks p*K .. p*K+K-1).
    Shard with ``shard_params(p3, plan, lm_3d_rules())``."""
    if num_layers % pipe != 0:
        raise ValueError(f"num_layers={num_layers} not divisible by "
                         f"pipe={pipe}")
    k = num_layers // pipe
    blocks = [params[f"block{i}"] for i in range(num_layers)]
    stacked = tree_map_with_path(
        lambda _p, *xs: torch.stack([torch.as_tensor(x) for x in xs]),
        blocks[0], *blocks[1:])
    stacked = tree_map_with_path(
        lambda _p, a: a.reshape((pipe, k) + tuple(a.shape[1:])), stacked)
    embed = {n: params[n] for n in ("tok_embed", "pos_embed")
             if n in params}
    return {"embed": embed, "blocks": stacked,
            "out": {"ln_f": params["ln_f"], "head": params["head"]}}


def lm_params_from_3d(params3d, num_layers: int):
    """Inverse of :func:`lm_params_to_3d` (back to the flax ``block{i}``
    layout; `load_lm_params` puts it into a TransformerLM)."""
    flat = tree_map_with_path(
        lambda _p, a: a.reshape((num_layers,) + tuple(a.shape[2:])),
        params3d["blocks"])
    params = {f"block{i}": tree_map_with_path(lambda _p, a, i=i: a[i], flat)
              for i in range(num_layers)}
    params.update(params3d["embed"])
    params.update(params3d["out"])
    return params


def shard_params(tree, mesh, model_axis_rules=None):
    """Place a param tree on the mesh (a DeviceMesh or a MeshPlan): every
    leaf a DTensor holding this rank's chunk.  Default: replicate
    everything.  ``model_axis_rules`` is a partition-rule TABLE
    (parallel/sharding_rules.py) or, legacy surface, a
    ``(path, arr) -> PartitionSpec`` callable.  Every rank passes the
    same full tree (the host copy)."""
    from ..parallel.mesh import as_device_mesh

    mesh = as_device_mesh(mesh)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def put(spec, x):
        return distribute(torch.as_tensor(x).to(dev), mesh, spec)

    if model_axis_rules is None:
        return tree_map_with_path(lambda _p, x: put(P(), x), tree)
    if callable(model_axis_rules):
        return tree_map_with_path(
            lambda p, x: put(model_axis_rules(p, x) or P(), x), tree)
    specs = match_partition_rules(model_axis_rules, tree)
    shard_fns, _ = make_shard_and_gather_fns(specs, mesh)
    return tree_map_with_path(lambda _p, f, x: f(x), shard_fns, tree)


# --------------------------------------------------------- the 3D state

class _Tree(nn.Module):
    """A module whose parameters mirror a nested dict (keys as names)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))


class TrainState3D:
    """The 3D trainer's state: `module` (the f32 master chunks of this
    rank, a module mirroring the 3D tree: ``module.blocks.qkv.kernel``),
    its optimizer, the working copy at the compute dtype (`work`), the
    step count, the plan, and per leaf path its spec and global shape
    (`specs`, `shapes`).  `models.checkpoint.CheckpointManager` saves it
    as format 2 (one crc32 per shard) and restores it onto the current
    plan."""

    def __init__(self, module: nn.Module, optimizer, work: nn.Module,
                 plan, specs: Dict[str, P], shapes: Dict[str, tuple],
                 step: int = 0):
        self.module, self.optimizer, self.work = module, optimizer, work
        self.plan, self.specs, self.shapes = plan, specs, shapes
        self.step = step

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def leaf_paths(self):
        """(name in the module, "/"-path) of every parameter, in order."""
        return [(n, n.replace(".", "/"))
                for n, _ in self.module.named_parameters()]

    def dtensor(self, local: torch.Tensor, path: str):
        """`local`, this rank's chunk of leaf `path` (or of a tensor laid
        out like it), as a DTensor over the plan's mesh."""
        from ..parallel.sharding_rules import _dtensor, placements

        DTensor, _, _ = _dtensor()
        shape = self.shapes[path]
        return DTensor.from_local(
            local.detach(), self.plan.mesh,
            placements(self.specs[path], self.plan.mesh), run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())


def init_lm_state_3d(params3d, optimizer, plan,
                     compute_dtype="float32") -> TrainState3D:
    """A `TrainState3D` over a `shard_params` tree of DTensors: this
    rank's chunks become the f32 masters, `optimizer` (training.sgd /
    adam) is built over them, and the forward runs in `compute_dtype`."""
    from .training import _working_copy

    specs, shapes, local = {}, {}, {}
    for path, dt in tree_leaves_with_path(params3d):
        name = path_name(path)
        shapes[name] = tuple(dt.shape)
        specs[name] = _spec_of(dt, plan)
        local[name] = dt.to_local().detach().to(torch.float32).clone()
    module = _Tree(_nest(local))
    dtype = compute_dtype if isinstance(compute_dtype, torch.dtype) \
        else getattr(torch, str(compute_dtype))
    return TrainState3D(module, optimizer(list(module.parameters())),
                        _working_copy(module, dtype), plan, specs, shapes)


def _spec_of(dt, plan) -> P:
    """The PartitionSpec a DTensor's placements express over the plan."""
    names = plan.mesh.mesh_dim_names
    dims: Dict[int, list] = {}
    for axis, plc in zip(names, dt.placements):
        if plc.is_shard():
            dims.setdefault(plc.dim, []).append(axis)
    spec = []
    for i in range(dt.dim()):
        axes = dims.get(i, [])
        spec.append(None if not axes else
                    axes[0] if len(axes) == 1 else tuple(axes))
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


def gather_params(state: TrainState3D) -> dict:
    """The full 3D tree of the masters on the host (a collective over the
    plan's mesh: every rank calls it)."""
    return _nest({path: state.dtensor(p, path).full_tensor().cpu()
                  for (_n, path), p in zip(state.leaf_paths(),
                                           state.module.parameters())})


# ------------------------------------------------- tensor-parallel ops

class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward over the model axis; identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTP(torch.autograd.Function):
    """All-gather along the last dim over the model axis.  The gradient
    is this rank's chunk — summed over the axis first when the ranks used
    different parts of the gathered tensor (`partial_use`)."""

    @staticmethod
    def forward(ctx, x, group, t: int, n: int, partial_use: bool):
        import torch.distributed as dist

        ctx.group, ctx.t, ctx.n, ctx.partial = group, t, n, partial_use
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        if ctx.partial:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=-1)[ctx.t].contiguous(), None, None, None, \
            None


class _TP:
    """This rank's place on the model axis and the three ops over it
    (identities when the axis has one rank)."""

    def __init__(self, plan):
        self.n = plan.model
        self.t = plan.coords["model"]
        self.group = plan.group("model") if self.n > 1 else None

    def copy(self, x):
        return x if self.n == 1 else _CopyToTP.apply(x, self.group)

    def reduce(self, x):
        return x if self.n == 1 else _ReduceFromTP.apply(x, self.group)

    def gather(self, x, partial_use: bool):
        return x if self.n == 1 else _GatherTP.apply(
            x, self.group, self.t, self.n, partial_use)

    def chunk(self, x, dim: int = -1):
        return x if self.n == 1 else x.chunk(self.n, dim=dim)[self.t]


# -------------------------------------------------------------- the step

def _model_config(model) -> dict:
    b0 = model.blocks[0]
    return dict(h=model.num_heads, hkv=model.kv_heads,
                e=model.embed_dim, layers=model.num_layers,
                rope=model.pos_emb == "rope", attn=b0.attn_fn,
                moe=int(model.moe_experts), cf=float(model.moe_capacity))


def _block(cfg, tp: _TP, w, k: int, x: torch.Tensor) -> torch.Tensor:
    """Block k of this stage (w: the stage's leaves, [1, K, ...] chunks)
    on x [b, s, E]: the megatron split of `transformer._Block.forward`."""
    from .transformer import _gqa_expand, _rope

    b, s, e = x.shape
    h, hkv = cfg["h"], cfg["hkv"]
    d = e // h
    hl = h // tp.n
    y = F.layer_norm(x, (e,), w.ln1.scale[0, k], w.ln1.bias[0, k], LN_EPS)
    y = tp.copy(y)
    if hkv == h:
        qkv = tp.gather(y @ w.qkv.kernel[0, k], partial_use=True)
        q, kk, v = qkv.view(b, s, 3 * h, d).split(h, dim=2)
    else:
        q = tp.gather(y @ w.q.kernel[0, k], partial_use=True).view(b, s, h, d)
        kv = tp.gather(y @ w.kv.kernel[0, k], partial_use=True)
        kk, v = kv.view(b, s, 2 * hkv, d).split(hkv, dim=2)
    if cfg["rope"]:
        rp = torch.arange(s, device=x.device)
        q, kk = _rope(q, rp), _rope(kk, rp)
    heads = slice(tp.t * hl, (tp.t + 1) * hl)
    q = q[:, :, heads]
    kk = _gqa_expand(kk, h)[:, :, heads]
    v = _gqa_expand(v, h)[:, :, heads]
    a = cfg["attn"](q, kk, v).to(x.dtype).reshape(b, s, hl * d)
    x = x + tp.reduce(a @ w.proj.kernel[0, k])
    y = tp.copy(F.layer_norm(x, (e,), w.ln2.scale[0, k], w.ln2.bias[0, k],
                             LN_EPS))
    if cfg["moe"]:
        return x + tp.reduce(_moe(cfg, tp, w.moe, k, y))
    hmid = y @ w.mlp_in.kernel[0, k] + tp.chunk(tp.copy(w.mlp_in.bias[0, k]))
    out = F.gelu(hmid, approximate="tanh") @ w.mlp_out.kernel[0, k]
    return x + (tp.reduce(out) + w.mlp_out.bias[0, k])


def _moe(cfg, tp: _TP, w, k: int, x: torch.Tensor) -> torch.Tensor:
    """This rank's experts' share of a Switch MoE layer
    (`transformer._MoEMLP.forward`): every rank routes all tokens, runs
    its X/T experts, and the shares add up over the model axis."""
    b, s, e = x.shape
    nx = cfg["moe"]
    xl = nx // tp.n
    cap = max(1, int(cfg["cf"] * s / nx))
    wr = tp.copy(w.router.kernel[0, k]).float()
    br = tp.copy(w.router.bias[0, k]).float()
    probs = torch.softmax(x.float() @ wr + br, dim=-1)
    gate = probs.max(dim=-1).values
    expert = probs.argmax(dim=-1)
    onehot = F.one_hot(expert, nx)
    place = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
    rows = torch.arange(b, device=x.device)[:, None]
    trash = nx * b * cap
    addr = torch.where(place < cap, (expert * b + rows) * cap + place,
                       trash).reshape(-1)
    buf = x.new_zeros(trash + 1, e).index_copy(0, addr, x.reshape(-1, e))
    mine = buf[:trash].view(nx, b * cap, e)[tp.t * xl:(tp.t + 1) * xl]
    hid = F.gelu(torch.bmm(mine, w.w_in[0, k].to(x.dtype)), approximate="tanh")
    y_mine = torch.bmm(hid, w.w_out[0, k].to(x.dtype))
    parts = [y_mine.new_zeros(tp.t * xl, b * cap, e), y_mine,
             y_mine.new_zeros(nx - (tp.t + 1) * xl, b * cap, e)]
    y = torch.cat(parts).reshape(trash, e)
    y = torch.cat([y, y.new_zeros(1, e)])
    return y.index_select(0, addr).view(b, s, e) * gate.to(x.dtype)[..., None]


def _dots_saveable():
    """The JAX package's `jax.checkpoint_policies.dots_saveable` as a
    selective-checkpoint context: matmul outputs are saved, everything
    else is recomputed."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}

    def policy(_ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _flat_all_reduce(tensors, group, scale: Optional[float] = None) -> None:
    """Sum `tensors` over `group` in one flat buffer (then x scale)."""
    import torch.distributed as dist

    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def _axes_of(spec: P) -> set:
    out = set()
    for entry in tuple(spec):
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a is not None:
                out.add(a)
    return out


def _apply_gradients_3d(state: TrainState3D) -> torch.Tensor:
    """The optimizer step from the gradients the schedule left on the
    working copy: cast into the f32 masters, summed over the data axis
    (/ D) and, for leaves the pipe axis replicates, over the pipe axis;
    the global L2 norm (each chunk once); the masters stepped, the
    working copy refreshed."""
    import torch.distributed as dist

    plan = state.plan
    masters = dict(state.module.named_parameters())
    works = dict(state.work.named_parameters())
    for name, pm in masters.items():
        pw = works[name]
        pm.grad = (pw.grad.to(torch.float32) if pw.grad is not None
                   else torch.zeros_like(pm))
    if state.work is not state.module:
        state.work.zero_grad(set_to_none=True)
    grads = {n: p.grad for n, p in masters.items()}
    if plan.data > 1:
        _flat_all_reduce(list(grads.values()), plan.group("data"),
                         1.0 / plan.data)
    specs = {n: state.specs[n.replace(".", "/")] for n in grads}
    if plan.pipe > 1:
        _flat_all_reduce([g for n, g in grads.items()
                          if "pipe" not in _axes_of(specs[n])],
                         plan.group("pipe"))
    # global norm: a leaf replicated over the model / pipe axis is held
    # whole by every rank of it, so it counts 1/size there
    sq = torch.zeros((), dtype=torch.float32, device=state.device)
    for n, g in grads.items():
        axes = _axes_of(specs[n])
        wgt = 1.0
        if "model" not in axes:
            wgt /= plan.model
        if "pipe" not in axes:
            wgt /= plan.pipe
        sq = sq + g.float().square().sum() * wgt
    for axis, size in (("model", plan.model), ("pipe", plan.pipe)):
        if size > 1:
            dist.all_reduce(sq, group=plan.group(axis))
    norm = sq.sqrt()
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    if state.work is not state.module:
        with torch.no_grad():
            torch._foreach_copy_(list(state.work.parameters()),
                                 list(state.module.parameters()))
    state.step += 1
    return norm


def make_lm_train_step_3d(model, plan, remat: bool = True,
                          hang_budget_s: Optional[float] = None) -> Callable:
    """``step(state, tokens) -> (state, metrics)`` on a `MeshPlan`: data
    x megatron tensor x GPipe, one SPMD process a rank (see the module
    docstring).  `model` is the port TransformerLM whose configuration
    the state's weights follow (its own weights are not used); `state`
    an `init_lm_state_3d` state on `plan`.

    ``tokens [A, M, mb, S]`` integer: A gradient-accumulation chunks of M
    pipeline microbatches of mb sequences (mb split over 'data') — global
    batch A*M*mb, the same on every rank.  ``remat`` checkpoints each
    block with the dots-saveable policy.  Metrics are 0-dim tensors,
    `loss` and `grad_norm`.

    ``hang_budget_s`` bounds each step (collectives included) with
    `parallel.distributed.run_with_deadline`, turning a dead peer's
    wedged collective into a `CollectiveTimeout`; each guarded step is
    recorded on the goodput ledger."""
    from ..parallel.pipeline import GPipe

    cfg = _model_config(model)
    if cfg["layers"] % plan.pipe:
        raise ValueError(f"num_layers={cfg['layers']} not divisible "
                         f"by pipe={plan.pipe}")
    if cfg["h"] % plan.model or (cfg["moe"] and cfg["moe"] % plan.model):
        raise ValueError(f"heads={cfg['h']} (and experts={cfg['moe']}) must "
                         f"divide by model={plan.model}")
    tp = _TP(plan)
    coords = plan.coords
    d_rank, p_rank = coords["data"], coords["pipe"]
    k_blocks = cfg["layers"] // plan.pipe
    sac = _dots_saveable if remat else None

    def stage_fn(w, h):
        for k in range(k_blocks):
            if sac is not None:
                from torch.utils.checkpoint import checkpoint

                h = checkpoint(_block, cfg, tp, w, k, h, use_reentrant=False,
                               context_fn=sac)
            else:
                h = _block(cfg, tp, w, k, h)
        return h

    def embed(w, toks):
        x = F.embedding(toks, w.embed.tok_embed.embedding)
        if hasattr(w.embed, "pos_embed"):
            pos = torch.arange(toks.shape[-1], device=toks.device)
            x = x + F.embedding(pos, w.embed.pos_embed.embedding)[None]
        return x

    def head_loss(w, h, toks):
        h = F.layer_norm(h, (cfg["e"],), w.out.ln_f.scale, w.out.ln_f.bias,
                         LN_EPS)
        logits = tp.gather(tp.copy(h) @ w.out.head.kernel,
                           partial_use=False).float()
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                               toks[:, 1:].reshape(-1).long())

    def step(state: TrainState3D, tokens: torch.Tensor):
        import torch.distributed as dist

        a_chunks, m, mb, s = tokens.shape
        if mb % plan.data:
            raise ValueError(f"microbatch {mb} not divisible by data="
                             f"{plan.data}")
        rows = mb // plan.data
        toks = tokens[:, :, d_rank * rows:(d_rank + 1) * rows].to(
            state.device)
        work = state.work.train()
        dtype = next(work.parameters()).dtype
        loss_sum = torch.zeros((), dtype=torch.float32, device=state.device)
        scale = 1.0 / (m * a_chunks)
        for a in range(a_chunks):
            pipe = GPipe(plan.pipe, p_rank, m,
                         plan.group("pipe") if plan.pipe > 1 else None,
                         (rows, s, cfg["e"]), dtype, state.device)
            losses: Dict[int, torch.Tensor] = {}

            def sink(mi, h, a=a):
                losses[mi] = head_loss(work, h, toks[a, mi]) * scale
                return losses[mi]

            pipe.forward(lambda h: stage_fn(work.blocks, h),
                         lambda mi, a=a: embed(work, toks[a, mi]), sink,
                         grad=True)
            pipe.backward({mi: None for mi in losses})
            for v in losses.values():
                loss_sum = loss_sum + v.detach()
        norm = _apply_gradients_3d(state)
        if plan.data > 1:
            dist.all_reduce(loss_sum, group=plan.group("data"))
            loss_sum = loss_sum / plan.data
        if plan.pipe > 1:
            if p_rank != plan.pipe - 1:
                loss_sum = torch.zeros_like(loss_sum)
            dist.all_reduce(loss_sum, group=plan.group("pipe"))
        return state, {"loss": loss_sum, "grad_norm": norm}

    watched = core_telemetry.watch_compiles(
        step, name="training.lm_train_step_3d")
    if hang_budget_s is None:
        return watched

    from ..parallel.distributed import run_with_deadline
    seq = itertools.count()

    def guarded_step(state, tokens):
        # the guarded path waits for the step's device work, so its wall
        # IS the step's compute — record it on the goodput ledger
        t0 = time.perf_counter()

        def run():
            st, m = watched(state, tokens)
            return st, {k: v.detach() for k, v in m.items()}, \
                float(m["loss"])

        st, metrics, _ = run_with_deadline(run, hang_budget_s,
                                           name="lm_train_step_3d")
        core_telemetry.LEDGER.record_step(
            next(seq), compute_s=time.perf_counter() - t0)
        return st, metrics

    return guarded_step


def make_lm_resumable_step_3d(model, plan, microbatches: int,
                              grad_accum: int = 1,
                              remat: bool = True) -> Callable:
    """Adapter threading the 3D step through `fit_epochs_resumable`
    (``(state, tokens [B, S], labels-ignored)`` signature): the flat batch
    reshapes to the step's [A, M, mb, S] accumulation layout.  B must
    equal A*M*mb for some mb."""
    inner = make_lm_train_step_3d(model, plan, remat=remat)

    def step(state: TrainState3D, tokens, _labels):
        b = tokens.shape[0]
        if b % (grad_accum * microbatches) != 0:
            raise ValueError(
                f"batch {b} not divisible by grad_accum*microbatches="
                f"{grad_accum * microbatches}")
        toks = tokens.reshape(grad_accum, microbatches,
                              b // (grad_accum * microbatches),
                              tokens.shape[-1])
        return inner(state, toks)

    return step
