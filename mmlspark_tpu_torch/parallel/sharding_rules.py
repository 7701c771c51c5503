"""Partition-rule library: regex-over-tree sharding in the fmengine /
EasyLM style.

Counterpart of the JAX package's `parallel/sharding_rules.py`, with its
tables copied row for row.  A *rule table* is an ordered sequence of
``(regex, PartitionSpec)`` pairs.  Every parameter leaf is named by its
``/``-joined tree path (``block0/qkv/kernel``); the FIRST rule whose
regex ``re.search``-matches that name wins, so specific rules go first
and a ``(".*", P())`` catch-all closes every table.  Scalars and size-1
leaves always replicate.

The paths are the JAX leaves' paths.  A port TransformerLM is named by
the flax paths `models.bundle.from_flax_variables` maps its parameters
from (`models.training.lm_params_tree` gives that tree, kernels in
flax's [in, out] layout), so one table shards the same leaves in both
packages.

`PartitionSpec` is this package's own spec type (a tuple of mesh axis
names or None per tensor dim, printed like the JAX one); `placements`
translates a spec into DTensor placements over a `DeviceMesh`: mesh dim
``name`` becomes ``Shard(i)`` where the spec names it at tensor dim i,
else ``Replicate()``.

``match_partition_rules(rules, tree)`` turns a table into a spec tree;
``make_shard_and_gather_fns(specs, mesh)`` turns a spec tree into
per-leaf placement/collection closures (a full tensor -> a DTensor
holding this rank's chunk; a DTensor -> the full host tensor);
``models.training.shard_params`` consumes a table or (legacy) a
``(path, arr) -> spec`` callable.

Axis-name hygiene: every axis literal in a spec must be an axis the mesh
declares (``parallel.mesh.MESH_AXIS_NAMES``); ``validate_rules``
enforces it at runtime, ``validate_coverage`` proves a table matches
every path of ``PARAM_PATH_MANIFEST``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["PartitionSpec", "P", "path_names", "path_name",
           "tree_map_with_path", "tree_leaves_with_path",
           "match_partition_rules", "spec_for", "placements",
           "local_chunk", "distribute", "make_shard_and_gather_fns", "validate_rules",
           "validate_coverage", "PARAM_PATH_MANIFEST",
           "lm_tensor_rules", "moe_expert_rules", "head_only_rules",
           "lm_3d_rules", "lm_tensor_parallel_rules",
           "moe_expert_parallel_rules", "head_rules"]


class PartitionSpec(tuple):
    """Per tensor dim: the mesh axis name (or a tuple of names, or None)
    that dim is split over.  `P()` replicates.  Equal to a tuple of the
    same entries, so it compares with the JAX package's spec."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"

    __str__ = __repr__


P = PartitionSpec

RuleTable = Sequence[Tuple[str, PartitionSpec]]

# Representative parameter leaf paths, one per distinct naming shape the
# models emit — the JAX package's coverage manifest, copied: the flax
# ``block{i}`` tree and the stacked 3D layout of
# ``models.training.lm_params_to_3d``.
PARAM_PATH_MANIFEST: Tuple[str, ...] = (
    # flax block{i} layout (TransformerLM / TransformerDecode)
    "tok_embed/embedding",
    "pos_embed/embedding",
    "block0/ln1/scale",
    "block0/ln1/bias",
    "block0/qkv/kernel",
    "block0/q/kernel",
    "block0/kv/kernel",
    "block0/proj/kernel",
    "block0/ln2/scale",
    "block0/mlp_in/kernel",
    "block0/mlp_in/bias",
    "block0/mlp_out/kernel",
    "block0/moe/router/kernel",
    "block0/moe/w_in",
    "block0/moe/w_out",
    "ln_f/scale",
    "head/kernel",
    # stacked 3D layout (models.training.lm_params_to_3d)
    "embed/tok_embed/embedding",
    "embed/pos_embed/embedding",
    "blocks/ln1/scale",
    "blocks/qkv/kernel",
    "blocks/q/kernel",
    "blocks/kv/kernel",
    "blocks/proj/kernel",
    "blocks/mlp_in/kernel",
    "blocks/mlp_out/kernel",
    "blocks/moe/router/kernel",
    "blocks/moe/w_in",
    "blocks/moe/w_out",
    "out/ln_f/scale",
    "out/head/kernel",
)


# ---------------------------------------------------------------- trees
# A tree is nested dicts (and lists/tuples) whose leaves are anything
# else; a path is the tuple of keys down to a leaf.

def tree_leaves_with_path(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in key order (dicts sorted, as jax flattens them)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_leaves_with_path(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree, *rest, prefix=()):
    """`fn(path, leaf, *rest_leaves)` over the leaves of `tree` (and the
    same-structured `rest`), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      prefix=prefix + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               prefix=prefix + (i,))
            for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def path_names(path) -> List[str]:
    """Tree path entries -> their string names (a key's `.key`,
    `.name` or `.idx` when it has one, else the key itself)."""
    out = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
        else:
            out.append(str(p))
    return out


def path_name(path) -> str:
    """The ``/``-joined leaf name rule regexes match against."""
    return "/".join(path_names(path))


def _leaf_shape(leaf):
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else ()


def spec_for(rules: RuleTable, name: str, leaf=None) -> PartitionSpec:
    """First-match-wins lookup of one leaf's PartitionSpec.  Scalar /
    size-1 leaves replicate unconditionally; a leaf no rule matches
    raises (close tables with ``(".*", P())`` when replication IS the
    intent)."""
    if leaf is not None:
        shape = _leaf_shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            return P()
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    raise ValueError(
        f"no partition rule matched leaf {name!r} — add a rule (or a "
        f'catch-all (".*", P()) row) to the table')


def match_partition_rules(rules: RuleTable, tree):
    """Spec tree for `tree`: each leaf gets the first rule whose regex
    matches its ``/``-joined path name (scalars replicate)."""
    return tree_map_with_path(
        lambda path, leaf: spec_for(rules, path_name(path), leaf), tree)


# ------------------------------------------------------ DTensor placement

def _dtensor():
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:  # torch < 2.5 keeps it private
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of `spec` over a `DeviceMesh` with named dims:
    per mesh dim, ``Shard(i)`` for the tensor dim i the spec puts it on,
    else ``Replicate()``."""
    _, Replicate, Shard = _dtensor()
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for i, entry in enumerate(tuple(spec)):
        for axis in (entry if isinstance(entry, (tuple, list))
                     else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}, not one "
                                 f"of the mesh's {names}")
            out[names.index(axis)] = Shard(i)
    return out


def local_chunk(full, mesh, spec: PartitionSpec):
    """This rank's chunk of the full tensor `full` under `spec` (each
    split dim divided evenly over its mesh axis; raises otherwise)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    names = mesh.mesh_dim_names
    out = full
    for i, entry in enumerate(tuple(spec)):
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        axes = [a for a in axes if a is not None]
        if not axes:
            continue
        n = 1
        idx = 0
        for a in axes:  # major-to-minor, as the mesh order
            k = names.index(a)
            idx = idx * mesh.size(k) + coord[k]
            n *= mesh.size(k)
        if out.shape[i] % n:
            raise ValueError(f"dim {i} of size {out.shape[i]} does not split "
                             f"evenly over {axes} ({n} ways)")
        step = out.shape[i] // n
        out = out.narrow(i, idx * step, step)
    return out


def distribute(full, mesh, spec: PartitionSpec):
    """A DTensor over `mesh` under `spec` from the full tensor `full`,
    which every rank holds (the host copy, as the JAX package's
    `device_put` takes it): each rank keeps its own chunk, no
    communication."""
    DTensor, _, _ = _dtensor()
    local = local_chunk(full, mesh, spec).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=tuple(full.shape),
                              stride=tuple(full.contiguous().stride()))


def make_shard_and_gather_fns(partition_specs, mesh):
    """(shard_fns, gather_fns) trees matching `partition_specs`:
    shard_fn places a full host leaf onto the mesh under its spec (a
    DTensor on the mesh's device); gather_fn pulls a (possibly sharded)
    leaf back to a full host (CPU) tensor — the save/restore side of the
    same rule table.  The gather is a collective over the mesh."""
    import torch

    dev = torch.device(mesh.device_type)

    def mk_shard(spec):
        return lambda x: distribute(torch.as_tensor(x).to(dev), mesh, spec)

    def mk_gather(_spec):
        def gather(x):
            full = x.full_tensor() if hasattr(x, "full_tensor") else x
            return torch.as_tensor(full).detach().cpu()
        return gather

    shard_fns = tree_map_with_path(lambda _p, s: mk_shard(s),
                                   partition_specs)
    gather_fns = tree_map_with_path(lambda _p, s: mk_gather(s),
                                    partition_specs)
    return shard_fns, gather_fns


def validate_rules(rules: RuleTable, axes: Iterable[str]) -> None:
    """Every axis name any rule's spec mentions must be a declared mesh
    axis (a typo'd axis would silently replicate the leaf)."""
    axes = set(axes)
    for pattern, spec in rules:
        for entry in tuple(spec):
            names = entry if isinstance(entry, (tuple, list)) else (entry,)
            for n in names:
                if n is not None and n not in axes:
                    raise ValueError(
                        f"rule {pattern!r} uses axis {n!r} not in the "
                        f"mesh axes {sorted(axes)} — a typo here would "
                        f"silently replicate the leaf")


def validate_coverage(rules: RuleTable,
                      paths: Iterable[str] = PARAM_PATH_MANIFEST) -> None:
    """Every manifest path must match some rule; raises on the first
    uncovered path, naming it."""
    for name in paths:
        spec_for(rules, name)  # raises ValueError on no match


# ------------------------------------------------------------ rule tables

def lm_tensor_rules(axis: str = "model") -> RuleTable:
    """TransformerLM block/head kernels over the tensor axis: qkv/mlp_in/
    head shard output features, proj/mlp_out shard input features (the
    megatron pairing — one all-reduce per block, none inside the MLP).
    'qkv' is the fused MHA projection; GQA splits it into 'q' + 'kv'."""
    return (
        (r"(^|/)(qkv|q|kv|mlp_in|head)/kernel$", P(None, axis)),
        (r"(^|/)(proj|mlp_out)/kernel$", P(axis, None)),
        (r".*", P()),
    )


def moe_expert_rules(axis: str = "model") -> RuleTable:
    """Shard the EXPERT dim of switch-MoE w_in/w_out (expert parallelism);
    everything else replicates."""
    return (
        (r"(^|/)moe/(w_in|w_out)$", P(axis, None, None)),
        (r".*", P()),
    )


def head_only_rules(axis: str = "model") -> RuleTable:
    """Classifier-head-only sharding (the CNN fine-tune shape: one big
    dense head, convs replicated)."""
    return (
        (r"(^|/)head/kernel$", P(None, axis)),
        (r".*", P()),
    )


def lm_3d_rules(tensor_axis: str = "model",
                pipe_axis: str = "pipe") -> RuleTable:
    """Rules for the STACKED 3D-trainer layout (``lm_params_to_3d``):
    block params carry leading [P_stages, K_blocks] dims sharded over the
    pipe axis, with the megatron tensor pairing on the trailing kernel
    dims; embed/ln replicate; head shards its vocab dim."""
    return (
        (r"^blocks/.*(qkv|q|kv|mlp_in)/kernel$",
         P(pipe_axis, None, None, tensor_axis)),
        (r"^blocks/.*(proj|mlp_out)/kernel$",
         P(pipe_axis, None, tensor_axis, None)),
        (r"^blocks/.*moe/(w_in|w_out)$",
         P(pipe_axis, None, tensor_axis, None, None)),
        # everything else under blocks/ (ln scale/bias, dense biases,
        # router) shards only its stage dim
        (r"^blocks/", P(pipe_axis)),
        (r"^out/head/kernel$", P(None, tensor_axis)),
        (r".*", P()),
    )


# ------------------------------------------ legacy callable adapters
# The pre-rule-library surface: (path, arr) -> spec callables, each a
# one-line lookup into its table.

def lm_tensor_parallel_rules(path, arr, axis: str = "model") -> PartitionSpec:
    return spec_for(lm_tensor_rules(axis), path_name(path), arr)


def moe_expert_parallel_rules(path, arr, axis: str = "model") -> PartitionSpec:
    return spec_for(moe_expert_rules(axis), path_name(path), arr)


def head_rules(path, arr, axis: str = "model") -> PartitionSpec:
    return spec_for(head_only_rules(axis), path_name(path), arr)
