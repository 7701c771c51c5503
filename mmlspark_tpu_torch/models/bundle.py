"""TorchBundle: a serializable (architecture + weights) unit, and the
weight bridge from the JAX package's flax variables.

Counterpart of the JAX package's `models/bundle.py`: a model is a
registered builder name + kwargs (reconstructable code) plus a state
dict of numpy arrays (picklable), with named outputs ("taps") for
CNTK-style node addressing (CNTKModel.scala:229-371).  `dtype` is the
compute dtype the module runs in (the flax modules' `dtype` field).

`from_flax_variables` turns a flax ResNet's ``{'params', 'batch_stats'}``
or a flax ViT's / TransformerLM's / convnet's ``{'params'}`` numpy tree into a
TorchBundle: conv kernels HWIO -> OIHW, Dense kernels [in, out] ->
Linear weights [out, in], BatchNorm scale/bias from `params` and
mean/var from `batch_stats`, LayerNorm scale/bias -> weight/bias, Embed
`embedding` -> Embedding weight, the ViT's `pos_embed` param as it is,
ResNet block `<Block>_i` and transformer `block{i}` -> `blocks.i`, the
convnets' layers (`conv1`, `conv2_1`, `conv1a`, `fc1`, `head`) by their
own names, `fc1` as it is (models/convnets.py flattens in flax's order); an
MoE block's `moe/router` Dense as any Dense and its `moe/w_in` /
`moe/w_out` expert kernels as they are.  Every leaf on either side must
be used exactly once.

`TorchBundle.from_module` takes a trained module's weights (what
`DeepVisionClassifier.fit` hands to its `DeepVisionModel`).
`init_state_dict` draws a module's initial weights from a seed;
`DirectInit` puts the same bits straight onto a device (the fit's
initial weights), from one walk of the rules both follow.

A bundle's taps (`layer_names`) and its input dtype (`input_dtype`:
int32 token ids for the LM, float32 otherwise) come from its module, as
the JAX package's FlaxBundle takes them.

On disk a bundle is what `pickle` makes of it — the JAX package's
pickle catch-all for complex params (core/serialize.py): a TorchBundle
holds only plain attributes, `builder` (a registered name),
`builder_kwargs`, `state_dict` (numpy arrays: f32 weights, int64
BatchNorm counters, and after `prequantize` the int8 `wq` / f32 `ws` of
each int8 layer), `input_shape`, `layer_names`, `input_dtype`, `dtype`
(the compute dtype's name) and `bundle_id`.  No torch object is
pickled, so a bundle saved on one machine loads on any other that has
this package.

`FunctionBundle` is the escape hatch for an arbitrary model: a
picklable `fn(variables, batch)` over a dict of tensors, whose variables
are kept as numpy and moved to the stage's device.

`prequantize(bundle)` returns a NEW TorchBundle (a new `bundle_id`, so
no executor cache confuses the two) whose int8 layers carry their int8
weights; `from_flax_variables` takes the JAX package's 'quant'
collection the same way.
"""
from __future__ import annotations

import inspect
import re
import uuid
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from ..ops.quant import QuantLinear
from . import resnet as R
from . import transformer as T
from . import vit as V
from . import convnets as C
from . import lfm2 as L
from . import moe as M

__all__ = ["TorchBundle", "FunctionBundle", "register_builder",
           "get_builder", "from_flax_variables", "init_state_dict",
           "DirectInit", "prequantize"]

_BUILDERS: Dict[str, Callable[..., nn.Module]] = {}


def register_builder(name: str, factory: Callable[..., nn.Module]):
    _BUILDERS[name] = factory
    return factory


def get_builder(name: str) -> Callable[..., nn.Module]:
    try:
        return _BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown model builder {name!r}; registered: "
                         f"{sorted(_BUILDERS)}") from None


for _name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152"):
    register_builder(_name, getattr(R, _name))
register_builder("transformer_lm", T.transformer_lm)
register_builder("lfm2_moe", L.lfm2_moe)
for _name in ("vit_tiny", "vit_small", "vit_base"):
    register_builder(_name, getattr(V, _name))
for _name in ("alexnet", "vgg11", "vgg16", "convnet_cifar"):
    register_builder(_name, getattr(C, _name))


def _builder_kwargs(builder: str, kwargs: Optional[dict],
                    input_shape: Optional[Sequence[int]]) -> dict:
    """The builder's kwargs; a builder that takes an `image_size` (the
    ViTs, whose position table depends on it) gets the input shape's
    when none is given."""
    kwargs = dict(kwargs or {})
    if (input_shape and "image_size" not in kwargs and "image_size" in
            inspect.signature(get_builder(builder)).parameters):
        kwargs["image_size"] = tuple(int(s) for s in input_shape[:2])
    return kwargs


# A leaf's rule: (kind, arg).  "normal_div": N(0, 1) / arg; "normal_mul":
# arg * N(0, 1); "uniform_add": arg + U(0, 1); "const": arg.
_Walk = List[Tuple[torch.Tensor, str, float]]


def _init_walk(module: nn.Module, random_bn: bool = False) -> _Walk:
    """(leaf, kind, arg) for every tensor `init_state_dict` writes, in the
    order it draws them from its generator: `module.modules()`, then the
    ViT's position table.  A tensor two modules share (a tied LM head) is
    drawn once, where the walk first meets it.  The one statement of the
    init's rules, which both `init_state_dict` and `DirectInit` follow."""
    zero_scaled = set()
    if isinstance(module, R.ResNet) and not random_bn:
        for block in module.blocks:
            n_branch = len(block.bns) - int(block.has_proj)
            zero_scaled.add(block.bns[n_branch - 1])
    walk: _Walk = []
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            walk.append((m.weight, "normal_div", m.weight[0].numel() ** 0.5))
            if m.bias is not None:
                walk.append((m.bias, "const", 0.0))
            if isinstance(m, M.Router):
                walk.append((m.expert_bias, "normal_mul", 0.01))
        elif isinstance(m, nn.BatchNorm2d):
            rules = ((m.weight, "uniform_add", 0.5),
                     (m.running_var, "uniform_add", 0.5),
                     (m.bias, "normal_mul", 0.1),
                     (m.running_mean, "normal_mul", 0.1)) if random_bn else (
                (m.weight, "const", 0.0 if m in zero_scaled else 1.0),
                (m.bias, "const", 0.0), (m.running_mean, "const", 0.0),
                (m.running_var, "const", 1.0))
            walk += [r for r in rules + ((m.num_batches_tracked, "const", 0),)
                     if r[0] is not None]
        elif isinstance(m, nn.LayerNorm):
            walk += [(t, "const", v) for t, v in ((m.weight, 1.0),
                                                  (m.bias, 0.0))
                     if t is not None]
        elif isinstance(m, nn.RMSNorm) and m.weight is not None:
            walk.append((m.weight, "const", 1.0))
        elif isinstance(m, nn.Embedding):
            walk.append((m.weight, "normal_div", m.embedding_dim ** 0.5))
        elif isinstance(m, T._MoEMLP):
            walk += [(w, "normal_div", (w.shape[0] * w.shape[1]) ** 0.5)
                     for w in (m.w_in, m.w_out)]
        elif isinstance(m, M.TopKExperts):
            # [held, out, in] slabs, one an expert: its own fan-in, so an
            # expert's values do not depend on how many the chip holds
            walk += [(w, "normal_div", w.shape[-1] ** 0.5)
                     for w in (m.w1, m.w3, m.w2)]
    if isinstance(module, V.VisionTransformer):
        walk.append((module.pos_embed, "normal_mul", 0.02))
    seen: set = set()
    return [r for r in walk if not (id(r[0]) in seen or seen.add(id(r[0])))]


def _fill(out: torch.Tensor, kind: str, arg: float,
          gen: torch.Generator) -> torch.Tensor:
    """One leaf's values, written into `out` (f32, contiguous)."""
    if kind == "const":
        return out.fill_(arg)
    if kind == "uniform_add":
        return torch.rand(out.shape, generator=gen, out=out).add_(arg)
    torch.randn(out.shape, generator=gen, out=out)
    return out.div_(arg) if kind == "normal_div" else out.mul_(arg)


def init_state_dict(module: nn.Module, seed: int = 0,
                    random_bn: bool = False) -> Dict[str, np.ndarray]:
    """Random weights from a seeded torch.Generator, initialised like the
    flax modules: convs (2-D, and the 1-D depthwise convolution of
    `lfm2_moe`) and dense layers LeCun-normal (variance 1/fan_in) with
    zero biases, RMSNorm weights 1, the top-k expert slabs of `lfm2_moe`
    LeCun-normal over one expert's fan-in and its router's untrained
    expert bias N(0, 0.01), the Switch expert kernels w_in [X, E, mE] / w_out
    [X, mE, E] LeCun-normal over flax's fan-in of a 3-D kernel (the
    expert axis is receptive field: X * E and X * mE), LayerNorm scale 1 / bias 0, embeddings normal with
    variance 1/features, the ViT's position table normal(0.02), and
    BatchNorm scale 1 / bias 0 / mean 0 / var 1, except the last BatchNorm
    of every residual branch, whose scale starts at 0 (flax's
    `scale_init=zeros`).

    With `random_bn`, every BatchNorm instead gets scale and running var
    from U(0.5, 1.5) and bias and running mean from N(0, 0.1), so that
    every residual branch contributes: weights for numerical checks of
    the whole network, where flax's init would leave each branch at 0."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for leaf, kind, arg in _init_walk(module, random_bn):
            if kind == "const":
                leaf.fill_(arg)
            else:
                leaf.copy_(_fill(torch.empty(leaf.shape), kind, arg, gen))
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


class DirectInit:
    """`init_state_dict`'s weights put straight onto a module's device: the
    module is built on the meta device (no storage, no default
    initialiser) and placed uninitialised, its random leaves are drawn in
    the walk's order into one flat f32 host buffer (`draw`, which touches
    no module and may run on another thread), and `land` copies that
    buffer to the device once and fills the leaves from it.  Each leaf is
    drawn into its slice as `init_state_dict` draws it into a fresh
    tensor, so the bits are the same."""

    def __init__(self, module: nn.Module, random_bn: bool = False):
        self.module = module
        walk = _init_walk(module, random_bn)
        self._leaves = [t for t, _kind, _arg in walk if t.is_floating_point()]
        self._others = [(t, arg) for t, _kind, arg in walk
                        if not t.is_floating_point()]
        self._plan, off = [], 0
        for t, kind, arg in walk:
            if t.is_floating_point():
                self._plan.append((off, t.shape, kind, arg))
                off += t.numel()
        self.numel = off

    @classmethod
    def build(cls, builder: str, kwargs: dict, device,
              random_bn: bool = False) -> Optional["DirectInit"]:
        """The registered builder's module, placed on `device` with no
        values yet; None where the walk would leave some parameter,
        buffer or other tensor of the module unwritten (the caller then
        builds and initialises as `init_state_dict` does)."""
        with torch.device("meta"):
            module = get_builder(builder)(**kwargs)
        written = {id(t) for t, _kind, _arg in _init_walk(module, random_bn)}
        if any(id(t) not in written for t in module.parameters()) or any(
                id(t) not in written for t in module.buffers()) or any(
                isinstance(v, torch.Tensor)
                for m in module.modules() for v in vars(m).values()):
            return None
        return cls(module.to_empty(device=device), random_bn)

    def draw(self, seed: int, pin_memory: bool = False) -> torch.Tensor:
        """The flat f32 host buffer of every floating leaf's values, from
        `seed` (pinned for a copy to the card)."""
        flat = torch.empty(self.numel, dtype=torch.float32,
                           pin_memory=pin_memory)
        gen = torch.Generator().manual_seed(int(seed))
        for off, shape, kind, arg in self._plan:
            _fill(flat[off:off + shape.numel()].view(shape), kind, arg, gen)
        return flat

    def land(self, flat: torch.Tensor) -> None:
        """`draw`'s buffer into the module: one copy to its device (from
        pinned memory, asynchronous; the caching host allocator holds the
        buffer until the copy completes), then one multi-tensor copy."""
        if not self._leaves:
            return
        flat = flat.to(self._leaves[0].device, non_blocking=True)
        with torch.no_grad():
            torch._foreach_copy_(
                self._leaves, [flat[off:off + shape.numel()].view(shape)
                               for off, shape, _kind, _arg in self._plan])
            for t, arg in self._others:
                t.fill_(arg)


class _Bundle:
    """`bundle_id` is a stable identity for executor caching: unique per
    construction, preserved through pickle (same weights -> same id)."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.bundle_id = uuid.uuid4().hex
        return obj


class TorchBundle(_Bundle):
    """A registered nn.Module builder + its weights.  Saved as it pickles
    (the module docstring's on-disk form): plain attributes and a numpy
    state dict, no torch object."""

    def __init__(self, builder: str, builder_kwargs: Optional[dict] = None,
                 state_dict: Optional[Mapping[str, Any]] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 layer_names: Optional[List[str]] = None,
                 dtype: str = "bfloat16", seed: int = 0):
        self.builder = builder
        self.builder_kwargs = _builder_kwargs(builder, builder_kwargs,
                                              input_shape)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.dtype = str(dtype)
        if state_dict is None:
            module = self.build_module()
            state_dict = init_state_dict(module, seed)
        else:
            with torch.device("meta"):  # shapes and class attributes only
                module = self.build_module()
        self.state_dict = {k: np.asarray(v) for k, v in state_dict.items()}
        if layer_names is None:
            layer_names = getattr(module, "layer_names", None) or []
        self.layer_names = list(layer_names)
        # token models (embedding inputs) declare input_dtype "int32"
        self.input_dtype = str(getattr(module, "input_dtype", "float32"))

    @classmethod
    def from_module(cls, builder: str, module: nn.Module,
                    builder_kwargs: Optional[dict] = None,
                    input_shape: Optional[Sequence[int]] = None,
                    dtype: str = "bfloat16") -> "TorchBundle":
        """A bundle of a trained module's weights (the f32 master of a
        TrainState: parameters and running statistics), as host numpy
        arrays in f32 (integer buffers keep their dtype) — copies, also
        of a CPU module's tensors, so that training on does not change
        the bundle."""
        state = {}
        for k, v in module.state_dict().items():
            v = v.detach().cpu()
            state[k] = np.array((v.float() if v.is_floating_point()
                                 else v).numpy())
        return cls(builder, builder_kwargs, state_dict=state,
                   input_shape=input_shape, dtype=dtype)

    def build_module(self) -> nn.Module:
        return get_builder(self.builder)(**self.builder_kwargs)

    def module(self, device: torch.device) -> nn.Module:
        """A fresh eval-mode module on `device` in the bundle's dtype
        (channels_last on the card)."""
        m = self.build_module()
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in self.state_dict.items()})
        m = m.to(device=device, dtype=getattr(torch, self.dtype)).eval()
        if torch.device(device).type == "cuda":
            m = m.to(memory_format=torch.channels_last)
        return m

    @staticmethod
    def apply(module: nn.Module, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = module(batch)
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            return out[1]
        if isinstance(out, dict):
            return out
        return {"output": out}


class FunctionBundle(_Bundle):
    """An arbitrary picklable `fn(variables, batch) -> dict | tensor` (a
    module-level function, so it pickles by name): `variables` is a dict
    of tensors, kept as numpy and handed to `fn` on the stage's device;
    a tensor result is the tap "output"."""

    input_dtype = "float32"

    def __init__(self, fn: Callable, variables: Optional[Mapping] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 layer_names: Optional[List[str]] = None):
        self.fn = fn
        self.variables = {
            k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in (variables or {}).items()}
        self.input_shape = tuple(input_shape) if input_shape else None
        self.layer_names = list(layer_names or ["output"])

    def module(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The variables as tensors on `device` (what `apply` gets)."""
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in self.variables.items()}

    def apply(self, variables: Dict[str, torch.Tensor],
              batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.fn(variables, batch)
        return out if isinstance(out, dict) else {"output": out}


def prequantize(bundle: TorchBundle) -> TorchBundle:
    """A NEW TorchBundle whose int8 layers (`ops.quant.QuantLinear`) hold
    their int8 weights and scales, computed from the bundle's CURRENT f32
    weights (an int8 copy already in the bundle is recomputed)."""
    from ..ops.quant import prequantize as prequantize_module

    module = bundle.build_module()
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in bundle.state_dict.items()})
    prequantize_module(module)
    return TorchBundle.from_module(bundle.builder, module,
                                   bundle.builder_kwargs,
                                   input_shape=bundle.input_shape,
                                   dtype=bundle.dtype)


# ---------------------------------------------------------------------------
# The weight bridge: flax ResNet variables -> TorchBundle.
# ---------------------------------------------------------------------------
_BLOCK = re.compile(r"^(BasicBlock|BottleneckBlock)_(\d+)$")
_LAYER = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_TBLOCK = re.compile(r"^block(\d+)$")
_TLAYERS = ("ln1", "ln2", "qkv", "q", "kv", "proj", "mlp_in", "mlp_out")
_TOP = ("conv_init", "bn_init", "head", "patch_embed", "tok_embed",
        "pos_embed", "ln_f")
# the convnets' layers (models/convnets.py): conv1, conv2_1, conv1a, fc1
_CONVNET = re.compile(r"^(conv\d+(_\d+|[ab])?|fc\d+)$")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_prefix(path: Sequence[str]) -> str:
    """flax module path -> torch module path (one module, no leaf)."""
    if len(path) == 1 and (path[0] in _TOP or _CONVNET.match(path[0])):
        return path[0]
    if len(path) == 2:
        mb, ml = _BLOCK.match(path[0]), _LAYER.match(path[1])
        if mb and ml:
            kind = "convs" if ml.group(1) == "Conv" else "bns"
            return f"blocks.{int(mb.group(2))}.{kind}.{int(ml.group(2))}"
        mt = _TBLOCK.match(path[0])
        if mt and path[1] in _TLAYERS:
            return f"blocks.{int(mt.group(1))}.{path[1]}"
    if len(path) == 3 and tuple(path[1:]) == ("moe", "router"):
        mt = _TBLOCK.match(path[0])
        if mt:
            return f"blocks.{int(mt.group(1))}.moe.router"
    raise KeyError(f"unrecognized flax module path {'/'.join(path)}")


def from_flax_variables(builder: str, variables: Mapping[str, Any],
                        builder_kwargs: Optional[dict] = None,
                        input_shape: Optional[Sequence[int]] = None,
                        dtype: str = "bfloat16") -> TorchBundle:
    """A flax ResNet's {'params', 'batch_stats'}, or a flax ViT's or
    TransformerLM's {'params'}, numpy tree -> TorchBundle.  A 'quant'
    collection (the JAX package's `prequantize`) gives each int8 layer
    its `wq` [K, N] int8 (stored transposed, [N, K]) and `ws` [N].

    Raises KeyError on any flax leaf that maps nowhere and on any module
    weight no leaf fills, and ValueError on a shape mismatch."""
    extra = set(variables) - {"params", "batch_stats", "quant"}
    if extra:
        raise KeyError(f"unexpected flax collections {sorted(extra)}")
    rename = {"kernel": None, "bias": "bias", "scale": "weight",
              "embedding": "weight", "mean": "running_mean",
              "var": "running_var"}
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})).items():
            *mod, leaf = path
            if not mod and leaf == "pos_embed" and coll == "params":
                name = "pos_embed"  # the ViT's [1, S, E] param
            elif (leaf in ("w_in", "w_out") and coll == "params"
                  and len(mod) == 2 and mod[1] == "moe"
                  and _TBLOCK.match(mod[0])):
                # an MoE block's expert kernels, [X, E, mE] / [X, mE, E]
                name = f"blocks.{int(_TBLOCK.match(mod[0]).group(1))}.moe.{leaf}"
            else:
                prefix = _torch_prefix(mod)
                if leaf not in rename or (coll == "batch_stats") != (
                        leaf in ("mean", "var")):
                    raise KeyError(
                        f"unexpected flax leaf {coll}/{'/'.join(path)}")
                if leaf == "kernel":
                    # conv HWIO -> OIHW; dense [in, out] -> [out, in]
                    v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
                    name = f"{prefix}.weight"
                else:
                    name = f"{prefix}.{rename[leaf]}"
            if name in out:
                raise KeyError(f"flax leaf {coll}/{'/'.join(path)} maps to "
                               f"{name} twice")
            out[name] = np.ascontiguousarray(v, np.float32)
    bundle_kwargs = _builder_kwargs(builder, builder_kwargs, input_shape)
    with torch.device("meta"):
        fresh = get_builder(builder)(**bundle_kwargs)
    want = dict(fresh.state_dict())
    quant_leaves = _flatten(variables.get("quant", {}))
    for path, v in quant_leaves.items():
        *mod, leaf = path
        prefix = _torch_prefix(mod)
        layer = fresh.get_submodule(prefix)
        if leaf not in ("wq", "ws") or not isinstance(layer, QuantLinear):
            raise KeyError(f"unexpected flax leaf quant/{'/'.join(path)}")
        n, k = layer.weight.shape
        name = f"{prefix}.{leaf}"
        out[name] = (np.ascontiguousarray(v.T, np.int8) if leaf == "wq"
                     else np.ascontiguousarray(v, np.float32))
        want[name] = torch.empty((n, k) if leaf == "wq" else (n,),
                                 device="meta")
    for name, t in want.items():
        if name.endswith("num_batches_tracked"):
            out[name] = np.zeros((), np.int64)
            continue
        if name not in out:
            raise KeyError(f"no flax leaf for module weight {name}")
        if tuple(out[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: flax shape {out[name].shape} != "
                             f"module shape {tuple(t.shape)}")
    left = set(out) - set(want)
    if left:
        raise KeyError(f"flax leaves with no module weight: {sorted(left)}")
    return TorchBundle(builder, bundle_kwargs, state_dict=out,
                       input_shape=input_shape, dtype=dtype)
