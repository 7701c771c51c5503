"""TorchBundle: a serializable (architecture + weights) unit, and the
weight bridge from the JAX package's flax variables.

Counterpart of the JAX package's `models/bundle.py`: a model is a
registered builder name + kwargs (reconstructable code) plus a state
dict of numpy arrays (picklable), with named outputs ("taps") for
CNTK-style node addressing (CNTKModel.scala:229-371).  `dtype` is the
compute dtype the module runs in (the flax modules' `dtype` field).

`from_flax_variables` turns a flax ResNet's ``{'params', 'batch_stats'}``
or a flax ViT's / TransformerLM's ``{'params'}`` numpy tree into a
TorchBundle: conv kernels HWIO -> OIHW, Dense kernels [in, out] ->
Linear weights [out, in], BatchNorm scale/bias from `params` and
mean/var from `batch_stats`, LayerNorm scale/bias -> weight/bias, Embed
`embedding` -> Embedding weight, the ViT's `pos_embed` param as it is,
ResNet block `<Block>_i` and transformer `block{i}` -> `blocks.i`.  Every
leaf on either side must be used exactly once.

`TorchBundle.from_module` takes a trained module's weights (what
`DeepVisionClassifier.fit` hands to its `DeepVisionModel`).

A bundle's taps (`layer_names`) and its input dtype (`input_dtype`:
int32 token ids for the LM, float32 otherwise) come from its module, as
the JAX package's FlaxBundle takes them.
"""
from __future__ import annotations

import inspect
import re
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import resnet as R
from . import transformer as T
from . import vit as V

__all__ = ["TorchBundle", "register_builder", "get_builder",
           "from_flax_variables", "init_state_dict"]

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
for _name in ("vit_tiny", "vit_small", "vit_base"):
    register_builder(_name, getattr(V, _name))


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


def init_state_dict(module: nn.Module, seed: int = 0,
                    random_bn: bool = False) -> Dict[str, np.ndarray]:
    """Random weights from a seeded torch.Generator, initialised like the
    flax modules: convs and dense layers LeCun-normal (variance 1/fan_in)
    with zero biases, LayerNorm scale 1 / bias 0, embeddings normal with
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
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                if random_bn:
                    for t in (m.weight, m.running_var):
                        t.copy_(0.5 + torch.rand(t.shape, generator=gen))
                    for t in (m.bias, m.running_mean):
                        t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / m.embedding_dim ** 0.5)
        if isinstance(module, V.VisionTransformer):
            module.pos_embed.copy_(0.02 * torch.randn(
                module.pos_embed.shape, generator=gen))
        if isinstance(module, R.ResNet) and not random_bn:
            for block in module.blocks:
                n_branch = len(block.bns) - int(block.has_proj)
                block.bns[n_branch - 1].weight.zero_()
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


class TorchBundle:
    """A registered nn.Module builder + its weights.

    `bundle_id` is a stable identity for executor caching: unique per
    construction, preserved through pickle (same weights -> same id)."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.bundle_id = uuid.uuid4().hex
        return obj

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
        arrays in f32 (integer buffers keep their dtype)."""
        state = {}
        for k, v in module.state_dict().items():
            v = v.detach().cpu().contiguous()
            state[k] = (v.float() if v.is_floating_point() else v).numpy()
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


# ---------------------------------------------------------------------------
# The weight bridge: flax ResNet variables -> TorchBundle.
# ---------------------------------------------------------------------------
_BLOCK = re.compile(r"^(BasicBlock|BottleneckBlock)_(\d+)$")
_LAYER = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_TBLOCK = re.compile(r"^block(\d+)$")
_TLAYERS = ("ln1", "ln2", "qkv", "q", "kv", "proj", "mlp_in", "mlp_out")
_TOP = ("conv_init", "bn_init", "head", "patch_embed", "tok_embed",
        "pos_embed", "ln_f")


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
    if len(path) == 1 and path[0] in _TOP:
        return path[0]
    if len(path) == 2:
        mb, ml = _BLOCK.match(path[0]), _LAYER.match(path[1])
        if mb and ml:
            kind = "convs" if ml.group(1) == "Conv" else "bns"
            return f"blocks.{int(mb.group(2))}.{kind}.{int(ml.group(2))}"
        mt = _TBLOCK.match(path[0])
        if mt and path[1] in _TLAYERS:
            return f"blocks.{int(mt.group(1))}.{path[1]}"
    raise KeyError(f"unrecognized flax module path {'/'.join(path)}")


def from_flax_variables(builder: str, variables: Mapping[str, Any],
                        builder_kwargs: Optional[dict] = None,
                        input_shape: Optional[Sequence[int]] = None,
                        dtype: str = "bfloat16") -> TorchBundle:
    """A flax ResNet's {'params', 'batch_stats'}, or a flax ViT's or
    TransformerLM's {'params'}, numpy tree -> TorchBundle.

    Raises KeyError on any flax leaf that maps nowhere and on any module
    weight no leaf fills, and ValueError on a shape mismatch."""
    extra = set(variables) - {"params", "batch_stats"}
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
        want = get_builder(builder)(**bundle_kwargs).state_dict()
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
