"""Int8 inference: int8 weight layers and int8 KV-cache rows.

Counterpart of the JAX package's `ops/quant.py`, with its arithmetic
kept so that the two give the same bits on the same f32 inputs:

* weights: symmetric per-output-channel int8, scale max(|w|, 1e-8) / 127
  over the input axis;
* activations: dynamic symmetric per-tensor int8, ONE scale
  max(|x|, 1e-8) / 127 over the whole tensor, computed per call;
* every tensor is DIVIDED by its scale (not multiplied by the
  reciprocal), and so is each scale's max by 127 — on CUDA as a tensor,
  since PyTorch multiplies a CUDA tensor by the reciprocal of a Python
  divisor — and `torch.round` rounds half to even as `jnp.round` does;
* the product accumulates in int32 (exact: 127 * 127 * K < 2^31 for any
  K here), then `acc.float() * (xs * ws)` in that order, then `+ bias`,
  then the cast to the layer's dtype.

`QuantLinear` is the counterpart of `QuantDense`: an `nn.Linear` with
the same f32 weight and bias, so any trained checkpoint loads unchanged,
and it quantizes the weight inside each forward.  Its weight, bias and
scales stay f32 whatever dtype the module is cast to (`QuantDense`
keeps an f32 kernel in a bf16 model too); its output takes the dtype of
its input, which is the model's compute dtype.  `prequantize(module)`
stores each layer's (int8 weight, scales) as the buffers `wq` [N, K]
and `ws` [N] beside the f32 weight, and a layer that holds them reads
only those (the JAX package's 'quant' collection, transposed to torch's
[out, in] layout).  A fresh module accepts the buffers when it loads a
prequantized state dict.

The GEMM is `torch._int_mm` on both devices.  On CUDA (cuBLASLt's int8
path) it wants M > 16 and K, N multiples of 8, and the weight
column-major: rows are padded with zeros up to 17 and K / N with zeros up
to a multiple of 8 — zeros change neither the per-tensor scale (taken
before the padding) nor any real output — and the [N, K] weight goes in
as its transpose.  A shape `torch._int_mm` still rejects raises: there
is no fall-back to a float matmul.  `INT8_GEMMS` counts the calls.

`quantize_kv_row` is the int8 KV-cache row of the JAX package: scale
max(|x|, 1e-8) / 127 per (position, head), the same rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["quantize_kv_row", "quantize_weight", "int8_matmul",
           "int8_dense", "QuantLinear", "dense_cls", "prequantize",
           "INT8_GEMMS"]

_EPS = 1e-8

#: `torch._int_mm` calls (one a quantized layer's forward)
INT8_GEMMS = 0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, divided as the JAX package divides: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal
    instead (one bit off now and then), so 127 goes in as a tensor on
    the same device."""
    return torch.clamp(amax, min=_EPS) / amax.new_full((), 127.0)


def quantize_kv_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] K/V rows -> (int8 rows, f32 per-row-per-head scales
    [..., H]): symmetric per-(position, head) scaling."""
    xf = x.float()
    s = _scale(xf.abs().amax(dim=-1))
    q = torch.round(xf / s[..., None]).to(torch.int8)
    return q, s


def quantize_weight(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 `[N, K]` (nn.Linear's layout) -> (int8 `[N, K]`,
    per-output-channel f32 scales `[N]`)."""
    w = weight.float()
    ws = _scale(w.abs().amax(dim=1))
    wq = torch.round(w / ws[:, None]).to(torch.int8)
    return wq, ws


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 `[M, K]` @ int8 `[N, K]`^T -> int32 `[M, N]`, exact."""
    global INT8_GEMMS
    m, k = xq.shape
    n = wq.shape[0]
    if xq.is_cuda:
        r8 = lambda v: -(-v // 8) * 8  # noqa: E731
        mp, kp, np_ = max(m, 17), r8(k), r8(n)
        xq = _pad_to(xq, mp, kp)
        wq = _pad_to(wq, np_, kp)
    INT8_GEMMS += 1
    acc = torch._int_mm(xq.contiguous(), wq.t())
    return acc[:m, :n]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`x [..., K]` against a quantized weight (wq `[N, K]` int8, ws `[N]`
    f32); returns f32 `[..., N]`.  The activation scale is one scalar
    over the whole of `x`."""
    x = x.float()
    xs = _scale(x.abs().amax())  # one scalar, dynamic
    xq = torch.round(x / xs).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), wq)
    y = acc.float() * (xs * ws)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], wq.shape[0])


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`x [..., K] @ weight [N, K]^T` run as int8, quantizing the weight
    on the fly; returns f32."""
    wq, ws = quantize_weight(weight)
    return int8_matmul(x, wq, ws, bias)


class QuantLinear(nn.Linear):
    """Drop-in for `nn.Linear` with int8 compute (the JAX package's
    `QuantDense`): the same f32 `weight` [out, in] and `bias`, kept f32
    under any module dtype; the output is cast to the input's dtype.
    With the buffers `wq` / `ws` (`prequantize`) it reads the int8 copy
    only."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        self.register_buffer("wq", None)
        self.register_buffer("ws", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.wq is not None:
            y = int8_matmul(x, self.wq, self.ws, self.bias)
        else:
            y = int8_dense(x, self.weight, self.bias)
        return y.to(x.dtype)

    def _apply(self, fn, recurse=True):
        # a cast moves the f32 weight, bias and scales but keeps them f32
        def keep_dtype(t):
            out = fn(t)
            return out if out.dtype == t.dtype else t.to(out.device)

        return super()._apply(keep_dtype, recurse)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a prequantized state dict carries wq / ws, which a fresh layer
        # lacks: take their shapes, then load them like any buffer
        for name, dtype in (("wq", torch.int8), ("ws", torch.float32)):
            src = state_dict.get(prefix + name)
            if src is not None and getattr(self, name) is None:
                setattr(self, name, torch.empty(
                    src.shape, dtype=dtype, device=self.weight.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def dense_cls(quant: bool):
    """The one quant -> linear-class selection both model families use."""
    return QuantLinear if quant else nn.Linear


def prequantize(module: nn.Module) -> nn.Module:
    """Store every `QuantLinear`'s (int8 weight, scales), computed from
    its CURRENT f32 weight (a stale int8 copy is replaced), in place;
    returns the module.  Call it after the final weights are loaded."""
    layers = [m for m in module.modules() if isinstance(m, QuantLinear)]
    if not layers:
        raise ValueError(
            "prequantize: the model has no QuantLinear layers — build it "
            "with quant=True (vit_* / transformer_lm) or use QuantLinear "
            "directly")
    with torch.no_grad():
        for m in layers:
            m.wq, m.ws = quantize_weight(m.weight)
    return module
