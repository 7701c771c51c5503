"""Weighted regression solvers of the local explainers, on the card.

Reference: core explainers/RegressionBase.scala (lasso/weighted-least-squares in
Breeze, 114 LoC) used by LIMEBase.scala:93-114 and KernelSHAPBase.scala:36-138.

Counterpart of the JAX package's `explainers/regression.py`: every
instance's (num_samples x d) design is solved in one batched call instead
of a per-row Breeze solve.  The JAX package vmaps one solve per (row,
target) and rebuilds the same weighted Gram `A` for every target; here
each row's centred `(d, d)` system is built once and solved for all `t`
right-hand sides by one batched `torch.linalg.solve` (the same arithmetic:
the targets share `A`).  The lasso keeps the reference's iteration
exactly — 16 power steps from `ones/√d` for the Lipschitz constant, the
step `1/max(vᵀAv, 1e-8)`, 300 ISTA steps with the prox
`sign(z)·max(|z| − step·α, 0)`, the intercept `ym − xm·β` — as one loop
over batched tensors for all rows and targets.  The products and the
solve run in full f32 (`models/linear._full_f32`: no TF32).

The device functions take numpy arrays or tensors and a `device` ('cuda'
unless the caller passes 'cpu'; without a card only 'cpu' runs) and
return f32 tensors on it.  `np_batch_weighted_least_squares` is the JAX
package's host f64 solve, copied: KernelSHAP's 1e6 anchor weights are
beyond f32's range.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.linear import _full_f32

__all__ = [
    "weighted_least_squares",
    "lasso",
    "batch_weighted_least_squares",
    "np_batch_weighted_least_squares",
    "batch_lasso",
]

Device = Optional[Union[str, torch.device]]


def _f32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _centred(X, Y, W):
    """The weighted centring both solvers share.  X (n, s, d), Y (n, s, t),
    W (n, s) -> (A (n, d, d) the weighted Gram of the centred design,
    B (n, d, t), xm (n, d), ym (n, t))."""
    wn = W / (W.sum(dim=1, keepdim=True) + 1e-12)
    xm = torch.einsum("ns,nsd->nd", wn, X)
    ym = torch.einsum("ns,nst->nt", wn, Y)
    Xc = X - xm[:, None, :]
    Yc = Y - ym[:, None, :]
    Xw = Xc * wn[:, :, None]
    A = Xw.transpose(1, 2) @ Xc
    B = Xw.transpose(1, 2) @ Yc
    return A, B, xm, ym


def batch_weighted_least_squares(X, Y, W, l2: float = 1e-6,
                                 device: Device = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched WLS: argmin_b Σ_i w_i (x_i·b + b0 − y_i)² + l2 |b|² on the
    normalized weights, per (row, target).

    X: (n, s, d) designs; Y: (n, s, t) targets; W: (n, s) weights.
    Returns coefs (n, t, d), intercepts (n, t) on `device`.
    """
    dev = resolve_device(device)
    X, Y, W = _f32(X, dev), _f32(Y, dev), _f32(W, dev)
    with _full_f32():
        A, B, xm, ym = _centred(X, Y, W)
        d = X.shape[2]
        A = A + l2 * torch.eye(d, dtype=A.dtype, device=dev)
        coefs = torch.linalg.solve(A, B).transpose(1, 2)  # (n, t, d)
        intercepts = ym - torch.einsum("ntd,nd->nt", coefs, xm)
    return coefs, intercepts


def batch_lasso(X, Y, W, alpha: float, iters: int = 300,
                device: Device = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched weighted lasso by ISTA (proximal gradient) on centred,
    normalized weights, same shapes as batch_weighted_least_squares:
    argmin_b 0.5 Σ_i w_i (x_i·b + b0 − y_i)² + alpha |b|_1."""
    dev = resolve_device(device)
    X, Y, W = _f32(X, dev), _f32(Y, dev), _f32(W, dev)
    n, _, d = X.shape
    with _full_f32():
        A, B, xm, ym = _centred(X, Y, W)
        # the Lipschitz constant of the gradient, the largest eigenvalue of
        # A, by power iteration (A is the same for every target of a row)
        v = torch.full((n, d, 1), 1.0 / np.sqrt(d), dtype=torch.float32,
                       device=dev)
        for _ in range(16):
            v = A @ v
            v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        L = torch.clamp((v * (A @ v)).sum(dim=1, keepdim=True), min=1e-8)
        step = 1.0 / L  # (n, 1, 1)
        thresh = step * alpha
        beta = torch.zeros_like(B)  # (n, d, t)
        for _ in range(int(iters)):
            z = beta - step * (A @ beta - B)
            beta = torch.sign(z) * torch.clamp(z.abs() - thresh, min=0.0)
        coefs = beta.transpose(1, 2)  # (n, t, d)
        intercepts = ym - torch.einsum("ntd,nd->nt", coefs, xm)
    return coefs, intercepts


def weighted_least_squares(X, y, w, l2: float = 1e-6, device: Device = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One WLS solve: X (s, d), y (s,), w (s,) -> (coefs (d,), intercept)."""
    dev = resolve_device(device)
    coefs, inter = batch_weighted_least_squares(
        _f32(X, dev)[None], _f32(y, dev)[None, :, None], _f32(w, dev)[None],
        l2=l2, device=dev)
    return coefs[0, 0], inter[0, 0]


def lasso(X, y, w, alpha: float, iters: int = 300, device: Device = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weighted lasso: X (s, d), y (s,), w (s,) -> (coefs (d,),
    intercept)."""
    dev = resolve_device(device)
    coefs, inter = batch_lasso(
        _f32(X, dev)[None], _f32(y, dev)[None, :, None], _f32(w, dev)[None],
        alpha, iters=iters, device=dev)
    return coefs[0, 0], inter[0, 0]


def np_batch_weighted_least_squares(X, Y, W, l2=1e-9):
    """Host float64 batched WLS — used where anchor weights span ~1e6 of
    dynamic range (KernelSHAP's full/null coalition constraints), which f32
    on-device solves cannot resolve.  Same shapes/returns as
    batch_weighted_least_squares, as numpy f32 arrays."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    W = np.asarray(W, np.float64)
    n, s, d = X.shape
    t = Y.shape[2]
    wn = W / (W.sum(axis=1, keepdims=True) + 1e-300)  # (n, s)
    xm = np.einsum("ns,nsd->nd", wn, X)
    ym = np.einsum("ns,nst->nt", wn, Y)
    Xc = X - xm[:, None, :]
    Yc = Y - ym[:, None, :]
    Xw = Xc * wn[:, :, None]
    A = np.einsum("nsd,nse->nde", Xw, Xc) + l2 * np.eye(d)[None]
    B = np.einsum("nsd,nst->ndt", Xw, Yc)
    coefs = np.linalg.solve(A, B)  # (n, d, t)
    coefs = np.transpose(coefs, (0, 2, 1))  # (n, t, d)
    intercepts = ym - np.einsum("ntd,nd->nt", coefs, xm)
    return coefs.astype(np.float32), intercepts.astype(np.float32)
