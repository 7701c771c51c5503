"""K1: the online learners' AdaGrad pass, a hand-written CUDA kernel.

The JAX package runs one pass of per-example AdaGrad SGD over padded
sparse rows as a `lax.scan` under `jit` (online/learners.py:36
`_train_pass_impl`, online/contextual_bandit.py:44 `_cb_train_pass`).
Here the pass is `csrc/online_pass.cu`, one launch a pass that walks the
examples in order (the port's own kernel; it replaces no Pallas kernel),
and `online_pass_plain` beside it is the same scan as a PyTorch loop over
the examples: the CPU path, and the kernel's oracle on the card.

`plan_rows` lays the rows out for the kernel once a fit: each row's
slots sorted stably by (value == 0, index), the nonzero count `nnz`, and
`run`, the length of each run of equal indices at its first slot.  That
keeps the reference's duplicate semantics (every slot of an index adds
its square to g2 before any slot reads it; every slot reads w before any
writes; the steps add up in slot order) without atomics, so two launches
agree bit for bit.  All-zero slots and rows are exact no-ops.

`online_pass` launches K1 for CUDA tensors and runs the plain loop for
CPU ones; `LAUNCHES` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["LOSSES", "RowPlan", "plan_rows", "online_pass",
           "online_pass_plain", "LAUNCHES"]

LOSSES = {"squared": 0, "logistic": 1, "bandit": 2}

LAUNCHES = 0


class RowPlan(NamedTuple):
    """Rows laid out for K1: `idx` int32 [n, A], `val` f32 [n, A] sorted
    within each row, `run` int32 [n, A] and `nnz` int32 [n]."""

    idx: torch.Tensor
    val: torch.Tensor
    run: torch.Tensor
    nnz: torch.Tensor


def plan_rows(idx: torch.Tensor, val: torch.Tensor) -> RowPlan:
    """Sort each row's slots stably by (value == 0, index) and mark the
    runs of equal indices among the nonzero slots, on the rows' device."""
    if idx.dim() != 2 or idx.shape != val.shape:
        raise ValueError(f"plan_rows: idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must be one [n, A] layout")
    key = idx.to(torch.int64) + (val == 0).to(torch.int64) * (1 << 40)
    order = torch.sort(key, dim=1, stable=True).indices
    idx_s = torch.gather(idx.to(torch.int64), 1, order)
    val_s = torch.gather(val.to(torch.float32), 1, order).contiguous()
    nz = val_s != 0
    nnz = nz.sum(dim=1).to(torch.int32)
    same = torch.zeros_like(nz)
    same[:, 1:] = nz[:, 1:] & nz[:, :-1] & (idx_s[:, 1:] == idx_s[:, :-1])
    start = nz & ~same
    # run id of each nonzero slot, then each run's length at its start
    n, a = idx.shape
    rid = torch.cumsum(start.to(torch.int64), dim=1) - 1 + \
        torch.arange(n, device=idx.device)[:, None] * a
    length = torch.zeros(n * a, dtype=torch.int64, device=idx.device)
    length.index_add_(0, rid[nz], torch.ones_like(rid[nz]))
    run = torch.where(start, length[rid.clamp(min=0)], 0).to(torch.int32)
    return RowPlan(idx_s.to(torch.int32).contiguous(), val_s,
                   run.contiguous(), nnz.contiguous())


def _check(w, g2, plan: RowPlan, y, wt, loss: str) -> None:
    if loss not in LOSSES:
        raise ValueError(f"online_pass: unknown loss {loss!r}")
    n, a = plan.idx.shape
    for name, t, dtype, shape in (
            ("w", w, torch.float32, None), ("g2", g2, torch.float32, None),
            ("idx", plan.idx, torch.int32, (n, a)),
            ("val", plan.val, torch.float32, (n, a)),
            ("run", plan.run, torch.int32, (n, a)),
            ("nnz", plan.nnz, torch.int32, (n,)),
            ("y", y, torch.float32, (n,))) + (
            (("wt", wt, torch.float32, (n,)),) if wt is not None else ()):
        if t.dtype != dtype:
            raise TypeError(f"online_pass: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"online_pass: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != w.device:
            raise ValueError(f"online_pass: {name} on {t.device}, w on {w.device}")
    if w.dim() != 1 or g2.shape != w.shape:
        raise ValueError("online_pass: w and g2 must be one [dim] table each")
    if (loss == "bandit") != (wt is not None):
        raise ValueError("online_pass: the bandit loss, and only it, takes "
                         "per-example weights")


def online_pass_plain(w: torch.Tensor, g2: torch.Tensor, plan: RowPlan,
                      y: torch.Tensor, lr: float, l1: float = 0.0,
                      l2: float = 0.0, loss: str = "squared",
                      wt: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass as a PyTorch loop over the examples, updating w and g2 in
    place: the reference's scan step by step.  Returns the per-example
    losses (masked by validity, unmasked for the bandit) and valid flags."""
    _check(w, g2, plan, y, wt, loss)
    n = plan.idx.shape[0]
    losses = torch.zeros(n, dtype=torch.float32, device=w.device)
    valid = torch.zeros(n, dtype=torch.float32, device=w.device)
    neg_lr = torch.tensor(-lr, dtype=torch.float32, device=w.device)
    for e in range(n):
        k = int(plan.nnz[e])
        i = plan.idx[e, :k].to(torch.int64)
        v = plan.val[e, :k]
        pred = torch.sum(w[i] * v)
        if loss == "logistic":
            z = -y[e] * pred
            g = -y[e] * torch.sigmoid(z)
            ex_loss = torch.logaddexp(z, torch.zeros_like(z))
        else:
            r = pred - y[e]
            g = r if wt is None else wt[e] * r
            ex_loss = 0.5 * r * r if wt is None else wt[e] * (0.5 * (r * r))
        gi = g * v
        g2.index_add_(0, i, gi * gi)
        denom = torch.sqrt(g2[i]) + 1e-8
        wi = w[i]
        if loss == "bandit":
            delta = neg_lr * gi / denom
        else:
            delta = neg_lr * (gi / denom + l2 * wi + l1 * torch.sign(wi))
        w.index_add_(0, i, delta)
        vflag = 1.0 if k > 0 else 0.0
        losses[e] = ex_loss if loss == "bandit" else ex_loss * vflag
        valid[e] = vflag
    return losses, valid


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("online_pass")
    fn = lib.mmk_online_pass
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 +
                       [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_float, ctypes.c_float,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mmk_online_max_slots.restype = ctypes.c_int
    return lib


def online_pass(w: torch.Tensor, g2: torch.Tensor, plan: RowPlan,
                y: torch.Tensor, lr: float, l1: float = 0.0, l2: float = 0.0,
                loss: str = "squared", wt: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over the planned rows, updating w and g2 in place; returns
    (per-example losses, valid flags).  K1 for CUDA tensors, the plain
    loop for CPU ones."""
    global LAUNCHES
    _check(w, g2, plan, y, wt, loss)
    if w.device.type == "cpu":
        return online_pass_plain(w, g2, plan, y, lr, l1, l2, loss, wt)
    if w.device.type != "cuda":
        raise ValueError(f"online_pass: unsupported device {w.device}")
    tensors = [w, g2, plan.idx, plan.val, plan.run, plan.nnz, y] + (
        [wt] if wt is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("online_pass: every tensor must be contiguous")
    lib = _kernel_lib()
    n, a = plan.idx.shape
    if a > lib.mmk_online_max_slots():
        raise ValueError(f"online_pass: rows of {a} slots; K1 takes at most "
                         f"{lib.mmk_online_max_slots()}")
    if n and int(plan.idx.max()) >= w.numel():
        raise ValueError("online_pass: an index lies outside the weight table")
    losses = torch.empty(n, dtype=torch.float32, device=w.device)
    valid = torch.empty(n, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmk_online_pass(
            w.data_ptr(), g2.data_ptr(), plan.idx.data_ptr(),
            plan.val.data_ptr(), plan.run.data_ptr(), plan.nnz.data_ptr(),
            y.data_ptr(), wt.data_ptr() if wt is not None else None,
            int(n), int(max(a, 1)), LOSSES[loss], float(lr), float(l1),
            float(l2), losses.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"online_pass kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return losses, valid
