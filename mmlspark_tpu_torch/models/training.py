"""Training: the train state, step and epoch factories, and the fit loop.

Counterpart of the JAX package's `models/training.py` on one card.  The
state is a `TrainState`: the f32 master module (its parameters and its
BatchNorm running statistics are the JAX package's `params` and
`batch_stats`), a `torch.optim` optimizer over those parameters (its
`opt_state`), the step count, and the module the forward and backward
run in.  A flax module is stateless, so the JAX factories take the model
and the optimizer; here both ride in the state, and the factories take
only what the loss needs.

Precision, as the JAX package trains (flax `dtype=bfloat16` over f32
params): with `compute_dtype=bfloat16` the forward and backward run in a
working copy of the module whose parameters are bf16 and whose buffers
(BatchNorm running statistics) are the master's own f32 tensors.  After
the backward the bf16 gradients are cast into the f32 masters, the
optimizer steps the masters, and the working copy is refreshed from
them.  LayerNorm statistics are f32 inside PyTorch's bf16 kernels, the
residual stream is bf16 and the logits f32, as in flax.  With
`compute_dtype=float32` the master is the working module.

Optimizers are named like optax's: `sgd(lr, momentum)` is
`optax.sgd(lr, momentum=m)` (`torch.optim.SGD`, dampening 0, no
Nesterov) and `adam(lr)` is `optax.adam(lr)` (`torch.optim.Adam`,
betas (0.9, 0.999), eps 1e-8).  Each returns a factory that
`init_train_state` / `TrainState.create` calls on the master parameters.

The JAX package scans an epoch in one `lax.scan` dispatch; here an epoch
is a Python loop of eager steps over the stacked `[S, B, ...]` batches,
which stay on the device.  Metrics are 0-dim device tensors (a step does
not wait for the card); `fit_epochs` reads them.

Not ported yet (ROADMAP A16): the MoE auxiliary loss (the port has no
MoE), `make_distill_epoch`, the 3D trainer and `fit_epochs_resumable`
with checkpoints and the training guard.
"""
from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import telemetry as core_telemetry
from ..device import resolve_device

__all__ = ["TrainState", "sgd", "adam", "init_train_state",
           "softmax_cross_entropy", "lm_loss", "make_train_step",
           "make_train_epoch", "make_lm_train_epoch", "make_eval_step",
           "fit_epochs", "scan_slice_steps", "SCAN_SLICE_BYTES"]

# device-memory budget for one slice of stacked training data; an epoch is
# fed in slices of at most this many bytes, so device memory stays
# O(slice), not O(dataset)
SCAN_SLICE_BYTES = 256 * 1024 * 1024

OptimizerFactory = Callable[..., torch.optim.Optimizer]


def scan_slice_steps(n_steps: int, bytes_per_step: int,
                     budget: int = SCAN_SLICE_BYTES) -> int:
    """How many steps of stacked minibatches fit one slice."""
    return max(1, min(n_steps, budget // max(1, bytes_per_step)))


def sgd(learning_rate: float, momentum: float = 0.0) -> OptimizerFactory:
    """optax.sgd(learning_rate, momentum): heavy-ball momentum, the trace
    t = g + momentum * t, update -lr * t."""
    def make(params):
        return torch.optim.SGD(params, lr=float(learning_rate),
                               momentum=float(momentum))
    return make


def adam(learning_rate: float) -> OptimizerFactory:
    """optax.adam(learning_rate) with optax's defaults."""
    def make(params):
        return torch.optim.Adam(params, lr=float(learning_rate),
                                betas=(0.9, 0.999), eps=1e-8)
    return make


def _working_copy(master: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The module the forward runs in: the master itself when its
    parameters are already `dtype`, else a copy with `dtype` parameters
    that shares the master's buffers (running statistics stay f32)."""
    if all(p.dtype == dtype for p in master.parameters()):
        return master
    work = copy.deepcopy(master)
    with torch.no_grad():
        for p in work.parameters():
            p.data = p.data.to(dtype)
    for m_mod, w_mod in zip(master.modules(), work.modules()):
        for name, buf in m_mod._buffers.items():
            w_mod._buffers[name] = buf
    return work


class TrainState:
    """The f32 master module, its optimizer, the step count and the
    module the forward and backward run in (`work`)."""

    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 work: Optional[nn.Module] = None, step: int = 0):
        self.module = module
        self.optimizer = optimizer
        self.work = module if work is None else work
        self.step = step

    @classmethod
    def create(cls, module: nn.Module, optimizer: OptimizerFactory,
               compute_dtype="float32", device=None) -> "TrainState":
        """A state over `module`'s weights as they are: the module moves
        to `device` (``cuda`` unless the caller passes ``"cpu"``) in f32,
        the optimizer is built over its parameters, and the forward runs
        in `compute_dtype`."""
        dev = resolve_device(device)
        module = module.to(device=dev, dtype=torch.float32)
        if dev.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        dtype = compute_dtype if isinstance(compute_dtype, torch.dtype) \
            else getattr(torch, str(compute_dtype))
        return cls(module, optimizer(list(module.parameters())),
                   _working_copy(module, dtype))

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def apply_gradients(self, grad_norm: bool = True
                        ) -> Optional[torch.Tensor]:
        """The optimizer step from the gradients the backward left on the
        working module: cast into the f32 masters, global L2 norm taken
        (`optax.global_norm`; returned, or None without `grad_norm`),
        masters stepped, working copy refreshed, gradients cleared.  The
        casts and the refresh are one multi-tensor op each."""
        masters = list(self.module.parameters())
        if self.work is not self.module:
            pairs = [(pm, pw) for pm, pw in zip(masters,
                                                self.work.parameters())
                     if pw.grad is not None]
            for pm, pw in pairs:
                pm.grad = torch.empty_like(pm)
            if pairs:
                torch._foreach_copy_([pm.grad for pm, _ in pairs],
                                     [pw.grad for _, pw in pairs])
            self.work.zero_grad(set_to_none=True)
        norm = torch.nn.utils.get_total_norm(
            [p.grad for p in masters if p.grad is not None]).detach() \
            if grad_norm else None
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.work is not self.module:
            with torch.no_grad():
                torch._foreach_copy_(list(self.work.parameters()), masters)
        self.step += 1
        return norm


def init_train_state(model: nn.Module, optimizer: OptimizerFactory,
                     seed: int = 0, compute_dtype="float32",
                     device=None) -> TrainState:
    """`model`'s weights initialised from `seed` like the flax modules'
    (bundle.init_state_dict: LeCun-normal kernels, zero biases, flax's
    zero scale on each residual branch's last BatchNorm) and a state over
    them.  The numbers differ from `jax.random`'s for the same seed; a
    caller who needs the JAX package's weights bridges them
    (bundle.from_flax_variables) and uses `TrainState.create`."""
    from .bundle import init_state_dict

    init_state_dict(model, seed)
    return TrainState.create(model, optimizer, compute_dtype, device)


def _per_example_ce(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """optax.softmax_cross_entropy against one-hot labels, per example, in
    f32: a label outside [0, C) (the -1 of batch padding) has an all-zero
    one-hot row and a loss of 0."""
    logits = logits.float()
    labels = labels.long()
    valid = (labels >= 0) & (labels < logits.shape[-1])
    picked = logits.gather(-1, labels.clamp(0, logits.shape[-1] - 1)[:, None])
    return (torch.logsumexp(logits, -1) - picked[:, 0]) * valid


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """Mean softmax cross-entropy of logits [B, C] against int labels [B]
    (the JAX package's, over `jax.nn.one_hot(labels, num_classes)`)."""
    if logits.shape[-1] != num_classes:
        raise ValueError(f"logits have {logits.shape[-1]} classes, expected "
                         f"{num_classes}")
    return _per_example_ce(logits, labels).mean()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy: logits[:, :-1] (in f32) against
    tokens[:, 1:], as `optax.softmax_cross_entropy_with_integer_labels`."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, v),
                           tokens[:, 1:].reshape(-1).long())


def make_train_step(num_classes: int) -> Callable:
    """`step(state, images [B, ...], labels [B]) -> (state, metrics)`: the
    forward in train mode (BatchNorm on the batch's statistics, running
    statistics updated), softmax cross-entropy, backward, optimizer step.
    Metrics `loss`, `accuracy` and `grad_norm` are 0-dim tensors; the
    state is updated in place and returned."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        logits, _taps = state.work.train()(images)
        loss = softmax_cross_entropy(logits, labels, num_classes)
        loss.backward()
        grad_norm = state.apply_gradients()
        acc = (logits.detach().argmax(-1) == labels.long()).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "grad_norm": grad_norm}

    return step


def make_train_epoch(num_classes: int) -> Callable:
    """`epoch(state, images [S, B, ...], labels [S, B]) -> (state,
    metrics)`: S steps over the stacked minibatches, metrics stacked [S]."""
    step = make_train_step(num_classes)

    def epoch(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        ms = [step(state, images[i], labels[i])[1]
              for i in range(images.shape[0])]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return epoch


def make_lm_train_epoch() -> Callable:
    """`epoch(state, tokens [S, B, T] int) -> (state, losses [S])`: S
    next-token steps of a TransformerLM (`lm_loss`; the JAX package adds
    0.01x the MoE auxiliary loss, which a dense model does not have)."""

    def epoch(state: TrainState, tokens: torch.Tensor):
        losses = []
        for i in range(tokens.shape[0]):
            toks = tokens[i]
            logits, _taps = state.work.train()(toks)
            loss = lm_loss(logits, toks)
            loss.backward()
            state.apply_gradients(grad_norm=False)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return epoch


def make_eval_step() -> Callable:
    """`step(state, images) -> predicted class [B]`, in eval mode (running
    statistics) without gradients."""

    def step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        work = state.work.eval()
        with torch.inference_mode():
            logits, _taps = work(images)
        work.train()
        return logits.argmax(-1)

    return step


def _observe(dt: float, steps: int, batch_size: int) -> None:
    core_telemetry.histogram("models.training.step_latency").observe(
        dt / max(1, steps))
    core_telemetry.gauge("models.training.examples_per_sec").set(
        steps * batch_size / dt if dt > 0 else 0.0)


def fit_epochs(step_fn: Optional[Callable], state: TrainState,
               images: np.ndarray, labels: np.ndarray, batch_size: int,
               epochs: int = 1, seed: int = 0,
               log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
               epoch_fn: Optional[Callable] = None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """Epoch loop over a host-resident dataset on the state's device; the
    remainder of each epoch is dropped.  Each epoch's order is a
    permutation from one `np.random.default_rng(seed)` stream.

    With `epoch_fn` (make_train_epoch) each epoch's shuffled batches are
    stacked [k, B, ...] in slices of at most SCAN_SLICE_BYTES, assembled
    on pipeline workers and fed `DeviceFeed.stream`-ahead of the steps;
    otherwise each minibatch rides the stream to `step_fn`.  Every slice
    or step is a `training.step` span, observed in the
    `models.training.step_latency` histogram (seconds a step) and the
    `models.training.examples_per_sec` gauge.  Returns the state and the
    last step's metrics as floats."""
    from ..io.feed import DeviceFeed
    from ..io.pipeline import HostPipeline, PipelineStage, pipeline_workers

    n = len(images)
    if n < batch_size:
        raise ValueError(f"dataset has {n} rows < batch_size {batch_size}; "
                         "lower batch_size")
    rng = np.random.default_rng(seed)
    feed = DeviceFeed(state.device)
    metrics: Dict[str, float] = {}
    steps = n // batch_size
    for _epoch in range(epochs):
        order = rng.permutation(n)
        idx = order[:steps * batch_size]
        if epoch_fn is not None:
            step_bytes = batch_size * (int(np.prod(images.shape[1:]))
                                       * images.dtype.itemsize
                                       + labels.dtype.itemsize)
            k = scan_slice_steps(steps, step_bytes)

            def assemble(bounds, idx=idx):
                s, e = bounds
                sel = idx[s * batch_size:e * batch_size]
                return (images[sel].reshape(e - s, batch_size,
                                            *images.shape[1:]),
                        labels[sel].reshape(e - s, batch_size))

            pipe = HostPipeline([PipelineStage(
                "assemble", assemble, workers=pipeline_workers(2))])
            bounds = [(s, min(s + k, steps)) for s in range(0, steps, k)]
            for dbi, dbl in feed.stream(pipe.run(bounds)):
                t0 = time.perf_counter()
                with core_telemetry.span("training.step") as sp:
                    state, ms = epoch_fn(state, dbi, dbl)
                    # the host read waits for the slice's device work
                    metrics = {k2: float(v[-1]) for k2, v in ms.items()}
                    sp.attrs["steps"] = int(dbi.shape[0])
                _observe(time.perf_counter() - t0, int(dbi.shape[0]),
                         batch_size)
            if log_fn:
                log_fn(int(state.step), metrics)
            continue
        batches = ((images[idx[s:s + batch_size]],
                    labels[idx[s:s + batch_size]])
                   for s in range(0, steps * batch_size, batch_size))
        for dbi, dbl in feed.stream(batches):
            t0 = time.perf_counter()
            with core_telemetry.span("training.step"):
                state, m = step_fn(state, dbi, dbl)
                metrics = {k: float(v) for k, v in m.items()}
            _observe(time.perf_counter() - t0, 1, batch_size)
            if log_fn:
                log_fn(int(state.step), metrics)
    return state, metrics
