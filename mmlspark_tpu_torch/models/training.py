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
`compute_dtype=float32` the master is the working module.  A layer that
flax keeps in f32 whatever the model dtype (`keeps_f32`: the MoE router,
`transformer.F32Linear`) keeps f32 parameters in the working copy too.

A model with MoE blocks (`moe_experts > 0`) adds 0.01 times its summed
load-balance losses to the objective in `make_train_step`,
`make_train_epoch` and `make_lm_train_epoch`, as the JAX package adds
its sown 'losses': the step hands the forward an `aux` list, which each
MoE layer fills.  A dense model's objective is the cross-entropy alone.

Optimizers are named like optax's: `sgd(lr, momentum)` is
`optax.sgd(lr, momentum=m)` (`torch.optim.SGD`, dampening 0, no
Nesterov) and `adam(lr)` is `optax.adam(lr)` (`torch.optim.Adam`,
betas (0.9, 0.999), eps 1e-8).  Each returns a factory that
`init_train_state` / `TrainState.create` calls on the master parameters.

The JAX package scans an epoch in one `lax.scan` dispatch; here an epoch
is a Python loop of eager steps over the stacked `[S, B, ...]` batches,
which stay on the device.  Metrics are 0-dim device tensors (a step does
not wait for the card); `fit_epochs` reads them.

`fit_epochs_resumable` is the loop that survives being killed or
poisoned: checkpoints every `checkpoint_every` steps through
`models/checkpoint.CheckpointManager` (verified manifests), resume from
the newest verified step, and with a `models/guard.TrainingGuard` the
anomaly ladder (quarantine a poisoned batch, roll back, abort).

`make_distill_epoch(teacher)` distils a student (the state) from a
teacher bundle: KL at a temperature plus next-token cross-entropy, the
teacher's forward without gradients.

The 3D trainer (`make_lm_train_step_3d`, data x tensor x pipe over a
`parallel.mesh.MeshPlan`, one SPMD process a rank) and its layout
helpers live in `models/trainer3d.py` and are re-exported here;
`fit_epochs_resumable(elastic=...)` runs the multi-process
shrink-and-resume ladder over `parallel.distributed.ElasticContext`.

Each step / epoch factory's result is wrapped by
`core.telemetry.watch_compiles` under the JAX package's names
(`training.train_step`, `training.train_epoch`,
`training.lm_train_epoch`, `training.eval_step`,
`training.distill_epoch`, `training.lm_train_step_3d`): a new input
shape after the caller ended warmup is flagged.
"""
from __future__ import annotations

import copy
import math
import os
import time
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import telemetry as core_telemetry
from ..device import resolve_device
from .trainer3d import (TrainState3D, gather_params, init_lm_state_3d,
                        lm_params_from_3d, lm_params_to_3d, lm_params_tree,
                        load_lm_params, make_lm_resumable_step_3d,
                        make_lm_train_step_3d, shard_params)

__all__ = ["TrainState", "sgd", "adam", "init_train_state",
           "softmax_cross_entropy", "lm_loss", "make_train_step",
           "make_train_epoch", "make_lm_train_epoch", "make_distill_epoch",
           "make_eval_step", "make_lm_train_step_3d", "lm_params_to_3d",
           "lm_params_from_3d", "make_lm_resumable_step_3d",
           "shard_params", "lm_params_tree", "load_lm_params",
           "TrainState3D", "init_lm_state_3d", "gather_params",
           "fit_epochs", "fit_epochs_resumable", "scan_slice_steps",
           "SCAN_SLICE_BYTES"]

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


def _cast_parameters(module: nn.Module):
    """The parameters a compute-dtype cast applies to: all but those of
    the layers that stay f32 (`keeps_f32`, the MoE router)."""
    for m in module.modules():
        if not getattr(m, "keeps_f32", False):
            yield from m.parameters(recurse=False)


def _working_copy(master: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The module the forward runs in: the master itself when its
    parameters are already `dtype`, else a copy with `dtype` parameters
    (but the f32 layers') that shares the master's buffers (running
    statistics stay f32)."""
    if all(p.dtype == dtype for p in _cast_parameters(master)):
        return master
    work = copy.deepcopy(master)
    with torch.no_grad():
        for p in _cast_parameters(work):
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


def _forward(module: nn.Module, x: torch.Tensor):
    """(logits, 0.01 x the MoE load-balance losses, or None for a model
    without MoE blocks): the forward, handed an `aux` list when the model
    has them."""
    if getattr(module, "moe_experts", 0) > 0:
        aux: list = []
        logits, _taps = module(x, aux=aux)
        return logits, 0.01 * torch.stack(aux).sum()
    logits, _taps = module(x)
    return logits, None


def _scale_lr(optimizer: torch.optim.Optimizer, lr_scale: float) -> None:
    """Each parameter group's learning rate at `lr_scale` times its base
    (the rate it had when first scaled, kept in the group as `base_lr`,
    so that it rides a checkpoint with the group)."""
    for group in optimizer.param_groups:
        group["lr"] = group.setdefault("base_lr", group["lr"]) * lr_scale


def make_train_step(num_classes: int,
                    lr_scale: Optional[float] = None) -> Callable:
    """`step(state, images [B, ...], labels [B]) -> (state, metrics)`: the
    forward in train mode (BatchNorm on the batch's statistics, running
    statistics updated), softmax cross-entropy, backward, optimizer step.
    Metrics `loss`, `accuracy` and `grad_norm` are 0-dim tensors; the
    state is updated in place and returned.  With `lr_scale` the step
    runs at that multiple of the optimizer's base learning rate (the
    training guard's back-off: `fit_epochs_resumable`'s `step_factory`
    is `lambda s: make_train_step(n, lr_scale=s)`)."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if lr_scale is not None:
            _scale_lr(state.optimizer, lr_scale)
        logits, aux = _forward(state.work.train(), images)
        loss = softmax_cross_entropy(logits, labels, num_classes)
        if aux is not None:
            loss = loss + aux
        loss.backward()
        grad_norm = state.apply_gradients()
        acc = (logits.detach().argmax(-1) == labels.long()).float().mean()
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "grad_norm": grad_norm}

    return core_telemetry.watch_compiles(step, name="training.train_step")


def make_train_epoch(num_classes: int) -> Callable:
    """`epoch(state, images [S, B, ...], labels [S, B]) -> (state,
    metrics)`: S steps over the stacked minibatches, metrics stacked [S]."""
    step = make_train_step(num_classes)

    def epoch(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        ms = [step(state, images[i], labels[i])[1]
              for i in range(images.shape[0])]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return core_telemetry.watch_compiles(epoch, name="training.train_epoch")


def make_lm_train_epoch() -> Callable:
    """`epoch(state, tokens [S, B, T] int) -> (state, losses [S])`: S
    next-token steps of a TransformerLM (`lm_loss`, plus 0.01x the MoE
    load-balance losses of a model with MoE blocks)."""

    def epoch(state: TrainState, tokens: torch.Tensor):
        losses = []
        for i in range(tokens.shape[0]):
            toks = tokens[i]
            logits, aux = _forward(state.work.train(), toks)
            loss = lm_loss(logits, toks)
            if aux is not None:
                loss = loss + aux
            loss.backward()
            state.apply_gradients(grad_norm=False)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return core_telemetry.watch_compiles(epoch,
                                         name="training.lm_train_epoch")


def make_distill_epoch(teacher, temperature: float = 2.0,
                       alpha: float = 0.7) -> Callable:
    """`epoch(state, tokens [S, B, T] int) -> (state, losses [S])`: S
    knowledge-distillation steps of the student in `state` from
    `teacher`, a TransformerLM `TorchBundle` sharing its vocabulary.

    Loss = alpha * KL(teacher_T || student_T) * T^2 + (1 - alpha) *
    next-token cross-entropy, each the mean over (B, T-1), with T the
    temperature.  The teacher runs in its bundle's dtype on the state's
    device, under `torch.no_grad()`: no teacher gradients, no teacher
    optimizer state.  Its logits [:, :-1] are taken in f32 and
    log-softmaxed at T.  The trained student is the natural draft for
    `generation.speculative_generate` and the speculative batcher."""
    from .generation import _module_for

    t2 = float(temperature) ** 2

    def step(state: TrainState, toks: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            t_logits, _taps = _module_for(teacher, state.device)(toks)
            t_logp = torch.log_softmax(
                t_logits[:, :-1].float() / temperature, dim=-1)
        s_logits, _taps = state.work.train()(toks)
        s32 = s_logits[:, :-1].float()
        s_logp_t = torch.log_softmax(s32 / temperature, dim=-1)
        kl = (t_logp.exp() * (t_logp - s_logp_t)).sum(-1).mean() * t2
        ll = torch.log_softmax(s32, dim=-1).gather(
            -1, toks[:, 1:].long()[..., None])
        loss = alpha * kl + (1.0 - alpha) * -ll.mean()
        loss.backward()
        state.apply_gradients(grad_norm=False)
        return loss.detach()

    def epoch(state: TrainState, tokens: torch.Tensor):
        losses = [step(state, tokens[i]) for i in range(tokens.shape[0])]
        return state, torch.stack(losses)

    return core_telemetry.watch_compiles(epoch,
                                         name="training.distill_epoch")


def make_eval_step() -> Callable:
    """`step(state, images) -> predicted class [B]`, in eval mode (running
    statistics) without gradients."""

    def step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        work = state.work.eval()
        with torch.inference_mode():
            logits, _taps = work(images)
        work.train()
        return logits.argmax(-1)

    return core_telemetry.watch_compiles(step, name="training.eval_step")


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


def _autosave(mgr, state: TrainState, g: int) -> bool:
    """Best-effort checkpoint write: a failed save must not kill a healthy
    run (the previous checkpoint still covers resume) — warn, count
    ``checkpoint.write_failed``, keep training.  An InjectedCrash
    (BaseException) still propagates: that simulates process death, not a
    write error."""
    t0 = time.perf_counter()
    try:
        if g in mgr.all_steps():
            # a rollback replay re-reached a previously saved step: the
            # replayed trajectory (new lr_scale, quarantine skips)
            # supersedes the old bytes
            mgr.delete(g)
        mgr.save(state, step=g)
        core_telemetry.incr("training.autosave")
        return True
    except Exception as e:
        core_telemetry.incr("checkpoint.write_failed")
        warnings.warn(f"checkpoint write failed at step {g}: {e!r}",
                      RuntimeWarning, stacklevel=2)
        return False
    finally:
        # goodput ledger: checkpoint wall is lost training time (a no-op
        # for the pre-training floor checkpoint — the ledger only arms
        # at the first recorded step)
        core_telemetry.LEDGER.note_lost(
            "checkpoint", time.perf_counter() - t0)


def fit_epochs_resumable(
    step_fn: Optional[Callable],
    state: TrainState,
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    checkpoint_dir,
    epochs: int = 1,
    checkpoint_every: int = 50,
    max_to_keep: int = 3,
    seed: int = 0,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    guard=None,
    step_factory: Optional[Callable[[float], Callable]] = None,
    elastic=None,
) -> Tuple[TrainState, Dict[str, float]]:
    """fit_epochs that survives being killed (the JAX package's
    `fit_epochs_resumable` on one card): auto-checkpoints every
    `checkpoint_every` steps through CheckpointManager and, on the next
    call with the same `checkpoint_dir`, resumes from the latest
    *verified* checkpoint — reproducing the uninterrupted run exactly.

    Exactness rests on two invariants:

    * the batch schedule is a pure function of (seed, epoch): each
      epoch's shuffle uses its own ``np.random.default_rng([seed,
      epoch])``, so a resume at any global step regenerates the same
      order without replaying earlier epochs' draws;
    * a restore is bit-exact: every leaf's bytes come back, into the live
      state, and the bf16 working copy is refreshed from the masters
      (models/checkpoint.py), so the restored state continues the
      identical float trajectory on the same device.

    The loop runs per step and crosses `fault_point("training.step")`
    each executed step so chaos tests can kill it mid-epoch; each step's
    batch moves to the device in one `DeviceFeed.put_group`.
    Checkpoints are numbered by **schedule position** (the global batch
    index ``g``), which equals ``state.step`` until a guard quarantine
    skips a batch — resume always continues the schedule, not the
    optimizer count.  The last partial batch of an epoch is dropped.

    With a `models.guard.TrainingGuard` passed as ``guard``, every step's
    (loss, grad_norm) feed the anomaly ladder: a floor checkpoint is
    written before the first step; anomalous batches are quarantined
    (skipped on replay, persisted to ``quarantine.json`` in
    `checkpoint_dir`), the loop rolls back to the newest checkpoint that
    verifies, and the run aborts with `TrainingAborted` once the guard's
    rollback budget is spent.  The port's step updates the state in
    place, so a poisoned step has already written NaN into the masters,
    the optimizer's moments and the running statistics: the rollback
    overwrites all of them.  ``step_factory(lr_scale)`` (optional)
    rebuilds the step after each rollback so the guard's LR back-off
    reaches the optimizer (`make_train_step(n, lr_scale=...)`).  The
    fault points ``training.loss_nan`` / ``training.grad_nan`` poison a
    step's batch (NaN images, where they are floats) / gradient probe.

    Telemetry: ``training.autosave`` per checkpoint written (best-effort:
    a failed write warns and counts ``checkpoint.write_failed``),
    ``training.resume`` when a run starts from a restored step,
    ``training.quarantine.skip`` per skipped batch, the guard's
    ``training.anomaly/quarantine/rollback/abort/hang`` ledger and the
    ``training.guard.rollback`` span; every executed step lands on
    ``core_telemetry.LEDGER`` (compute and the feed's h2d seconds), with
    lost time for checkpoint writes and rollbacks, and one
    ``core_telemetry.STORE.tick()``.

    With a `parallel.distributed.ElasticContext` passed as ``elastic``,
    the loop runs in multi-process mode (every rank runs it, SPMD): every
    step it beats this host's lease and polls for peer loss (lease expiry
    the coordinator's monitor detects, an epoch the coordinator
    published, or an injected ``training.host_lost`` fault), and the step
    runs under a hang budget (``elastic.hang_budget_s``, else the guard's
    ``hang_budget_s()``) so a dead peer's wedged collective raises
    ``CollectiveTimeout`` instead of stalling.  A detected loss runs the
    quarantine -> shrink -> resume ladder: ``guard.host_lost`` ledgers
    the peer into quarantine.json, the membership epoch advances
    (``elastic.commit_loss``), ``elastic.rebuild(view)`` may hand back
    ``(plan, step_fn)`` built over the survivors (its callback starts
    with ``elastic.regroup(view)``, the process group without the lost
    ranks), and the state rolls back to the newest verified checkpoint,
    re-sliced onto the survivors' plan (a `TrainState3D` takes the new
    plan first), after which the schedule replays from the checkpoint
    floor.  In a multi-process job the checkpoint directory is shared:
    rank 0 writes the checkpoints and quarantine.json."""
    from ..io.feed import DeviceFeed
    from ..parallel.distributed import run_with_deadline
    from ..utils.faults import InjectedFault, fault_point
    # lazy: checkpoint.py imports TrainState from this module
    from .checkpoint import CheckpointManager
    from .guard import GuardAction, TrainingAborted

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    n = len(images)
    steps_per_epoch = n // batch_size
    if steps_per_epoch < 1:
        raise ValueError(
            f"dataset has {n} rows < batch_size {batch_size}; lower batch_size")
    if step_fn is None:
        if step_factory is None:
            raise ValueError("need step_fn or step_factory")
        step_fn = step_factory(guard.lr_scale if guard is not None else 1.0)

    mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)
    qpath = os.path.join(os.fspath(checkpoint_dir), "quarantine.json")
    own_guard = guard is not None and not guard.running
    if own_guard:
        guard.start()

    def _persist():
        # one writer for the shared directory of a multi-process job
        if mgr.writer:
            guard.save_quarantine(qpath)

    def _on_corrupt(step, path):
        # corrupt checkpoints walked past get moved aside on disk AND
        # recorded in the guard's persisted ledger — the walk-back and
        # the quarantine must never disagree about which steps are dead
        if guard is not None:
            guard.quarantine_checkpoint(step, path)
            _persist()

    try:
        if guard is not None:
            guard.load_quarantine(qpath)
        latest = mgr.latest_step()
        g = int(state.step)
        if latest is not None and latest > int(state.step):
            try:
                # self-healing resume: newest checkpoint that verifies
                # (corrupt ones are walked past, counting
                # checkpoint.corrupt/fallback, quarantined on disk)
                state, g = mgr.restore_verified(
                    template=state, on_corrupt=_on_corrupt,
                    quarantine=True)
                core_telemetry.incr("training.resume")
            except FileNotFoundError:
                # every checkpoint corrupt: start fresh rather than die
                g = int(state.step)
        g0 = g
        total = epochs * steps_per_epoch
        if guard is not None and total > g and mgr.latest_step() is None:
            # floor checkpoint: the ladder's rollback target must exist
            # before the first anomaly can need it
            _autosave(mgr, state, g)
        feed = DeviceFeed(state.device)
        metrics: Dict[str, float] = {}
        order = None
        order_epoch = -1
        while g < total:
            lost = elastic.poll() if elastic is not None else None
            if lost:
                # the elastic ladder: ledger the dead peers, advance the
                # membership epoch, rebuild the plan over the survivors,
                # roll back to the checkpoint floor, replay
                t_loss0 = time.perf_counter()
                view = elastic.commit_loss(lost)
                if guard is not None:
                    for h in lost:
                        guard.host_lost(h, {"epoch": view.epoch,
                                            "schedule_step": int(g)})
                    _persist()
                rebuilt = elastic.rebuild(view)
                if rebuilt is not None:
                    plan, step_fn = rebuilt
                    if hasattr(state, "plan"):
                        state.plan = plan
                with core_telemetry.span("training.elastic.shrink") as sp:
                    try:
                        state, g = mgr.restore_verified(
                            template=state, on_corrupt=_on_corrupt,
                            quarantine=True)
                    except FileNotFoundError as e:
                        core_telemetry.incr("training.abort")
                        raise TrainingAborted(
                            f"host loss {lost} at schedule step {g} "
                            f"found no verifiable checkpoint: {e}") from e
                    sp.attrs["lost"] = ",".join(lost)
                    sp.attrs["epoch"] = view.epoch
                    sp.attrs["restored_step"] = g
                core_telemetry.incr("training.resume")
                # the whole ladder is the host-loss window the goodput
                # plane attributes (detection -> resume)
                core_telemetry.LEDGER.note_lost(
                    "host_loss", time.perf_counter() - t_loss0)
                continue
            epoch, b = divmod(g, steps_per_epoch)
            if epoch != order_epoch:
                # schedule is (seed, epoch)-pure: resume regenerates it
                order = np.random.default_rng([seed, epoch]).permutation(n)
                order_epoch = epoch
            if guard is not None and g in guard.quarantined:
                # a batch the ladder already condemned: skip on replay
                # (the optimizer count no longer advances for it — that
                # is why checkpoints are numbered by g, not state.step)
                core_telemetry.incr("training.quarantine.skip")
                g += 1
                if g % checkpoint_every == 0:
                    _autosave(mgr, state, g)
                continue
            fault_point("training.step")
            poison_loss = poison_grad = False
            try:
                fault_point("training.loss_nan")
            except InjectedFault:
                poison_loss = True
            try:
                fault_point("training.grad_nan")
            except InjectedFault:
                poison_grad = True
            idx = order[b * batch_size:(b + 1) * batch_size]
            xb, yb = images[idx], labels[idx]
            if poison_loss and np.issubdtype(xb.dtype, np.floating):
                # a genuinely poisoned batch: NaN data -> NaN loss -> NaN
                # grads, end to end through the real step
                xb = np.full_like(xb, np.nan)
            h2d0 = feed.telemetry.snapshot()["transfer_s"]
            dbi, dbl = feed.put_group([xb, yb])
            h2d_s = feed.telemetry.snapshot()["transfer_s"] - h2d0
            t0 = time.perf_counter()
            with core_telemetry.span("training.step"):
                if guard is not None:
                    guard.step_begin(g)
                def _exec(st=state, xi=dbi, yi=dbl):
                    ns, m = step_fn(st, xi, yi)
                    # float() waits for the step's device work, so the
                    # measured wall is the step's cost (collectives
                    # included), not its dispatch
                    return ns, {k: float(v) for k, v in m.items()}

                try:
                    if elastic is not None:
                        # multi-process mode: a dead peer wedges the
                        # collectives — bound every step by a budget
                        budget = elastic.hang_budget_s
                        if budget is None and guard is not None:
                            budget = guard.hang_budget_s()
                        state, metrics = run_with_deadline(
                            _exec, budget, name="training.step")
                    else:
                        state, metrics = _exec()
                finally:
                    if guard is not None:
                        guard.step_end()
            dt = time.perf_counter() - t0
            _observe(dt, 1, batch_size)
            core_telemetry.LEDGER.record_step(int(g), compute_s=dt,
                                              h2d=h2d_s)
            core_telemetry.STORE.tick()
            action = GuardAction.OK
            if guard is not None:
                loss = metrics.get("loss", float("nan"))
                if poison_loss and math.isfinite(loss):
                    # integer-input models can't carry NaN through the
                    # batch; poison the probe itself instead
                    loss = float("nan")
                grad_norm = metrics.get("grad_norm")
                if poison_grad:
                    grad_norm = float("nan")
                action = guard.observe(g, loss, grad_norm)
            if action == GuardAction.ABORT:
                _persist()
                raise TrainingAborted(
                    f"guard exhausted its rollback budget "
                    f"({guard.max_rollbacks}) at schedule step {g}; "
                    f"quarantined={sorted(map(repr, guard.quarantined))}")
            if action == GuardAction.ROLLBACK:
                # persist the verdict BEFORE restoring: a crash here must
                # not forget which batch was poisoned
                t_rb0 = time.perf_counter()
                _persist()
                with core_telemetry.span("training.guard.rollback") as sp:
                    try:
                        # the step ran in place: the live state holds the
                        # poisoned values, all of which the restore
                        # overwrites
                        state, g = mgr.restore_verified(
                            template=state, on_corrupt=_on_corrupt,
                            quarantine=True)
                    except FileNotFoundError as e:
                        core_telemetry.incr("training.abort")
                        raise TrainingAborted(
                            f"rollback at schedule step {g} found no "
                            f"verifiable checkpoint: {e}") from e
                    sp.attrs["restored_step"] = g
                    sp.attrs["lr_scale"] = guard.lr_scale
                if step_factory is not None:
                    step_fn = step_factory(guard.lr_scale)
                core_telemetry.LEDGER.note_lost(
                    "rollback", time.perf_counter() - t_rb0)
                continue
            if log_fn:
                log_fn(int(state.step), metrics)
            g += 1
            if g % checkpoint_every == 0:
                _autosave(mgr, state, g)
        if total > g0 and g % checkpoint_every != 0:
            _autosave(mgr, state, g)  # final state always resumable
        if guard is not None and guard.quarantined:
            _persist()
    finally:
        if own_guard:
            guard.stop()
        mgr.close()
    return state, metrics
