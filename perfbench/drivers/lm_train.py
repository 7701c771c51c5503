"""The lm_train entry: language-model pre-training through the port's
normal path, epoch calls in a closed loop.

Set-up asks the program's registry for the configuration's builder first
(a program without it raises there, before any work on the card), builds
the model on the meta device and lands its seeded draw
(`bundle.DirectInit`; the draw runs on a thread while the corpus is made
and the attention kernels build), makes a `TrainState` (bf16 working
copy over f32 masters, `training.adam`) and `make_lm_train_epoch()`, and
runs one warm call.  The corpus is drawn on the host from the seed:
documents of log-normal length, each ended by the EOS id, their ids Zipf
over the vocabulary ranked by a seeded permutation, packed by
`featurize.tokenizer.pack_sequences(mode="pack")` into `corpus_calls`
calls of [steps, batch, seq_len] int32; a call moves its slice to the
card in one `io.feed.DeviceFeed.put` and runs one epoch, and the calls
cycle through the corpus.  A call's record counts its steps and tokens,
says whether every loss was finite, and gives the program's routing
counters over the call (`models.moe.held_pairs`, `absent_pairs`, and the
largest expert group, `max_expert_pairs`) and the trace id of its epoch's
spans (`epoch_trace`).

What `verify` compares with the plain float32 reference
(`reference/lfm2.py`, the same seed and batches):

* the first STEPS optimizer steps of the warm call: the first gradient's
  norm by leaf and the parameters' change after STEPS steps by leaf
  (`grad_norm_gap`, `change_norm_gap`, as the finetune driver compares
  them; leaves whose reference gradient is under a thousandth of the
  median leaf's are left out of the change).  Not the losses of those
  steps: Adam's first step is lr * sign(g), so bf16 rounding moves them
  as far as an fp8 reference or a planted fault does;
* one more call after the window (made by `release`): the loss and the
  gradient norms by leaf of its first step, against the reference's from
  the f32 masters that step started from, kept on the host
  (`trained_loss_gap`, `trained_grad_gap`).  There the reference takes
  what the program computed that step from: the masters rounded as the
  working copy holds them (bf16 but for the f32 router), and the
  program's expert selection.  At a trained state a leaf's gradient
  moves with the rounding of the weights about as far as the program's
  does from the reference's on the unrounded masters, and a token whose
  experts' scores nearly tie flips with the rounding of the router's
  input, moving its whole expert output and the gradient behind it; a
  reference on the unrounded masters routing on its own measures those,
  not the arithmetic.  The share of the program's (token, slot) pairs
  that the reference's own top-k would have chosen otherwise is logged
  (`route_flips`).  The first STEPS steps start from the unrounded draw
  and route on their own.

Recording wraps `training.lm_loss`, `TrainState.apply_gradients` and
`models.moe.select_experts` and reads what they hold: it copies the
masters to the host twice, keeps the recorded step's selections and
takes a few norms.  `plant(fault)` plants one of FAULTS in the program (the
tests and the calibration's readings use them): the expert bias left
out of the selection, the short convolution centred on its token (it
sees the next one), the q and k RMSNorms skipped, the loss taken over
the first half of each sequence's tokens, the optimizer step leaving
the parameters as they were.
"""
from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.drivers import finetune
from perfbench.harness import data, device, spec
from perfbench.reference.precision import ieee_fp32

CALL = "epoch"
STEPS = 3          # optimizer steps the reference follows from the start
FAULTS = ("bias_ignored", "conv_centred", "qk_norm_skipped", "half_tokens",
          "unchanged")
_MOE = "models.moe."


# the published values the port's lfm2_moe builds in
BUILT_IN = {"conv_bias": False, "use_expert_bias": True,
            "norm_topk_prob": True, "routed_scaling_factor": 1,
            "tie_embedding": True}


def builder_kwargs(cfg: dict) -> dict:
    """The `lfm2_moe` builder's arguments from the configuration."""
    other = {k: cfg[k] for k in BUILT_IN if cfg.get(k, BUILT_IN[k])
             != BUILT_IN[k]}
    if other:
        raise ValueError(f"the port's lfm2_moe builds in {BUILT_IN}, "
                         f"not {other}")
    keys = ("vocab_size", "hidden_size", "layer_types", "num_attention_heads",
            "num_key_value_heads", "intermediate_size",
            "moe_intermediate_size", "num_dense_layers",
            "num_experts_per_tok", "norm_eps", "rope_theta", "conv_L_cache",
            "expert_offset")
    kw = {k: cfg[k] for k in keys}
    kw["num_experts"] = int(cfg["published"]["num_experts"])
    kw["experts_held"] = int(cfg["num_experts"])
    kw["rope_theta"] = float(kw["rope_theta"])
    return kw


def corpus(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """[corpus_calls, steps_per_call, batch_size, seq_len] int32 ids."""
    rng = np.random.default_rng(data.sub_seed(seed, 5))
    s, b = int(mix["seq_len"]), int(mix["batch_size"])
    calls, steps = int(mix["corpus_calls"]), int(mix["steps_per_call"])
    need = calls * steps * b * s
    eos = int(mix["eos_token_id"])
    lengths: List[int] = []
    total = 0
    while total < need:
        n = np.clip(np.rint(rng.lognormal(math.log(mix["document_median_tokens"]),
                                          mix["document_sigma"], 256)),
                    1, mix["document_max_tokens"]).astype(np.int64)
        lengths += n.tolist()
        total += int(n.sum()) + len(n)
    rank = np.arange(1, vocab, dtype=np.float64) ** -float(mix["zipf_exponent"])
    ids = rng.permutation(np.delete(np.arange(vocab, dtype=np.int32), eos))
    flat = ids[rng.choice(vocab - 1, size=sum(lengths), p=rank / rank.sum())]
    cut = np.cumsum(lengths)[:-1]
    rows = [np.append(d, np.int32(eos)) for d in np.split(flat, cut)]
    from mmlspark_tpu_torch.featurize.tokenizer import pack_sequences

    packed = pack_sequences(rows, s, mode="pack")[:calls * steps * b]
    return np.ascontiguousarray(packed.reshape(calls, steps, b, s))


class _Record:
    def __init__(self):
        self.losses: List[torch.Tensor] = []
        self.grad_norms: Dict[str, torch.Tensor] = {}
        self.change_norms: Dict[str, torch.Tensor] = {}
        self.init: Dict[str, torch.Tensor] = {}
        self.masters: Dict[str, torch.Tensor] = {}
        self.routes: List[torch.Tensor] = []  # by expert layer, in order
        self.dtypes: Dict[str, torch.dtype] = {}  # the working copy's


def _grad_norms(module) -> Dict[str, torch.Tensor]:
    return {n: torch.linalg.vector_norm(p.grad, dtype=torch.float32)
            for n, p in module.named_parameters() if p.grad is not None}


def _host_masters(module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in module.named_parameters()}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], n: int = 3
                 ) -> List[Tuple[str, float, float, float]]:
    """(name, gap, program, reference) of the n leaves with the largest
    gaps as `finetune._leaf_gap` takes them (against the larger of the
    leaf's and the median leaf's reference norm)."""
    median = float(np.median(list(ref.values())))
    gaps = [(k, abs(prog.get(k, math.inf) - r) / max(r, median),
             prog.get(k, math.inf), r) for k, r in ref.items()]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def route_flips(routes: Dict[str, torch.Tensor],
                own: Dict[str, torch.Tensor]) -> float:
    """The share of the (token, slot) pairs of `routes` that the `own`
    selections (by layer, as `routes`) do not choose."""
    pairs = other = 0
    for p, given in routes.items():
        mine = own[p].to(given.device)
        hit = (given[:, :, None] == mine[:, None, :]).any(-1)
        pairs += hit.numel()
        other += int((~hit).sum())
    return other / max(pairs, 1)


class Recorder:
    """Wraps the trainer's loss, optimizer step and expert selection: the
    first STEPS steps of the first train state (`first`), and the next
    step after `arm()` (`trained`, with its selections)."""

    def __init__(self):
        from mmlspark_tpu_torch.models import moe, training

        self._training, self._moe = training, moe
        self._loss = training.lm_loss
        self._apply = training.TrainState.apply_gradients
        self._select = moe.select_experts
        self.first: Optional[_Record] = None
        self.trained: Optional[_Record] = None
        self._armed = False
        self._last = None
        self._routes: List[torch.Tensor] = []
        rec = self

        def lm_loss(logits, tokens):
            out = rec._loss(logits, tokens)
            rec._last = out.detach()
            return out

        def select_experts(scores, expert_bias, top_k):
            out = rec._select(scores, expert_bias, top_k)
            if rec._armed:
                rec._routes.append(out.detach().clone())
            return out

        def apply_gradients(state, grad_norm=True):
            if rec._armed:
                rec._armed = False
                rec.trained = r = _Record()
                r.losses = [rec._last]
                r.grad_norms = _grad_norms(state.work)
                r.masters = _host_masters(state.module)
                r.dtypes = {n: p.dtype for n, p in
                            state.work.named_parameters()}
                r.routes, rec._routes = rec._routes, []
            first = rec.first is None and state.step == 0
            if first:
                rec.first = _Record()
                rec.first.init = _host_masters(state.module)
            r = rec.first
            recording = r is not None and bool(r.init) and state.step < STEPS
            if recording:
                r.losses.append(rec._last)
                if state.step == 0:
                    r.grad_norms = _grad_norms(state.work)
            out = rec._apply(state, grad_norm)
            if recording and state.step == STEPS:
                dev = state.device
                r.change_norms = {
                    n: torch.linalg.vector_norm(p.detach() - r.init[n].to(dev))
                    for n, p in state.module.named_parameters()}
                r.init = {}
            return out

        training.lm_loss = lm_loss
        training.TrainState.apply_gradients = apply_gradients
        moe.select_experts = select_experts

    def arm(self) -> None:
        self._routes = []
        self._armed = True

    def close(self) -> None:
        self._training.lm_loss = self._loss
        self._training.TrainState.apply_gradients = self._apply
        self._moe.select_experts = self._select


class LmTrainCell:
    def __init__(self, ctx):
        from mmlspark_tpu_torch.models.bundle import DirectInit, get_builder

        cfg, mix = ctx.config, ctx.mix
        get_builder(cfg["port"]["builder"])  # raises at once without it
        from mmlspark_tpu_torch.io.feed import DeviceFeed
        from mmlspark_tpu_torch.models import training

        self.ctx = ctx
        self.family = spec.family_module(cfg)
        self.device = torch.device(ctx.device)
        cuda = self.device.type == "cuda"
        self.kwargs = builder_kwargs(cfg)
        direct = DirectInit.build(cfg["port"]["builder"], self.kwargs,
                                  self.device)
        if direct is None:
            raise RuntimeError("the model's init walk misses a tensor")
        self.init_path = "direct"
        with ThreadPoolExecutor(1) as pool:
            draw = pool.submit(direct.draw, ctx.seed, cuda)
            self.corpus = corpus(mix, int(cfg["vocab_size"]), ctx.seed)
            if cuda:
                from mmlspark_tpu_torch.ops import _build

                _build.build(["flash_attention_fwd", "flash_attention_bwd"])
            direct.land(draw.result())
        self.state = training.TrainState.create(
            direct.module, training.adam(float(mix["learning_rate"])),
            compute_dtype=cfg["dtype"], device=self.device)
        self.epoch = training.make_lm_train_epoch()
        self.feed = DeviceFeed(self.device)
        self.recorder = Recorder()
        self.calls = 0
        self.trained_call: Optional[int] = None
        if ctx.trace:
            from mmlspark_tpu_torch.core.telemetry.device import (
                enable_device_annotations)

            enable_device_annotations()
        self.call()

    def _moe(self) -> Dict[str, int]:
        from mmlspark_tpu_torch.core import telemetry

        got = telemetry.counters(_MOE)
        return {k: int(got.get(_MOE + k, 0))
                for k in ("held_pairs", "absent_pairs")}

    def call(self) -> Dict[str, object]:
        from mmlspark_tpu_torch.core import telemetry

        mix = self.ctx.mix
        before = self._moe()
        largest = telemetry.gauge(_MOE + "max_expert_pairs")
        largest.set(0)
        batch = self.feed.put(self.corpus[self.calls % len(self.corpus)])
        self.calls += 1
        self.state, losses = self.epoch(self.state, batch)
        finite = bool(np.isfinite(losses.tolist()).all())
        after = self._moe()
        steps, b = int(mix["steps_per_call"]), int(mix["batch_size"])
        epoch = next((s for s in reversed(telemetry.recent_spans())
                      if s["name"] == "training.lm_epoch"), None)
        rec = {"rows": steps * b, "steps": steps,
               "tokens": steps * b * int(mix["seq_len"]), "ok": finite,
               "max_expert_pairs": int(largest.value),
               "epoch_trace": epoch["trace_id"] if epoch else None}
        rec.update({k: after[k] - before[k] for k in after})
        return rec

    def counters(self) -> Dict[str, object]:
        return self._moe()

    def release(self) -> None:
        """One more call, recorded (the trained-state check), then the
        program's state is let go."""
        self.trained_call = self.calls % len(self.corpus)
        self.recorder.arm()
        self.call()
        self.recorder.close()
        self.state = self.epoch = self.feed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------
    def _batch(self, call: int, step: int) -> torch.Tensor:
        return torch.from_numpy(self.corpus[call, step]).to(self.device)

    def _on_device(self, w: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, dtype=torch.float32, copy=True)
                for k, v in w.items()}

    def reference_steps(self, w0: Dict[str, torch.Tensor], quant=None
                        ) -> Tuple[List[float], Dict[str, float],
                                   Dict[str, float]]:
        """(losses, first-gradient norms, change norms after STEPS steps)
        of the reference from the initial weights `w0` (host)."""
        w, opt, losses, g1 = self._on_device(w0), {}, [], None
        lr = float(self.ctx.mix["learning_rate"])
        for step in range(STEPS):
            loss, grads, _pairs = self.family.loss_and_grads(
                w, self._batch(0, step), self.ctx.config, quant,
                checkpoint=True)
            losses.append(loss)
            if g1 is None:
                g1 = {k: float(g.norm()) for k, g in grads.items()}
            self.family.adam_step(w, opt, grads, lr)
            del grads
        del opt
        change = {k: float((w[k] - w0[k].to(self.device)).norm())
                  for k in g1}
        return losses, g1, change

    def _expert_layers(self) -> List[str]:
        cfg = self.ctx.config
        return [f"layers.{i}.feed_forward."
                for i in range(int(cfg["num_dense_layers"]),
                               len(cfg["layer_types"]))]

    def reference_trained(self, quant=None, routes=None, chosen=None,
                          rounded=False) -> Tuple[float, Dict[str, float]]:
        """(loss, gradient norms) of the reference at the trained call's
        first step, from the masters that step started from (`rounded`:
        each to its working copy's dtype, as the program computed with
        them); its expert layers take `routes` when given, and put their
        own selections in `chosen` when given."""
        r = self.recorder.trained
        w = self._on_device({k: v.to(r.dtypes.get(k, v.dtype)) if rounded
                             else v for k, v in r.masters.items()})
        w.update(self._on_device(self._bias))
        loss, grads, _pairs = self.family.loss_and_grads(
            w, self._batch(self.trained_call, 0), self.ctx.config, quant,
            checkpoint=True, routes=routes, chosen=chosen)
        return loss, {k: float(g.norm()) for k, g in grads.items()}

    def verify(self, control=None) -> List[Tuple[str, float, float]]:
        """The numbers compared; with `control` (a rounding function) the
        reference computed at that precision takes the program's place."""
        cfg, limits = self.ctx.config, self.ctx.limits
        first, trained = self.recorder.first, self.recorder.trained
        w0 = self.family.init_weights(cfg, self.ctx.seed)
        self._bias = {k: v for k, v in w0.items()
                      if k.endswith("expert_bias")}
        routes, own = None, {}
        if trained is not None and trained.routes:
            routes = dict(zip(self._expert_layers(), trained.routes))
        with ieee_fp32():
            if control is not None:
                first, trained, routes = _Record(), _Record(), {}
                losses, g1, change = self.reference_steps(w0, control)
                first.losses = [torch.tensor(x) for x in losses]
                first.grad_norms = {k: torch.tensor(v) for k, v in g1.items()}
                first.change_norms = {k: torch.tensor(v)
                                      for k, v in change.items()}
                tl, tg = self.reference_trained(control, chosen=routes)
                trained.losses = [torch.tensor(tl)]
                trained.grad_norms = {k: torch.tensor(v)
                                      for k, v in tg.items()}
            losses, g1, change = self.reference_steps(w0)
            del w0
            tl, tg = self.reference_trained(routes=routes or None,
                                            chosen=own,
                                            rounded=control is None)
        if routes:
            self.route_flips = route_flips(routes, own)
            device.log(f"trained step: {self.route_flips:.6f} of the "
                       "pairs chosen otherwise by the reference's own top-k")
        self.left_out = finetune.round_off_leaves(g1)
        checks = finetune.compare([first] if first else [], losses, g1,
                                  change, dict(limits, loss_gap=math.inf))
        checks = [c for c in checks if c[0] != "loss_gap"]
        if trained is None:
            gaps = (float("inf"), float("inf"))
        else:
            prog = {k: float(v) for k, v in trained.grad_norms.items()}
            gaps = (abs(float(trained.losses[0]) - tl) / abs(tl),
                    finetune._leaf_gap(prog, tg))
            device.log("trained step, worst leaves (gap, program, "
                       "reference): " + "; ".join(
                           f"{k} {g:.4g} {a:.4g} {b:.4g}"
                           for k, g, a, b in worst_leaves(prog, tg)))
        return checks + [
            ("trained_loss_gap", gaps[0], float(limits["trained_loss_gap"])),
            ("trained_grad_gap", gaps[1], float(limits["trained_grad_gap"]))]


# -- planted faults -------------------------------------------------------
def _patch(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def _bias_ignored():
    from mmlspark_tpu_torch.models import moe

    return _patch(moe, "select_experts", lambda scores, _bias, k:
                  torch.topk(scores, k, dim=-1).indices)


def _conv_centred():
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models import lfm2

    def centred(u, weight):
        L = weight.shape[-1]
        v = F.conv1d(F.pad(u.transpose(1, 2), (L // 2, L - 1 - L // 2)),
                     weight, groups=u.shape[-1])
        return v.transpose(1, 2)

    return _patch(lfm2, "short_conv", centred)


def _qk_norm_skipped():
    from mmlspark_tpu_torch.models import lfm2

    return _patch(lfm2, "qk_norm", lambda _attn, q, k: (q, k))


def _half_tokens():
    from mmlspark_tpu_torch.models import training

    loss = training.lm_loss

    def half(logits, tokens):
        h = tokens.shape[1] // 2
        return loss(logits[:, :h], tokens[:, :h])

    return _patch(training, "lm_loss", half)


def _unchanged():
    step = torch.optim.Adam.step

    def kept(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out

    return _patch(torch.optim.Adam, "step", kept)


_PLANT = {"bias_ignored": _bias_ignored, "conv_centred": _conv_centred,
          "qk_norm_skipped": _qk_norm_skipped, "half_tokens": _half_tokens,
          "unchanged": _unchanged}


@contextlib.contextmanager
def plant(fault: str):
    undo = _PLANT[fault]()
    try:
        yield
    finally:
        undo()


def setup(ctx) -> LmTrainCell:
    return LmTrainCell(ctx)
