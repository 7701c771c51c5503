"""The port's draft distillation (mmlspark_tpu_torch.models.training
`make_distill_epoch`) held against the JAX package's on bridged weights
and the same numpy tokens, and the draft it trains in speculative
decoding.

Two distillation steps of a 1-layer student from a 2-layer f32 teacher
(Adam 1e-3): the losses within rtol 1e-4 / atol 1e-5 and the student's
parameters within 5e-5 abs, the tolerances tests/test_torch_training.py
holds the LM trainer to.  The teacher gets no gradient and no optimizer
state.  Then the lifecycle of tests/test_generation.py:369 on the port
alone: a teacher trained on a counting stream, a student distilled from
it, and speculative decoding that stays exact and takes fewer rounds
with the distilled draft than with the untrained one.
"""
import functools

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import training as JT
from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch.models import generation as G
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.bundle import TorchBundle, from_flax_variables

from torch_port_util import random_transformer_params, to_dicts

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)   # test_torch_training.py's
ADAM_ATOL = 5e-5                        # test_torch_training.py's
TEACHER = dict(vocab_size=64, embed_dim=64, num_heads=2, num_layers=2,
               max_len=32)
STUDENT = dict(TEACHER, num_layers=1)


@functools.lru_cache(maxsize=None)
def _case():
    tokens = np.random.default_rng(1).integers(
        0, TEACHER["vocab_size"], (2, 3, 24)).astype(np.int32)
    teacher = T.transformer_lm(dtype=jnp.float32, **TEACHER)
    student = T.transformer_lm(dtype=jnp.float32, **STUDENT)
    t_vars = random_transformer_params(teacher, jnp.asarray(tokens[0]),
                                       seed=2)
    s_vars = random_transformer_params(student, jnp.asarray(tokens[0]),
                                       seed=3)
    opt = optax.adam(1e-3)
    epoch = JT.make_distill_epoch(
        teacher, t_vars, student, opt,
        mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    params, _opt, losses = epoch(s_vars["params"],
                                 opt.init(s_vars["params"]),
                                 jnp.asarray(tokens))
    final = from_flax_variables(
        "transformer_lm",
        {"params": to_dicts(jax.tree.map(np.asarray, params))}, STUDENT,
        dtype="float32").state_dict
    return tokens, t_vars, s_vars, np.asarray(losses), final


def test_two_distill_steps_match_jax():
    tokens, t_vars, s_vars, ref_losses, ref_final = _case()
    teacher = from_flax_variables("transformer_lm", t_vars, TEACHER,
                                  dtype="float32")
    student = from_flax_variables("transformer_lm", s_vars, STUDENT,
                                  dtype="float32")
    state = PT.TrainState.create(student.module(torch.device("cpu")),
                                 PT.adam(1e-3), device="cpu")
    state, losses = PT.make_distill_epoch(teacher)(state,
                                                   torch.from_numpy(tokens))
    assert state.step == 2 and losses.shape == (2,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, **LOSS_TOL)
    got = {k: v.detach().numpy() for k, v in state.module.state_dict().items()}
    assert sorted(got) == sorted(ref_final)
    for k, ref in ref_final.items():
        np.testing.assert_allclose(got[k], ref, atol=ADAM_ATOL, rtol=0,
                                   err_msg=k)
    # no teacher gradients: its module's parameters hold none
    t_module = G._module_for(teacher, torch.device("cpu"))
    assert all(p.grad is None for p in t_module.parameters())
    assert len(state.optimizer.param_groups[0]["params"]) == len(got)


def test_distill_loss_is_the_temperature_kl_and_ce_mix():
    """alpha = 1 leaves the KL alone; a student equal to its teacher has
    zero KL, so the loss is 0; alpha = 0 is the plain cross-entropy."""
    tokens, t_vars, _s, _l, _f = _case()
    teacher = from_flax_variables("transformer_lm", t_vars, TEACHER,
                                  dtype="float32")
    toks = torch.from_numpy(tokens[:1])
    for alpha in (1.0, 0.0):
        state = PT.TrainState.create(teacher.module(torch.device("cpu")),
                                     PT.sgd(0.0), device="cpu")
        _state, losses = PT.make_distill_epoch(teacher, alpha=alpha)(state,
                                                                     toks)
        if alpha == 1.0:
            assert abs(float(losses[0])) < 1e-5
        else:
            with torch.no_grad():
                ce = PT.lm_loss(state.module(toks[0])[0], toks[0])
            np.testing.assert_allclose(float(losses[0]), float(ce),
                                       rtol=1e-6)


def test_distilled_draft_speeds_up_speculation():
    """A 2-layer teacher trained on a counting stream, a 1-layer student
    distilled from it: speculative decoding is exact with either draft
    and takes fewer rounds with the distilled one."""
    kw = dict(vocab_size=32, embed_dim=32, num_heads=2, max_len=32)
    base = (np.arange(8 * 8).reshape(8, 8, 1)
            + np.arange(16)[None, None, :]) % 32
    toks = torch.from_numpy(base.astype(np.int32))
    t_state = PT.init_train_state(
        T_builder(kw, 2), PT.adam(5e-3), seed=0, device="cpu")
    epoch = PT.make_lm_train_epoch()
    for _ in range(12):
        t_state, _losses = epoch(t_state, toks)
    teacher = TorchBundle.from_module("transformer_lm", t_state.module,
                                      dict(kw, num_layers=2),
                                      dtype="float32")
    s_state = PT.init_train_state(T_builder(kw, 1), PT.adam(5e-3), seed=7,
                                  device="cpu")
    raw = TorchBundle.from_module("transformer_lm", s_state.module,
                                  dict(kw, num_layers=1), dtype="float32")
    d_epoch = PT.make_distill_epoch(teacher)
    s_state, first = d_epoch(s_state, toks)
    for _ in range(11):
        s_state, last = d_epoch(s_state, toks)
    assert float(last[-1]) < float(first[0])
    distilled = TorchBundle.from_module("transformer_lm", s_state.module,
                                        dict(kw, num_layers=1),
                                        dtype="float32")
    prompt = np.array([[4, 5, 6, 7]], np.int32)
    want = G.generate(teacher, prompt, 10, device="cpu")
    rounds = {}
    for name, draft in (("raw", raw), ("distilled", distilled)):
        got, rounds[name] = G.speculative_generate(
            teacher, draft, prompt, 10, gamma=4, return_stats=True,
            device="cpu")
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert rounds["distilled"] < rounds["raw"], rounds


def T_builder(kw, layers):
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    return transformer_lm(num_layers=layers, **kw)
