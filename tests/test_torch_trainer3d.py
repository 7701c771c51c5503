"""The port's 3D trainer (mmlspark_tpu_torch/models/trainer3d.py, through
models/training.py) against the JAX package's `make_lm_train_step_3d`.

The port runs one gloo process a rank (tests/torch_dist_worker.py, 4
ranks spawned once for this module); the JAX package runs its GSPMD
step on 4 of the suite's virtual CPU devices, on the same plan, from the
same weights (bridged through the flax tree) and tokens.  Held as
tests/test_trainer3d.py holds the JAX step against its single-device
reference: the loss within 1e-4 at each of two SGD-0.1 steps and every
parameter within atol 1e-4 after them, on the plans (2,2,1), (2,1,2)
and (1,2,2).  Also: the flat <-> 3D round trip is exact (and equals the
JAX package's layout leaf for leaf), the GPipe schedule equals the
stages applied one after the other (forward and gradients), remat
changes no number, and format-2 checkpoints — one crc32 a shard, the
rejection naming a tampered shard, a flipped byte quarantined and the
prior step resumed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.models import training as JT
from mmlspark_tpu.models.transformer import transformer_lm as jax_lm
from mmlspark_tpu.parallel.mesh import MeshPlan as JMeshPlan
from mmlspark_tpu.parallel.sharding_rules import lm_3d_rules as jax_rules
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.parallel.pipeline import (gpipe_spmd_apply,
                                                  stack_stage_params)
from mmlspark_tpu_torch.parallel.sharding_rules import tree_leaves_with_path

from torch_dist_worker import run_ranks

V, E, L, H, S = 256, 32, 4, 4, 16
CFG = dict(vocab_size=V, embed_dim=E, num_layers=L, num_heads=H, max_len=S)
PLANS = [(2, 2, 1), (2, 1, 2), (1, 2, 2)]
MOE_CFG = dict(CFG, moe_experts=2, moe_capacity=2.0)
TOL = 1e-4  # tests/test_trainer3d.py's loss and parameter tolerance


@functools.lru_cache(maxsize=None)
def _jax_init():
    model = jax_lm(**CFG, dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16, S), 0, V,
                              jnp.int32)
    params = model.init(jax.random.PRNGKey(0), toks[0, :2])["params"]
    return model, jax.device_get(params), np.asarray(toks)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


@functools.lru_cache(maxsize=None)
def _jax_run(plan_shape):
    """Two SGD-0.1 steps of the JAX 3D step on 4 virtual devices."""
    model, params, toks = _jax_init()
    opt = optax.sgd(0.1)
    plan = JMeshPlan(*plan_shape, devices=jax.devices()[:4])
    p3 = JT.shard_params(JT.lm_params_to_3d(params, L, plan.pipe),
                         plan.mesh, jax_rules())
    o3 = opt.init(p3)
    step = JT.make_lm_train_step_3d(model, opt, plan, remat=True,
                                    donate=False)
    metrics = []
    for i in range(2):
        p3, o3, m = step(p3, o3, jnp.asarray(toks[i].reshape(2, 2, 4, S)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    back = JT.lm_params_from_3d(jax.device_get(p3), L)
    return metrics, _np_tree(back)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _model, params, toks = _jax_init()
    rng = np.random.default_rng(0)
    p, m, mb, d = 4, 6, 2, 8
    per_stage = [{"w": torch.from_numpy(rng.normal(size=(d, d)) * 0.3).float(),
                  "b": torch.from_numpy(rng.normal(size=(d,)) * 0.1).float()}
                 for _ in range(p)]
    from mmlspark_tpu_torch.models.bundle import init_state_dict
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    moe_lm = transformer_lm(**MOE_CFG)
    init_state_dict(moe_lm, 5)
    moe_toks = torch.from_numpy(rng.integers(0, V, (2, 8, S)))
    inputs = {
        "moe": {"cfg": MOE_CFG, "params": PT.lm_params_tree(moe_lm),
                "tokens": [t.reshape(2, 2, 2, S) for t in moe_toks],
                "flat_tokens": moe_toks},
        "cfg": CFG, "plans": PLANS,
        "params": _torch_tree(_np_tree(params)),
        "tokens": [torch.tensor(toks[i].reshape(2, 2, 4, S)).long()
                   for i in range(2)],
        "gpipe": {"stacked": stack_stage_params(per_stage),
                  "x": torch.from_numpy(rng.normal(size=(m, mb, d))).float(),
                  "per_stage": per_stage},
    }
    return inputs, run_ranks("trainer3d", inputs,
                             tmp_path_factory.mktemp("trainer3d"))


def test_lm_params_3d_roundtrip_is_exact():
    """The port's flax-layout tree of a bridged LM is the JAX params bit
    for bit, its 3D layout is the JAX package's leaf for leaf, and the
    3D -> flat inverse is exact."""
    _model, params, _toks = _jax_init()
    bundle = from_flax_variables("transformer_lm",
                                 {"params": _np_tree(params)},
                                 builder_kwargs=CFG, dtype="float32")
    tree = PT.lm_params_tree(bundle.module("cpu"))
    want = _flat(_np_tree(params))
    got = _flat(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    p3 = PT.lm_params_to_3d(tree, L, pipe=2)
    stacked = [a for _p, a in tree_leaves_with_path(p3["blocks"])]
    assert all(tuple(a.shape[:2]) == (2, L // 2) for a in stacked)
    j3 = _flat(_np_tree(JT.lm_params_to_3d(params, L, 2)))
    for k, v in _flat(p3).items():
        np.testing.assert_array_equal(v, j3[k])
    back = _flat(PT.lm_params_from_3d(p3, L))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_lm_params_to_3d_rejects_indivisible_layers():
    _model, params, _toks = _jax_init()
    with pytest.raises(ValueError, match="divisible"):
        PT.lm_params_to_3d(_torch_tree(_np_tree(params)), L, pipe=3)


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "x".join(map(str, p)))
def test_3d_step_matches_jax_3d_step(ranks, plan):
    """Two SGD-0.1 steps: the second consumes the first's updated
    weights, so a wrong gradient anywhere compounds."""
    jax_metrics, jax_params = _jax_run(plan)
    _inputs, results = ranks
    got = [r[("plan", plan)] for r in results]
    for r in got:  # every rank reports the same step
        for (loss, norm), (jloss, jnorm) in zip(r["losses"], jax_metrics):
            assert abs(loss - jloss) < TOL
            assert abs(norm - jnorm) < TOL * max(1.0, jnorm)
    want = _flat(jax_params)
    params = _flat(got[0]["params"])
    assert sorted(params) == sorted(want)
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=TOL, err_msg=k)


def test_moe_3d_step_matches_the_single_device_step(ranks):
    """An MoE LM on (1, 2, 2): each model rank runs its expert of two on
    the routed tokens.  As in the JAX package the 3D step folds in no
    load-balance loss, so the reference is the port's plain next-token
    step (a forward without the aux list) over the same 8 rows, SGD 0.1,
    two steps: loss within 1e-4, parameters atol 1e-4."""
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    inputs, results = ranks
    moe = inputs["moe"]
    model = PT.load_lm_params(transformer_lm(**MOE_CFG), moe["params"])
    ref = PT.TrainState.create(model, PT.sgd(0.1), device="cpu")
    losses = []
    for toks in moe["flat_tokens"]:
        logits, _taps = ref.work(toks)
        loss = PT.lm_loss(logits, toks)
        loss.backward()
        ref.apply_gradients()
        losses.append(float(loss.detach()))
    want = _flat(PT.lm_params_tree(ref.module))
    for r in results:
        assert np.allclose(r["moe"]["losses"], losses, atol=TOL, rtol=0)
        got = _flat(r["moe"]["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)


def test_remat_changes_no_number(ranks):
    """Checkpointing each block with the dots-saveable policy recomputes
    the rest in the backward: losses, norms and parameters are the same
    bits as without it (the card run measures the memory it saves)."""
    _inputs, results = ranks
    for r in results:
        on, off = r[("plan", PLANS[0])], r["no_remat"]
        assert on["losses"] == off["losses"]
        a, b = _flat(on["params"]), _flat(off["params"])
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_gpipe_matches_sequential(ranks):
    """4 stages, one a rank, 6 microbatches: the schedule's output on
    every rank equals the stages applied in order; its gradients (of the
    output's squared sum, summed over the ranks' use) equal those of the
    sequential composition; a stage count that is not the axis size is
    refused."""
    inputs, results = ranks
    g = inputs["gpipe"]

    def stage(p, x):
        return torch.tanh(x @ p["w"]) + p["b"]

    x = g["x"].clone().requires_grad_()
    ws = [{k: v.clone().requires_grad_() for k, v in sp.items()}
          for sp in g["per_stage"]]
    ys = []
    for i in range(x.shape[0]):
        h = x[i]
        for sp in ws:
            h = stage(sp, h)
        ys.append(h)
    want = torch.stack(ys)
    (4 * want.square().sum()).backward()  # each of 4 ranks used it
    for r, res in enumerate(results):
        torch.testing.assert_close(res["gpipe"], want.detach(), rtol=1e-5,
                                   atol=1e-5)
        assert "stage" in res["gpipe_mismatch"]
        grads = res["gpipe_grads"]
        torch.testing.assert_close(grads["w"][r], ws[r]["w"].grad,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grads["b"][r], ws[r]["b"].grad,
                                   rtol=1e-5, atol=1e-5)
    gx = sum(res["gpipe_grads"]["x"] for res in results)
    torch.testing.assert_close(gx, x.grad, rtol=1e-5, atol=1e-5)


def test_gpipe_without_a_mesh_runs_every_stage_here():
    rng = np.random.default_rng(0)
    per_stage = [{"w": torch.from_numpy(rng.normal(size=(8, 8)) * 0.3).float(),
                  "b": torch.from_numpy(rng.normal(size=(8,)) * 0.1).float()}
                 for _ in range(4)]
    x = torch.from_numpy(rng.normal(size=(6, 2, 8))).float()

    def stage(p, h):
        return torch.tanh(h @ p["w"]) + p["b"]

    got = gpipe_spmd_apply(stage, stack_stage_params(per_stage), x)
    want = x
    for sp in per_stage:
        want = torch.stack([stage(sp, b) for b in want])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="leading dims differ"):
        gpipe_spmd_apply(stage, {"w": torch.zeros(4, 8, 8),
                                 "b": torch.zeros(3, 8)}, x)


def test_manifest_records_per_shard_crc32_for_sharded_leaves(ranks):
    _inputs, results = ranks
    doc = results[0]["manifest"]
    assert doc["format"] == 2
    sharded = {k: v for k, v in doc["leaves"].items() if "shards" in v}
    assert sharded, "no per-shard entries for a sharded save"
    entry = sharded["module/blocks.qkv.kernel"]
    assert "pipe" in entry["spec"] and "model" in entry["spec"]
    # pipe x tensor sharding: 4 distinct shards, disjoint bounds
    assert len(entry["shards"]) == 4
    assert len({tuple(map(tuple, s["index"])) for s in entry["shards"]}) == 4
    # replicated leaves carry no shard table
    assert "shards" not in doc["leaves"][
        "module/embed.tok_embed.embedding"]
    # the optimizer's per-parameter tensors follow their parameter
    assert all(r["manifest"] == doc for r in results)


def test_tampered_shard_crc_names_the_failing_shard(ranks):
    _inputs, results = ranks
    msg = results[0]["tamper"]
    assert msg is not None and "shard=2" in msg
    assert "module/blocks.proj.kernel" in msg


@pytest.mark.chaos
def test_flipped_shard_byte_rejects_quarantines_and_resumes_prior(ranks):
    """A flipped byte in one shard of step 2: every rank's
    restore_verified rejects the step, rank 0 moves it aside, the guard
    ledgers it, and every rank resumes step 1 — its own chunks equal to
    the saved ones, the working copy refreshed."""
    _inputs, results = ranks
    for r in results:
        res = r["resume"]
        assert res["step"] == 1 and res["state_step"] == 0
        assert res["equal"] and res["work_equal"]
        assert res["ledger"] and res["ledger"][0][0] == 2
    assert results[0]["resume"]["quarantined"]
