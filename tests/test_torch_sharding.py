"""The port's rule tables, meshes and topology (mmlspark_tpu_torch/parallel/
sharding_rules.py, parallel/mesh.py, utils/cluster.py) against the JAX
package's: the counterparts of tests/test_sharding_rules.py and
tests/test_cluster_topology.py, and the parity that matters for the 3D
trainer — every parameter of the port's TransformerLM (MHA, GQA and MoE)
gets from each table the spec the JAX leaf it bridges from gets.

What needs ranks runs on 4 gloo processes (tests/torch_dist_worker.py,
spawned once for this module).  In SPMD each rank is its own process,
so the topology counts 4 hosts where the single-process JAX suite counts
1, and every rank owns one mesh coordinate.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mmlspark_tpu.models import training as JT
from mmlspark_tpu.models.transformer import transformer_lm as jax_lm
from mmlspark_tpu.parallel import sharding_rules as JR
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.trainer3d import _flax_paths, lm_param_specs
from mmlspark_tpu_torch.parallel import sharding_rules as R
from mmlspark_tpu_torch.parallel.mesh import (MESH_AXIS_NAMES, MeshPlan,
                                              make_mesh)
from mmlspark_tpu_torch.parallel.sharding_rules import (
    P, head_only_rules, head_rules, lm_3d_rules, lm_tensor_parallel_rules,
    lm_tensor_rules, match_partition_rules, moe_expert_rules, path_name,
    spec_for, validate_coverage, validate_rules)
from mmlspark_tpu_torch.utils.cluster import (DeviceInfo, DeviceTopology,
                                              cluster_info)

from torch_dist_worker import run_ranks

LM = dict(vocab_size=64, embed_dim=16, num_layers=2, num_heads=4,
          max_len=16)


def _jax_params(**kw):
    model = jax_lm(**LM, dtype=jnp.float32, **kw)
    toks = jnp.zeros((1, 8), jnp.int32)
    return jax.device_get(model.init(jax.random.PRNGKey(0), toks)["params"])


def _port_module(params, **kw):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return from_flax_variables("transformer_lm", {"params": tree},
                               builder_kwargs=dict(LM, **kw),
                               dtype="float32").module("cpu")


def _named(rules, tree):
    specs = match_partition_rules(rules, tree)
    return {path_name(p): s for p, s in R.tree_leaves_with_path(specs)}


def _jax_named(rules, tree):
    specs = JR.match_partition_rules(rules, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    return {JR.path_name(p): s for p, s in flat}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("mesh", {}, tmp_path_factory.mktemp("mesh"))


# ------------------------------------------------------------ matcher

def test_first_match_wins_ordering():
    rules = ((r"kernel$", P(None, "model")), (r".*", P()))
    assert spec_for(rules, "block0/qkv/kernel") == P(None, "model")
    rules = ((r".*", P()), (r"kernel$", P(None, "model")))
    assert spec_for(rules, "block0/qkv/kernel") == P()


def test_scalar_and_size1_leaves_replicate_unconditionally():
    rules = ((r".*", P(None, "model")),)
    assert spec_for(rules, "x", torch.tensor(3.0)) == P()
    assert spec_for(rules, "x", torch.ones(1, 1)) == P()
    assert spec_for(rules, "x", torch.ones(2, 2)) == P(None, "model")


def test_unmatched_leaf_raises_instead_of_silently_replicating():
    with pytest.raises(ValueError, match="no partition rule matched"):
        spec_for(((r"^only/this$", P()),), "something/else")


def test_match_partition_rules_uses_joined_path_names():
    tree = {"block0": {"qkv": {"kernel": torch.ones(4, 12)}},
            "ln": {"scale": torch.ones(4)}}
    specs = _named(lm_tensor_rules(), tree)
    assert specs["block0/qkv/kernel"] == P(None, "model")
    assert specs["ln/scale"] == P()
    # the same table gives the JAX package's specs
    jspecs = _jax_named(JR.lm_tensor_rules(),
                        jax.tree.map(np.asarray, {
                            "block0": {"qkv": {"kernel": np.ones((4, 12))}},
                            "ln": {"scale": np.ones((4,))}}))
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jspecs.items()}


def test_validate_rules_rejects_undeclared_axis():
    validate_rules(lm_tensor_rules(), MESH_AXIS_NAMES)
    with pytest.raises(ValueError, match="modle"):
        validate_rules(((r".*", P(None, "modle")),), MESH_AXIS_NAMES)
    with pytest.raises(ValueError, match="oops"):
        validate_rules(((r".*", P(("data", "oops"))),), MESH_AXIS_NAMES)
    for rules in (lm_tensor_rules(), moe_expert_rules(), head_only_rules(),
                  lm_3d_rules()):
        validate_coverage(rules)


def test_tables_are_the_jax_packages_row_for_row():
    for name in ("lm_tensor_rules", "moe_expert_rules", "head_only_rules",
                 "lm_3d_rules"):
        port, jax_t = getattr(R, name)(), getattr(JR, name)()
        assert [(p, tuple(s)) for p, s in port] == \
            [(p, tuple(s)) for p, s in jax_t], name
    assert R.PARAM_PATH_MANIFEST == JR.PARAM_PATH_MANIFEST
    assert MESH_AXIS_NAMES == ("data", "model", "seq", "pipe")
    assert str(P(None, "model")) == str(JP(None, "model"))


def test_shard_and_gather_fns_roundtrip(ranks):
    """On a (data 2, model 2) mesh the qkv kernel [4, 12] keeps [4, 6] a
    rank, and gathering it back gives the host tensor exactly."""
    for r in ranks:
        assert r["qkv_local"] == (4, 6)
        assert r["roundtrip"]


# --------------------------------------- coverage: real model trees

@pytest.mark.parametrize("kw,rules", [
    ({}, "lm_tensor_rules"), ({"num_kv_heads": 2}, "lm_tensor_rules"),
    ({"moe_experts": 2}, "moe_expert_rules"), ({}, "head_only_rules"),
    ({"moe_experts": 2}, "lm_tensor_rules")],
    ids=["mha", "gqa", "moe", "head", "moe-tensor"])
def test_every_port_parameter_gets_its_jax_leafs_spec(kw, rules):
    """Each parameter of the port's TransformerLM, named by the flax path
    from_flax_variables maps it from, gets the spec the JAX leaf gets."""
    params = _jax_params(**kw)
    module = _port_module(params, **kw)
    got = lm_param_specs(module, getattr(R, rules)())
    paths = {n: p for n, (p, _tr) in _flax_paths(module).items()}
    want = _jax_named(getattr(JR, rules)(), params)
    assert sorted(paths.values()) == sorted(want)
    for name, spec in got.items():
        assert tuple(spec) == tuple(want[paths[name]]), name


def test_mha_tree_every_2d_block_kernel_gets_intended_spec():
    tree = PT.lm_params_tree(_port_module(_jax_params()))
    specs = _named(lm_tensor_rules(), tree)
    flat = {path_name(p): l for p, l in R.tree_leaves_with_path(tree)}
    covered = 0
    for name, spec in specs.items():
        leaf = flat[name]
        if re.search(r"block\d+/.*kernel$", name) and leaf.dim() == 2:
            covered += 1
            if re.search(r"(qkv|mlp_in)/kernel$", name):
                assert spec == P(None, "model"), name
            elif re.search(r"(proj|mlp_out)/kernel$", name):
                assert spec == P("model", None), name
            else:
                raise AssertionError(f"unclassified block kernel {name}")
        elif re.search(r"ln\d?|ln_f", name) or leaf.dim() <= 1:
            assert spec == P(), name
    assert covered == 8


def test_gqa_tree_every_2d_block_kernel_gets_intended_spec():
    tree = PT.lm_params_tree(_port_module(_jax_params(num_kv_heads=2),
                                          num_kv_heads=2))
    specs = _named(lm_tensor_rules(), tree)
    assert "block0/q/kernel" in specs and "block0/kv/kernel" in specs
    assert "block0/qkv/kernel" not in specs
    flat = {path_name(p): l for p, l in R.tree_leaves_with_path(tree)}
    covered = sum(1 for n in specs if re.search(r"block\d+/.*kernel$", n)
                  and flat[n].dim() == 2)
    assert covered == 10


def test_moe_rules_shard_expert_dim_only():
    tree = PT.lm_params_tree(_port_module(_jax_params(moe_experts=2),
                                          moe_experts=2))
    specs = _named(moe_expert_rules(), tree)
    assert specs["block0/moe/w_in"] == P("model", None, None)
    assert specs["block0/moe/w_out"] == P("model", None, None)
    assert specs["block0/moe/router/kernel"] == P()
    assert specs["head/kernel"] == P()


def test_head_only_rules_cover_classifier_head():
    specs = _named(head_only_rules(),
                   {"head": {"kernel": torch.ones(8, 4)},
                    "conv": {"kernel": torch.ones(3, 3, 8, 8)}})
    assert specs["head/kernel"] == P(None, "model")
    assert specs["conv/kernel"] == P()


@pytest.mark.parametrize("kw", [{}, {"moe_experts": 2}], ids=["dense", "moe"])
def test_lm_3d_rules_cover_stacked_tree(kw):
    params = _jax_params(**kw)
    p3 = PT.lm_params_to_3d(PT.lm_params_tree(_port_module(params, **kw)),
                            num_layers=2, pipe=2)
    validate_rules(lm_3d_rules(), MESH_AXIS_NAMES)
    specs = _named(lm_3d_rules(), p3)
    jspecs = _jax_named(JR.lm_3d_rules(), JT.lm_params_to_3d(params, 2, 2))
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in jspecs.items()}
    if not kw:
        assert specs["blocks/qkv/kernel"] == P("pipe", None, None, "model")
        assert specs["blocks/proj/kernel"] == P("pipe", None, "model", None)
        assert specs["blocks/ln1/scale"] == P("pipe")
        assert specs["blocks/mlp_in/bias"] == P("pipe")
        assert specs["out/head/kernel"] == P(None, "model")
        assert specs["out/ln_f/scale"] == P()
        assert specs["embed/tok_embed/embedding"] == P()


def test_legacy_callables_agree_with_their_tables():
    tree = PT.lm_params_tree(_port_module(_jax_params()))
    for path, leaf in R.tree_leaves_with_path(tree):
        assert lm_tensor_parallel_rules(path, leaf) == spec_for(
            lm_tensor_rules(), path_name(path), leaf)
        assert head_rules(path, leaf) == spec_for(
            head_only_rules(), path_name(path), leaf)


# ----------------------------------------------------------- MeshPlan

def test_meshplan_shapes_and_validation(ranks):
    """Validation that needs no group runs first (a shape that is not the
    rank count raises before any collective)."""
    with pytest.raises(ValueError):
        MeshPlan(data=3, model=2, pipe=2, devices=range(8), device="cpu")
    with pytest.raises(ValueError, match="model"):
        MeshPlan(data=1, model=0, pipe=1, device="cpu")
    for r in ranks:
        for (d, t, p), shape in r["plan_shapes"].items():
            assert shape == {"data": d, "model": t, "pipe": p}
        assert r["absorbed"] == 2  # data=-1 absorbs: 4 / (2 * 1)
        assert len(r["plan_errors"]) == 2
        assert "seq" in r["seq_rejected"]


# ------------------------------------------------------------- topology

def test_device_topology_from_runtime(ranks):
    """4 ranks on one machine: 4 processes (a rank each), one host =
    one slice, each rank's ordinal its own."""
    for rank, r in enumerate(ranks):
        hosts, slices, groups, local = r["topo"]
        assert (hosts, slices) == (4, 1)
        assert groups == [[0, 1, 2, 3]]
        assert local == [rank]


def test_device_topology_synthetic_multislice():
    infos = tuple(
        DeviceInfo(id=i, process_index=i // 2, slice_index=i // 4, coords=())
        for i in range(8))
    topo = DeviceTopology(devices=infos)
    assert topo.num_hosts == 4
    assert topo.num_slices == 2
    assert topo.devices_per_host == 2
    assert topo.hosts_per_slice == 2
    assert topo.slice_groups() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert topo.local_ordinals(3) == [6, 7]


def test_cluster_info_matches_runtime(ranks):
    info = cluster_info()  # this process: no group, no card
    assert (info.process_count, info.global_device_count) == (1, 1)
    assert info.platform == "cpu" and not info.is_distributed
    for rank, r in enumerate(ranks):
        ri = r["info"]
        assert ri.process_index == rank and ri.process_count == 4
        assert ri.global_device_count == 4 and ri.devices_per_process == 1
        assert ri.platform == "cpu" and ri.is_distributed
        assert r["num_shards"] == 4


def test_make_mesh_dcn_layout_groups_slices_on_leading_axis(ranks):
    for r in ranks:
        assert r["dcn_mesh"] == [[[0], [1]], [[2], [3]]]


def test_make_mesh_dcn_validation(ranks):
    with pytest.raises(ValueError, match="divisible by dcn_data"):
        make_mesh(data=3, model=1, seq=1, devices=[0, 1, 2], dcn_data=2,
                  device="cpu")
    for r in ranks:
        assert "divisible by dcn_data" in r["dcn_error"]


def test_make_mesh_rejects_real_slice_mismatch(ranks):
    for r in ranks:
        assert "does not match the runtime" in r["slice_mismatch"]


def test_process_mesh_placement_covers_every_coordinate(ranks):
    for r in ranks:
        placement = r["placement"]
        assert sorted(placement) == [0, 1, 2, 3]
        assert sum(len(v) for v in placement.values()) == 4


def test_dcn_mesh_computes(ranks):
    """A batch sharded over the data axis of a dcn layout: the sum of the
    ranks' rows is the host array's column sum; each rank holds its row;
    a short batch pads to the data degree; an uneven layout is None."""
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["dcn_sum"].numpy(), x.sum(axis=0))
        local, n, shape = r["shard_batch"]
        np.testing.assert_array_equal(local.numpy(), x[rank:rank + 1])
        assert (n, shape) == (4, (4, 4))
        assert r["padded"] == ((8, 2), 7)
        (_dev, index), = r["layout"]
        assert index[0] == slice(2 * rank, 2 * rank + 2)
        assert r["uneven_layout"] is None
        assert r["is_coordinator"] == (rank == 0)
