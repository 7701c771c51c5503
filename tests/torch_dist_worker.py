"""One rank of a multi-process port job on the CPU (gloo), for the
distributed parity tests.

    python tests/torch_dist_worker.py SCENARIO RANK WORLD PORT DIR

joins a WORLD-rank gloo group through the port's
`initialize_distributed` (a TCP store on 127.0.0.1:PORT), runs the
named scenario (here or in tests/torch_data_scenarios.py) on this rank
with the inputs the test wrote to DIR/inputs.pt, and writes what it
computed to DIR/rank<RANK>.pt.  It
imports torch and mmlspark_tpu_torch only — never jax or the JAX
package.  `run_ranks` starts the WORLD processes and collects their
results.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(scenario: str, inputs: dict, tmp_dir, world: int = 4,
              timeout: float = 240.0) -> list:
    """Run `scenario` on `world` gloo ranks; returns each rank's results
    (raises with the ranks' output when one fails)."""
    import torch

    from mmlspark_tpu_torch.utils.cluster import find_open_port

    tmp_dir = os.fspath(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    torch.save(inputs, os.path.join(tmp_dir, "inputs.pt"))
    port = find_open_port(20000 + (os.getpid() * 7) % 20000)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(port), tmp_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
            f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outs)))
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- scenarios

def _seq_blocks(x, rank, world):
    s = x.shape[1] // world
    return x[:, rank * s:(rank + 1) * s].contiguous()


def scenario_seqpar(rank, world, inp):
    """Ring and Ulysses attention on every case, forward and gradients
    of sum(out**2) (the loss summed over the ranks)."""
    import torch

    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    from mmlspark_tpu_torch.parallel.ring_attention import (
        ring_attention, ulysses_attention)

    mesh = make_mesh(data=world, device="cpu")
    out = {}
    for name, case in inp["cases"].items():
        q, k, v = (_seq_blocks(case[x], rank, world) for x in "qkv")
        for algo, fn in (("ring", ring_attention),
                         ("ulysses", ulysses_attention)):
            for causal in (False, True):
                with torch.no_grad():
                    out[(name, algo, causal)] = fn(q, k, v, mesh,
                                                   causal=causal)
            if case.get("grads"):
                ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
                (fn(ql, kl, vl, mesh, causal=True) ** 2).sum().backward()
                out[(name, algo, "grads")] = (ql.grad, kl.grad, vl.grad)
    # a data x seq mesh: both default to the seq axis
    mixed = make_mesh(data=2, seq=2, device="cpu")
    i = mixed.get_local_rank("seq")
    case = inp["cases"]["ref"]
    q, k, v = (_seq_blocks(case[x], i, 2) for x in "qkv")
    with torch.no_grad():
        out["mixed"] = (ring_attention(q, k, v, mixed, causal=True),
                        ulysses_attention(q, k, v, mixed, causal=True), i)
    bad = torch.zeros(1, 8, 3, 4)
    try:
        ulysses_attention(bad, bad, bad, mesh)
        out["bad_heads"] = None
    except ValueError as e:
        out["bad_heads"] = str(e)
    return out


def scenario_trainer3d(rank, world, inp):
    """Two SGD-0.1 steps of the 3D trainer on each plan, from the bridged
    weights; the gpipe schedule against sequential stages; format-2
    checkpoints (manifest, tampered shard, flipped byte -> quarantine ->
    resume)."""
    import json
    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.checkpoint import (
        MANIFEST_NAME, CheckpointCorruptError, CheckpointManager)
    from mmlspark_tpu_torch.models.guard import TrainingGuard
    from mmlspark_tpu_torch.models.transformer import transformer_lm
    from mmlspark_tpu_torch.parallel.mesh import MeshPlan
    from mmlspark_tpu_torch.parallel.pipeline import gpipe_spmd_apply
    from mmlspark_tpu_torch.parallel.sharding_rules import lm_3d_rules

    cfg, L = inp["cfg"], inp["cfg"]["num_layers"]
    out = {}

    def fresh_model():
        model = transformer_lm(**cfg)
        return T.load_lm_params(model, inp["params"])

    def state_on(plan, model, params=None):
        tree = params if params is not None else T.lm_params_tree(model)
        p3 = T.shard_params(T.lm_params_to_3d(tree, L, plan.pipe), plan,
                            lm_3d_rules())
        return T.init_lm_state_3d(p3, T.sgd(0.1), plan)

    for shape in inp["plans"]:
        plan = MeshPlan(*shape, device="cpu")
        model = fresh_model()
        state = state_on(plan, model)
        step = T.make_lm_train_step_3d(model, plan, remat=True)
        losses = []
        for i in range(2):
            state, m = step(state, inp["tokens"][i])
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        full = T.lm_params_from_3d(T.gather_params(state), L)
        out[("plan", tuple(shape))] = {"losses": losses, "params": full}
    # remat off on the first plan: the same numbers
    plan = MeshPlan(*inp["plans"][0], device="cpu")
    model = fresh_model()
    state = state_on(plan, model)
    step = T.make_lm_train_step_3d(model, plan, remat=False)
    losses = []
    for i in range(2):
        state, m = step(state, inp["tokens"][i])
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    out["no_remat"] = {"losses": losses, "params": T.lm_params_from_3d(
        T.gather_params(state), L)}

    # an MoE LM on a pipe x tensor plan: experts split over the model axis
    moe = inp["moe"]
    plan = MeshPlan(1, 2, 2, device="cpu")
    model = T.load_lm_params(transformer_lm(**moe["cfg"]), moe["params"])
    p3 = T.shard_params(T.lm_params_to_3d(
        T.lm_params_tree(model), moe["cfg"]["num_layers"], plan.pipe), plan,
        lm_3d_rules())
    state = T.init_lm_state_3d(p3, T.sgd(0.1), plan)
    step = T.make_lm_train_step_3d(model, plan, remat=True)
    losses = []
    for i in range(2):
        state, m = step(state, moe["tokens"][i])
        losses.append(float(m["loss"]))
    out["moe"] = {"losses": losses, "params": T.lm_params_from_3d(
        T.gather_params(state), moe["cfg"]["num_layers"])}

    # gpipe over 4 stages (one a rank) against sequential application
    plan = MeshPlan(1, 1, world, device="cpu")
    g = inp["gpipe"]
    got = gpipe_spmd_apply(lambda p, x: torch.tanh(x @ p["w"]) + p["b"],
                           g["stacked"], g["x"], mesh=plan)
    out["gpipe"] = got
    xg = g["x"].clone().requires_grad_()
    w = {k: v.clone().requires_grad_() for k, v in g["stacked"].items()}
    gpipe_spmd_apply(lambda p, x: torch.tanh(x @ p["w"]) + p["b"], w, xg,
                     mesh=plan).square().sum().backward()
    out["gpipe_grads"] = {"x": xg.grad,
                          "w": w["w"].grad, "b": w["b"].grad}
    try:
        gpipe_spmd_apply(lambda p, x: x, {"w": torch.zeros(2, 3)},
                         g["x"], mesh=plan)
        out["gpipe_mismatch"] = None
    except ValueError as e:
        out["gpipe_mismatch"] = str(e)

    # format-2 checkpoints on a pipe x tensor plan
    plan = MeshPlan(1, 2, 2, device="cpu")
    root = os.path.join(inp["dir"], "ckpt")
    model = fresh_model()
    state = state_on(plan, model)
    mgr = CheckpointManager(root)
    mgr.save(state, step=1)
    with open(os.path.join(root, "1", MANIFEST_NAME)) as f:
        out["manifest"] = json.load(f)
    state2 = state_on(plan, model)
    with torch.no_grad():
        for p in state2.module.parameters():
            p.add_(1e-3)
    state2.step = 1
    mgr.save(state2, step=2)
    # a tampered shard crc in the manifest: the rejection names the shard
    if rank == 0:
        import shutil

        shutil.copytree(os.path.join(root, "2"),
                        os.path.join(inp["dir"], "tamper", "2"))
        tmgr = CheckpointManager(os.path.join(inp["dir"], "tamper"))
        mpath = os.path.join(inp["dir"], "tamper", "2", MANIFEST_NAME)
        with open(mpath) as f:
            doc = json.load(f)
        key = "module/blocks.proj.kernel"
        doc["leaves"][key]["shards"][2]["crc32"] ^= 0xDEAD
        with open(mpath, "w") as f:
            json.dump(doc, f)
        try:
            tmgr.restore(step=2, template=state_on(plan, fresh_model()))
            out["tamper"] = None
        except CheckpointCorruptError as e:
            out["tamper"] = str(e)
        # one flipped byte inside one shard of step 2's qkv kernel
        leaf = doc["leaves"]["module/blocks.qkv.kernel"]
        victim = os.path.join(root, "2", leaf["file"])
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) - 7)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    dist.barrier()
    guard = TrainingGuard(watchdog=False)
    qpath = os.path.join(root, "quarantine.json")

    def on_corrupt(step, path):
        guard.quarantine_checkpoint(step, path)
        if mgr.writer:
            guard.save_quarantine(qpath)

    target = state_on(plan, fresh_model())
    with torch.no_grad():
        for p in target.module.parameters():
            p.fill_(7.0)
    restored, step = mgr.restore_verified(template=target,
                                          on_corrupt=on_corrupt,
                                          quarantine=True)
    dist.barrier()
    out["resume"] = {
        "step": step, "state_step": int(restored.step),
        "equal": all(torch.equal(a, b) for a, b in zip(
            restored.module.parameters(), state.module.parameters())),
        "work_equal": all(torch.equal(a, b) for a, b in zip(
            restored.work.parameters(), restored.module.parameters())),
        "steps_left": mgr.all_steps(),
        "quarantined": os.path.exists(os.path.join(root, "quarantined",
                                                   "2")),
        "ledger": [list(x) for x in guard.quarantined_checkpoints]}
    return out


def scenario_elastic(rank, world, inp):
    """The elastic shrink-and-resume on 4 ranks: rank 1 dies at schedule
    step 2 (an injected crash at its `training.step` crossing); the
    survivors' injected `training.host_lost` declares it, the epoch
    advances, the survivors regroup into a world of 3 and rebuild the
    plan, roll back to the checkpoint floor and finish the schedule."""
    import json
    import numpy as np
    import torch

    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.guard import TrainingGuard
    from mmlspark_tpu_torch.models.transformer import transformer_lm
    from mmlspark_tpu_torch.parallel import distributed as D
    from mmlspark_tpu_torch.parallel.mesh import MeshPlan
    from mmlspark_tpu_torch.parallel.sharding_rules import lm_3d_rules
    from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan,
                                                 InjectedCrash)

    cfg = inp["cfg"]
    hosts = [D.HostInfo(f"h{i}", i, 1) for i in range(world)]
    me = hosts[rank]
    view = D.MembershipView(1, hosts)
    store = D.MembershipStore(os.path.join(inp["dir"], "members"))
    if rank == 0:
        store.publish(view)
    mon = D.HeartbeatMonitor([h.host_id for h in hosts], lease_s=1e9,
                             self_id=me.host_id)
    rebuilds = []
    model = T.load_lm_params(transformer_lm(**cfg), inp["params"])

    def rebuild(v):
        new_rank = ctx.regroup(v)
        plan = MeshPlan(data=len(v.hosts), device="cpu")
        rebuilds.append((new_rank, plan.data))
        return plan, T.make_lm_resumable_step_3d(model, plan,
                                                 microbatches=1)

    ctx = D.ElasticContext(me, view, store=store, monitor=mon,
                           coordinator=rank == 0, rebuild=rebuild,
                           hang_budget_s=120.0)
    plan = MeshPlan(data=world, device="cpu")
    p3 = T.shard_params(T.lm_params_to_3d(T.lm_params_tree(model),
                                          cfg["num_layers"], 1),
                        plan, lm_3d_rules())
    state = T.init_lm_state_3d(p3, T.sgd(0.1), plan)
    step = T.make_lm_resumable_step_3d(model, plan, microbatches=1)
    guard = TrainingGuard(watchdog=False, hang_timeout_s=120.0)
    toks = inp["tokens"]
    labels = np.zeros(len(toks), np.int64)
    fault = (FaultPlan(seed=11).on("training.step", nth=[2],
                                   error=InjectedCrash) if rank == 1 else
             FaultPlan(seed=11).on("training.host_lost", nth=[2]))
    out = {"rank": rank}
    try:
        with FAULTS.arm(fault):
            state, metrics = T.fit_epochs_resumable(
                step, state, toks, labels, batch_size=12,
                checkpoint_dir=os.path.join(inp["dir"], "ckpt"), epochs=1,
                checkpoint_every=2, seed=0, guard=guard, elastic=ctx)
    except (InjectedCrash, D.StaleMembershipError) as e:
        # killed at its step, or fenced: its poll saw the epoch the
        # survivors published without it (whichever came first)
        out["died"] = type(e).__name__
        return out
    out.update(died=False, loss=metrics["loss"], step=int(state.step),
               epoch=ctx.view.epoch, hosts=ctx.view.host_ids,
               rebuilds=rebuilds, lost=[r["host_id"] for r in guard.lost_hosts],
               rollbacks=guard.rollbacks, lr_scale=guard.lr_scale,
               fires=dict(FAULTS.fires),
               params=T.lm_params_from_3d(T.gather_params(state),
                                          cfg["num_layers"]))
    if rank == 0:
        with open(os.path.join(inp["dir"], "ckpt", "quarantine.json")) as f:
            out["qdoc"] = json.load(f)
        out["published"] = store.load().to_dict()
    return out


def scenario_mesh(rank, world, inp):
    """Mesh, plan, topology and sharding helpers over the 4 ranks."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch.parallel import distributed as D
    from mmlspark_tpu_torch.parallel import mesh as M
    from mmlspark_tpu_torch.parallel.sharding_rules import (
        P, lm_tensor_rules, make_shard_and_gather_fns, match_partition_rules)
    from mmlspark_tpu_torch.utils import cluster as C

    out = {}
    shapes = {}
    for d, t, p in [(4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2)]:
        shapes[(d, t, p)] = M.MeshPlan(data=d, model=t, pipe=p,
                                       device="cpu").shape
    out["plan_shapes"] = shapes
    absorbed = M.MeshPlan(model=2, device="cpu")
    out["absorbed"] = absorbed.data
    out["coords"] = absorbed.coords
    errs = []
    for args in [(3, 2, 1), (-1, 3, 1)]:
        try:
            M.MeshPlan(*args, device="cpu")
        except ValueError as e:
            errs.append(str(e))
    out["plan_errors"] = errs
    try:
        absorbed.validate_specs(((r".*", P("seq")),))
        out["seq_rejected"] = None
    except ValueError as e:
        out["seq_rejected"] = str(e)
    out["info"] = C.cluster_info()
    out["num_shards"] = C.get_num_shards()
    topo = C.device_topology()
    out["topo"] = (topo.num_hosts, topo.num_slices, topo.slice_groups(),
                   topo.local_ordinals(rank))
    mesh = M.make_mesh(data=2, model=2, dcn_data=2, device="cpu")
    out["dcn_mesh"] = mesh.mesh.tolist()
    out["placement"] = C.process_mesh_placement(mesh)
    try:
        M.make_mesh(data=3, devices=[0, 1, 2], dcn_data=2, device="cpu")
        out["dcn_error"] = None
    except ValueError as e:
        out["dcn_error"] = str(e)
    # a real 3-host topology asked for dcn_data=2 must error
    real = C.device_topology
    C.device_topology = lambda devices=None: C.DeviceTopology(devices=tuple(
        C.DeviceInfo(id=i, process_index=i, slice_index=i % 3, coords=())
        for i in range(world)))
    try:
        M.make_mesh(data=world, dcn_data=2, device="cpu")
        out["slice_mismatch"] = None
    except ValueError as e:
        out["slice_mismatch"] = str(e)
    finally:
        C.device_topology = real
    # psum over the data axis of a dcn mesh
    dmesh = M.make_mesh(data=world, dcn_data=2, device="cpu")
    x = np.arange(world * 4, dtype=np.float32).reshape(world, 4)
    xs, n = M.shard_batch(x, dmesh)
    local = xs.to_local().sum(dim=0)
    torch.distributed.all_reduce(local)
    out["dcn_sum"] = local
    out["shard_batch"] = (xs.to_local(), n, tuple(xs.shape))
    xs7, n7 = M.shard_batch(np.ones((7, 2), np.float32), dmesh)
    out["padded"] = (tuple(xs7.shape), n7)
    out["layout"] = M.addressable_shard_layout(
        M.batch_sharding(dmesh, 2), (8, 4))
    out["uneven_layout"] = M.addressable_shard_layout(
        M.batch_sharding(dmesh, 2), (6, 4))
    # shard + gather round trip under the tensor rules
    tmesh = M.make_mesh(data=2, model=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tree = {"block0": {"qkv": {"kernel": torch.randn(4, 12, generator=gen)},
                       "proj": {"kernel": torch.randn(4, 4, generator=gen)}},
            "ln": {"scale": torch.randn(4, generator=gen)}}
    specs = match_partition_rules(lm_tensor_rules(), tree)
    shard_fns, gather_fns = make_shard_and_gather_fns(specs, tmesh)
    placed = {k: {kk: {kkk: shard_fns[k][kk][kkk](vvv)
                       for kkk, vvv in vv.items()}
                  for kk, vv in v.items()}
              for k, v in tree.items() if k == "block0"}
    qkv = placed["block0"]["qkv"]["kernel"]
    out["qkv_local"] = tuple(qkv.to_local().shape)
    out["roundtrip"] = torch.equal(
        gather_fns["block0"]["qkv"]["kernel"](qkv),
        tree["block0"]["qkv"]["kernel"])
    D.barrier("mesh-test", timeout_s=30.0)
    out["is_coordinator"] = D.is_coordinator()
    return out


SCENARIOS = {"seqpar": scenario_seqpar, "trainer3d": scenario_trainer3d,
             "elastic": scenario_elastic, "mesh": scenario_mesh}


def main(argv) -> int:
    scenario, rank, world, port, tmp_dir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from mmlspark_tpu_torch.parallel import distributed as D

    try:
        D.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu", timeout_s=120.0)
        inp = torch.load(os.path.join(tmp_dir, "inputs.pt"),
                         weights_only=False)
        inp["dir"] = tmp_dir
        if scenario not in SCENARIOS:
            import torch_data_scenarios

            SCENARIOS.update(torch_data_scenarios.SCENARIOS)
        result = SCENARIOS[scenario](rank, world, inp)
        torch.save(result, os.path.join(tmp_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    # a rank that died in the scenario may have left peers' sockets
    # half-open: leave without the group's teardown
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
