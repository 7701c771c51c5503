"""The data side's multi-rank scenarios for tests/torch_dist_worker.py:
the sharded feed, the meshed featurizer, the GBDT's data- and
voting-parallel fits and the online learners' all-reduce, each run on
every gloo rank with the inputs the test wrote.  Imports torch, numpy,
mmlspark_tpu_torch and tests/torch_gbdt_compare.py only."""
from __future__ import annotations


def scenario_feed(rank, world, inp):
    """io/shard_put.py and the meshed DeviceFeed: parity per dtype, no
    copy in `from_local`, the fallback and auto rules, concurrent shard
    puts across ranks, the fault ladder, an H2DStage graph through the
    sticky degrade, a deadline shed at the stage, and a meshed `run`."""
    import warnings

    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.core.flow import Expired, FlowGraph, FlowItem
    from mmlspark_tpu_torch.io import shard_put as SP
    from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry
    from mmlspark_tpu_torch.models.torch_model import _sharded_forward
    from mmlspark_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                  replicated_sharding)
    from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan,
                                                 VirtualClock, monotonic,
                                                 use_clock)

    mesh = make_mesh(device="cpu")
    out = {"rank": rank}

    def sharded(tel=None):
        return DeviceFeed(mesh=mesh, telemetry=tel or FeedTelemetry(),
                          shard_strategy="sharded")

    # ---- parity per dtype; the DTensor keeps the copied block --------
    ptrs = []
    orig_copy = SP.ShardEngine._copy

    def recording(self, view, host, device):
        t, ev = orig_copy(self, view, host, device)
        ptrs.append(t.data_ptr())
        return t, ev

    SP.ShardEngine._copy = recording
    try:
        for name, arr in inp["dtypes"].items():
            tel = FeedTelemetry()
            y = sharded(tel).put(arr, batch_sharding(mesh, arr.ndim),
                                 block=True)
            out[("dtype", name)] = {
                "local": y.to_local().numpy().copy(),
                "full": y.full_tensor().numpy(), "shape": tuple(y.shape),
                "no_copy": y.to_local().data_ptr() == ptrs[-1],
                "snap": tel.snapshot()}
    finally:
        SP.ShardEngine._copy = orig_copy

    # ---- a replicated odd batch: every rank's shard is all of it -----
    tel = FeedTelemetry()
    odd = inp["odd"]
    y = sharded(tel).put(odd, replicated_sharding(mesh), block=True)
    out["replicated"] = (y.to_local().numpy().copy(),
                         tel.snapshot()["sharded_groups"])

    # ---- an uneven batch: a counted fallback, not the ladder ---------
    tel = FeedTelemetry()
    f = sharded(tel)
    uneven = inp["uneven"]
    sh = batch_sharding(mesh, 2)
    snap = None
    if SP.shard_layout(sh, uneven.shape) is None \
            and f._try_sharded(uneven, sh) is None:
        snap = tel.snapshot()
    out["uneven"] = (snap, FeedTelemetry.summarize(snap)["h2d_path"]
                     if snap else None, f.shard_degraded)

    # ---- auto: a tiny batch coalesces on purpose ---------------------
    tel = FeedTelemetry()
    tiny = inp["tiny"]
    y = DeviceFeed(mesh=mesh, telemetry=tel).put(tiny, batch_sharding(mesh, 2))
    out["tiny"] = (y.full_tensor().numpy(), tel.snapshot())

    # ---- a strided host view stages and lands byte-exact -------------
    strided = inp["base"][:, ::2]
    y = sharded().put(strided, batch_sharding(mesh, 2), block=True)
    out["strided"] = y.full_tensor().numpy()

    # ---- every rank's shard put is in flight at once -----------------
    orig_put = SP.ShardEngine._put_shard

    def gated(self, view, host, device):
        dist.barrier()  # passes only when every rank's put is in flight
        return orig_put(self, view, host, device)

    tel = FeedTelemetry()
    SP.ShardEngine._put_shard = gated
    try:
        y = sharded(tel).put(inp["conc"], batch_sharding(mesh, 2), block=True)
    finally:
        SP.ShardEngine._put_shard = orig_put
    out["concurrent"] = (y.full_tensor().numpy(),
                         tel.snapshot()["transfer_concurrency"],
                         SP.transfer_pool().concurrency_high_water())

    # ---- a transient shard fault is retried --------------------------
    telemetry.reset_counters()
    f = sharded()
    with FAULTS.arm(FaultPlan(seed=3).on("feed.shard_put", nth=[0])):
        y = f.put(inp["conc"], batch_sharding(mesh, 2), block=True)
    out["transient"] = (y.full_tensor().numpy(), f.shard_degraded,
                        telemetry.export_snapshot()["counters"].get(
                            "feed.shard_retry", 0))

    # ---- exhausted: sticky degrade to coalesced, nothing lost --------
    telemetry.reset_counters()
    tel = FeedTelemetry()
    f = sharded(tel)
    with FAULTS.arm(FaultPlan(seed=5).on("feed.shard_put", probability=1.0)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ys = [f.put(a, batch_sharding(mesh, 2), block=True)
                  for a in inp["three"]]
        fires = dict(FAULTS.fires)
    out["exhausted"] = {
        "degraded": f.shard_degraded, "fires": fires.get("feed.shard_put"),
        "retries": f._shard_policy.retries,
        "outs": [y.full_tensor().numpy() for y in ys],
        "snap": tel.snapshot(),
        "warned": [str(w.message) for w in caught],
        "counter": telemetry.export_snapshot()["counters"].get(
            "feed.shard_degraded")}

    # ---- the raw engine: ShardTransferError, staging released --------
    staging = SP.StagingBuckets()
    eng = SP.ShardEngine(telemetry=FeedTelemetry(), staging=staging,
                         min_shard_bytes=0)
    raised = None
    with FAULTS.arm(FaultPlan(seed=9).on("feed.shard_put", probability=1.0)):
        try:
            eng.put_sharded(strided, batch_sharding(mesh, 2))
        except SP.ShardTransferError as e:
            raised = type(e).__name__
    n = staging.allocated()
    grabbed = [staging.acquire(strided.nbytes // world) for _ in range(n)]
    out["engine"] = (raised, n, staging.allocated())
    for sb in grabbed:
        staging.release(sb)

    # ---- an H2DStage graph through the exhausted ladder --------------
    f = sharded()
    graph = FlowGraph([f.stage()], queue_size=8, span_prefix="flow")
    plan = (FaultPlan(seed=7).on("feed.shard_put", probability=1.0)
            .on("feed.device_put", nth=[1]))
    with FAULTS.arm(plan):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = list(graph.run(list(inp["h2d"])))
        fires = dict(FAULTS.fires)
    out["h2d"] = {"outs": [y.full_tensor().numpy() for y in got],
                  "degraded": f.shard_degraded, "feed_degraded": f.degraded,
                  "fires": fires}

    # ---- a lapsed budget is shed at the stage, its slot kept ---------
    clock = VirtualClock()
    with use_clock(clock):
        g = FlowGraph([sharded().stage()], queue_size=4, span_prefix="flow")
        a = inp["h2d"]
        items = [FlowItem(a[0], None), FlowItem(a[1], monotonic() - 0.01),
                 FlowItem(a[2], None)]
        shed = list(g.run(iter(items), yield_expired=True))
    out["shed"] = [("expired" if isinstance(s, Expired)
                    else s.full_tensor().numpy()) for s in shed]

    # ---- a meshed run: each rank its rows, the result gathered -------
    tel = FeedTelemetry()
    res = DeviceFeed(mesh=mesh, telemetry=tel, coalesce=4).run(
        iter(inp["chunks"]), _sharded_forward(
            lambda x: x.to(torch.float32) * 2.0 + 1.0, mesh))
    out["run"] = (res, tel.snapshot())
    return out


def scenario_featurizer(rank, world, inp):
    """ImageFeaturizer / TorchModel inside the group: the meshed feed,
    B1's plain version and the backbone on each rank's rows."""
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY
    from mmlspark_tpu_torch.models import torch_model as TM
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    make_mesh(device="cpu")
    batches = []
    orig = TM.ImagePreprocess.__call__

    def counted(self, batch):
        batches.append(tuple(batch.shape))
        return orig(self, batch)

    TM.ImagePreprocess.__call__ = counted
    out = {}
    try:
        for pad in (False, True):
            batches.clear()
            before = FEED_TELEMETRY.snapshot()
            got = ImageFeaturizer(bundle=inp["bundle"], batch_size=2,
                                  pad_to_batch=pad, device="cpu").transform(
                Table({"image": inp["images"], "id": inp["ids"]}))
            out[pad] = {"features": got["features"], "ids": got["id"],
                        "batches": list(batches),
                        "feed": FEED_TELEMETRY.delta(before)}
    finally:
        TM.ImagePreprocess.__call__ = orig
    return out


def scenario_gbdt(rank, world, inp):
    """Data- and voting-parallel fits over the world's data mesh (dense
    and sparse), held to the JAX fits' recorded split calls by the tie
    rule; the voted mask and local histograms; `_resolve_mesh`."""
    import numpy as np

    from torch_gbdt_compare import following_splits
    from mmlspark_tpu_torch.gbdt import (Booster, GBDTClassifier,
                                         TrainConfig)
    from mmlspark_tpu_torch.gbdt import histogram as PH
    from mmlspark_tpu_torch.gbdt import tree as PT
    from mmlspark_tpu_torch.gbdt.sparse import CSRMatrix
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    out = {}
    x, y = inp["x"], inp["y"]
    with following_splits(PT, inp["dp_calls"], f"dp world {world}") as (
            _c, ties):
        b = Booster(TrainConfig(parallelism="data_parallel",
                                **inp["cfg"])).fit(x, y, mesh=mesh,
                                                   device="cpu")
    out["dp"] = (b.model_string(), b.score(x), len(ties))
    vb = Booster(TrainConfig(parallelism="voting_parallel",
                             **inp["vote_cfg"])).fit(x, y, mesh=mesh,
                                                     device="cpu")
    out["vote"] = (vb.model_string(), vb.score(x))
    builder = PH.HistogramBuilder(inp["binned"], inp["num_bins"], mesh=mesh,
                                  voting=True, top_k=5, device="cpu")
    arrs = builder.device_arrays(inp["grad"], inp["hess"], np.ones(len(x)))
    local = builder.build_local(*arrs, builder.node_mask(
        np.ones(len(x), bool))).numpy()
    out["local"] = local
    out["voted"] = PH.vote_features(local, 0.0, 0.0, 20.0, 1e-3, 5)
    csr = CSRMatrix(*inp["csr"])
    with following_splits(PT, inp["sparse_calls"],
                          f"sparse world {world}") as (_c, sties):
        sb = Booster(TrainConfig(parallelism="data_parallel",
                                 **inp["sparse_cfg"])).fit(
            csr, inp["sy"], mesh=mesh, device="cpu")
    out["sparse"] = (sb.model_string(), sb.score(csr), len(sties))
    dp_mesh = GBDTClassifier(parallelism="data_parallel",
                             device="cpu")._resolve_mesh()
    out["resolve"] = (None if dp_mesh is None else dp_mesh.size(0),
                      GBDTClassifier(parallelism="serial",
                                     device="cpu")._resolve_mesh())
    return out


def scenario_online(rank, world, inp):
    """use_all_reduce fits of the classifier and the regressor."""
    from mmlspark_tpu_torch.online import learners as PL

    out = {}
    for name, cls, table in (("cls", PL.VowpalWabbitClassifier, inp["cls"]),
                             ("reg", PL.VowpalWabbitRegressor, inp["reg"])):
        m = cls(use_all_reduce=True, num_passes=inp["passes"],
                device="cpu").fit(table)
        st = m.performance_statistics
        out[name] = (m.weights, list(st["num_shards"]),
                     list(st["average_loss"]))
    return out


SCENARIOS = {"feed": scenario_feed, "featurizer": scenario_featurizer,
             "gbdt": scenario_gbdt, "online": scenario_online}
