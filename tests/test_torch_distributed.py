"""The port's elastic runtime (mmlspark_tpu_torch/parallel/distributed.py):
the counterparts of tests/test_elastic_distributed.py — rendezvous
hardening, membership epochs, the file plane, heartbeat leases,
hang-budget collectives, the follower's epoch adoption and the per-host
telemetry endpoint merged by the port's fleet merge — each checked with
the same counters and messages, and the shrink-and-resume ladder on 4
gloo ranks (tests/torch_dist_worker.py): one rank dies mid-schedule,
the survivors declare it, regroup into a world of 3, roll back to the
checkpoint floor and finish — equal to the uninterrupted schedule on one
process within 1e-5.
"""
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import telemetry as core_telemetry
from mmlspark_tpu_torch.parallel import distributed as dist
from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan, VirtualClock,
                                             use_clock)

from torch_dist_worker import run_ranks


def _dist_counters():
    return core_telemetry.counters("dist.")


def _delta(before, after, name):
    return after.get(name, 0) - before.get(name, 0)


# ---------------------------------------------------------------- rendezvous


def test_single_process_fallback(monkeypatch):
    """No coordinator address -> no runtime calls, this process IS the
    coordinator (the mesh functions start their own world-1 group)."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    dist.reset_distributed_state()
    calls = []
    dist.initialize_distributed(_initialize=lambda **kw: calls.append(kw))
    assert calls == []
    assert dist.is_coordinator()
    dist.initialize_distributed(_initialize=lambda **kw: calls.append(kw))
    assert calls == []


def test_rendezvous_retries_with_backoff_then_succeeds():
    dist.reset_distributed_state()
    before = _dist_counters()
    attempts = []

    def flaky(**kw):
        attempts.append(kw)
        if len(attempts) < 3:
            raise RuntimeError("connection refused")

    with use_clock(VirtualClock()):
        dist.initialize_distributed(
            coordinator_address="10.0.0.1:1234", num_processes=2,
            process_id=1, max_attempts=3, backoff_s=0.5, timeout_s=60.0,
            _initialize=flaky)
    after = _dist_counters()
    assert len(attempts) == 3
    assert attempts[0]["num_processes"] == 2
    assert attempts[0]["process_id"] == 1
    assert _delta(before, after, "dist.rendezvous.attempt") == 3
    assert _delta(before, after, "dist.rendezvous.retry") == 2
    assert _delta(before, after, "dist.rendezvous.failed") == 0
    dist.reset_distributed_state()


def test_rendezvous_exhaustion_raises():
    dist.reset_distributed_state()
    before = _dist_counters()

    def dead(**kw):
        raise RuntimeError("connection refused")

    with use_clock(VirtualClock()):
        with pytest.raises(dist.RendezvousError, match="refused"):
            dist.initialize_distributed(
                coordinator_address="10.0.0.1:1234", num_processes=2,
                process_id=0, max_attempts=3, timeout_s=60.0,
                _initialize=dead)
    after = _dist_counters()
    assert _delta(before, after, "dist.rendezvous.failed") == 1
    dist.reset_distributed_state()


@pytest.mark.parametrize("message", [
    "Distributed system is already initialized",
    "trying to initialize the default process group twice!"])
def test_already_initialized_detected_precisely(message):
    """The runtimes' own refusals are a success; a message that merely
    CONTAINS 'already' is a real failure and must retry/raise."""
    dist.reset_distributed_state()

    def auto(**kw):
        raise RuntimeError(message)

    dist.initialize_distributed(
        coordinator_address="10.0.0.1:1234", num_processes=2,
        process_id=0, _initialize=auto)

    dist.reset_distributed_state()
    n = {"calls": 0}

    def other(**kw):
        n["calls"] += 1
        raise RuntimeError("stream already closed by peer")

    with use_clock(VirtualClock()):
        with pytest.raises(dist.RendezvousError, match="already closed"):
            dist.initialize_distributed(
                coordinator_address="10.0.0.1:1234", num_processes=2,
                process_id=0, max_attempts=2, timeout_s=60.0,
                _initialize=other)
    assert n["calls"] == 2  # retried: NOT swallowed as already-initialized
    dist.reset_distributed_state()


def test_rendezvous_fault_point_armed():
    dist.reset_distributed_state()
    ok = {"n": 0}
    plan = FaultPlan(seed=3).on("dist.rendezvous", nth=[0])
    with use_clock(VirtualClock()):
        with FAULTS.arm(plan):
            dist.initialize_distributed(
                coordinator_address="10.0.0.1:1234", num_processes=2,
                process_id=0, max_attempts=3, timeout_s=60.0,
                _initialize=lambda **kw: ok.__setitem__("n", ok["n"] + 1))
    assert FAULTS.fires.get("dist.rendezvous") == 1
    assert ok["n"] == 1  # first crossing injected, retry succeeded
    dist.reset_distributed_state()


# ---------------------------------------------------------------- membership


def test_membership_epochs_advance_and_reject_stale(tmp_path):
    store = dist.MembershipStore(tmp_path)
    h0 = dist.HostInfo("h0", 0, 2)
    h1 = dist.HostInfo("h1", 1, 2)
    view = store.publish(dist.MembershipView(1, [h0, h1]))
    assert view.total_devices == 4
    assert store.load().host_ids == ["h0", "h1"]

    shrunk = view.without("h1")
    assert shrunk.epoch == 2 and shrunk.host_ids == ["h0"]
    store.publish(shrunk)
    before = _dist_counters()
    with pytest.raises(dist.StaleMembershipError):
        store.publish(view.without("h0"))  # epoch 2 again: stale
    with pytest.raises(dist.StaleMembershipError):
        shrunk.require_epoch(1)
    after = _dist_counters()
    assert _delta(before, after, "dist.membership.stale") == 2
    with pytest.raises(KeyError):
        shrunk.without("h1")  # already gone
    with pytest.raises(ValueError):
        shrunk.without("h0")  # cannot shrink to empty


def test_file_plane_rendezvous(tmp_path):
    store = dist.MembershipStore(tmp_path)
    h0 = dist.HostInfo("h0", 0, 2)
    h1 = dist.HostInfo("h1", 1, 2)
    store.register(h1)  # the "other process" registered already
    view = store.rendezvous(h0, expected=2, coordinator=True,
                            timeout_s=5.0)
    assert view.epoch == 1 and view.host_ids == ["h0", "h1"]
    assert store.rendezvous(h1, expected=2, timeout_s=5.0).epoch == 1


def test_file_plane_rendezvous_timeout(tmp_path):
    store = dist.MembershipStore(tmp_path)
    with use_clock(VirtualClock()):
        with pytest.raises(dist.RendezvousError, match="1/3"):
            store.rendezvous(dist.HostInfo("h0", 0, 2), expected=3,
                             coordinator=True, timeout_s=2.0)


# ----------------------------------------------------------- host detection


def test_lease_expiry_fires_host_lost_exactly_once():
    clock = VirtualClock()
    losses = []
    mon = dist.HeartbeatMonitor(
        ["h0", "h1", "h2"], lease_s=2.0, clock=clock.monotonic,
        on_lost=lambda h, rec: losses.append((h, rec)), self_id="h0")
    before = _dist_counters()
    clock.advance(1.5)
    mon.beat("h1")
    mon.beat("h2")
    assert mon.check_now() == []
    clock.advance(1.5)
    mon.beat("h1")  # h2 goes silent
    assert mon.check_now() == []
    clock.advance(1.0)
    assert mon.check_now() == ["h2"]
    clock.advance(100.0)
    mon.beat("h1")
    assert mon.check_now() == []
    after = _dist_counters()
    assert _delta(before, after, "dist.host.lost") == 1
    assert _delta(before, after, "dist.host.lost.h2") == 1
    assert [h for h, _ in losses] == ["h2"]
    assert losses[0][1]["kind"] == "lease_expired"
    assert losses[0][1]["lease_s"] == 2.0
    assert mon.alive() == ["h0", "h1"]
    assert "h0" not in mon.lost


def test_heartbeat_fault_drops_beat():
    mon = dist.HeartbeatMonitor(["h0"], lease_s=5.0)
    before = _dist_counters()
    with FAULTS.arm(FaultPlan(seed=5).on("dist.heartbeat", nth=[0])):
        assert mon.beat("h0") is False
        assert mon.beat("h0") is True
    after = _dist_counters()
    assert _delta(before, after, "dist.heartbeat.missed") == 1
    assert FAULTS.fires.get("dist.heartbeat") == 1


def test_ingest_uses_sequence_advance_not_wall_clocks():
    clock = VirtualClock()
    mon = dist.HeartbeatMonitor(["h1"], lease_s=2.0,
                                clock=clock.monotonic)
    mon.ingest({"h1": 7})
    clock.advance(1.5)
    mon.ingest({"h1": 7})  # same seq: stale, lease keeps aging
    clock.advance(1.0)
    assert mon.check_now() == ["h1"]


def test_monitor_thread_lifecycle(tmp_path):
    store = dist.MembershipStore(tmp_path)
    store.heartbeat("h1")
    mon = dist.HeartbeatMonitor(["h1"], lease_s=30.0, poll_s=0.01,
                                source=store.read_beats)
    with mon:
        assert mon.running
    assert not mon.running
    assert mon.alive() == ["h1"]


# -------------------------------------------------------- deadline guard


def test_run_with_deadline_result_error_and_timeout():
    assert dist.run_with_deadline(lambda: 42, 5.0, name="x") == 42
    assert dist.run_with_deadline(lambda: 42, None, name="x") == 42
    with pytest.raises(KeyError):
        dist.run_with_deadline(lambda: {}["missing"], 5.0, name="x")
    before = _dist_counters()
    with pytest.raises(dist.CollectiveTimeout, match="hang budget"):
        dist.run_with_deadline(lambda: time.sleep(0.4), 0.05, name="x")
    after = _dist_counters()
    assert _delta(before, after, "dist.collective.overrun") == 1


def test_barrier_without_a_group_has_nothing_to_wait_for():
    import torch.distributed as tdist

    if tdist.is_initialized():
        pytest.skip("a process group is up in this worker")
    dist.barrier("alone", timeout_s=1.0)


# ------------------------------------------------------- elastic training


@pytest.fixture(scope="module")
def elastic_ranks(tmp_path_factory):
    """4 ranks of the 3D trainer at (data 4): rank 1 dies at schedule
    step 2, the survivors shrink to (data 3) and finish."""
    cfg = dict(vocab_size=64, embed_dim=16, num_layers=2, num_heads=2,
               max_len=8)
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.transformer import transformer_lm

    torch.manual_seed(0)
    from mmlspark_tpu_torch.models.bundle import init_state_dict

    model = transformer_lm(**cfg)
    init_state_dict(model, 0)
    toks = np.random.default_rng(0).integers(0, 64, size=(48, 8))
    inputs = {"cfg": cfg, "params": T.lm_params_tree(model),
              "tokens": toks}
    return inputs, run_ranks("elastic", inputs,
                             tmp_path_factory.mktemp("elastic"))


@pytest.mark.chaos
def test_elastic_shrink_and_resume(elastic_ranks):
    """The dead rank's peers: guard ledger + quarantine.json, epoch 2
    over the survivors, the group regrouped to 3 ranks and the plan
    rebuilt (data 4 -> 3), the schedule completed (4 optimizer steps,
    no duplicate) with a finite loss — and the weights those of the
    uninterrupted schedule, to float order."""
    from mmlspark_tpu_torch.models import training as T
    from mmlspark_tpu_torch.models.transformer import transformer_lm
    from mmlspark_tpu_torch.parallel.sharding_rules import \
        tree_leaves_with_path

    inputs, results = elastic_ranks
    assert results[1]["died"] in ("InjectedCrash", "StaleMembershipError")
    survivors = [r for r in results if not r["died"]]
    assert [r["rank"] for r in survivors] == [0, 2, 3]
    for r in survivors:
        assert r["fires"].get("training.host_lost") == 1
        assert r["lost"] == ["h1"]
        assert r["epoch"] == 2 and r["hosts"] == ["h0", "h2", "h3"]
        assert [d for _rank, d in r["rebuilds"]] == [3]
        assert r["step"] == 4
        assert np.isfinite(r["loss"])
        assert r["rollbacks"] == 0 and r["lr_scale"] == 1.0
    assert sorted(rank for r in survivors for rank, _d in r["rebuilds"]) \
        == [0, 1, 2]
    qdoc = survivors[0]["qdoc"]
    assert qdoc["lost_hosts"] and qdoc["lost_hosts"][0]["host_id"] == "h1"
    assert qdoc["lost_hosts"][0]["epoch"] == 2
    assert survivors[0]["published"]["epoch"] == 2

    # the uninterrupted schedule on one process: the same 4 batches
    model = T.load_lm_params(transformer_lm(**inputs["cfg"]),
                             inputs["params"])
    ref = T.TrainState.create(model, T.sgd(0.1), device="cpu")
    toks = torch.from_numpy(inputs["tokens"])
    order = np.random.default_rng([0, 0]).permutation(len(toks))
    for b in range(4):
        batch = toks[order[b * 12:(b + 1) * 12]]
        logits, _ = ref.work(batch)
        T.lm_loss(logits, batch).backward()
        ref.apply_gradients()
    want = {"/".join(p): v for p, v in
            tree_leaves_with_path(T.lm_params_tree(ref.module))}
    for r in survivors:
        got = {"/".join(p): v for p, v in tree_leaves_with_path(r["params"])}
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=1e-5,
                                       rtol=1e-5)


def test_elastic_follower_adopts_published_epoch(tmp_path):
    store = dist.MembershipStore(tmp_path)
    hosts = [dist.HostInfo(f"h{i}", i, 2) for i in range(3)]
    view = store.publish(dist.MembershipView(1, hosts))
    mon = dist.HeartbeatMonitor([h.host_id for h in hosts],
                                lease_s=1e9, self_id="h0")
    coord = dist.ElasticContext(hosts[0], view, store=store, monitor=mon,
                                coordinator=True)
    follower = dist.ElasticContext(hosts[1], view, store=store,
                                   coordinator=False)
    assert coord.poll() is None and follower.poll() is None

    mon.declare_lost("h2", {"kind": "injected"})
    lost = coord.poll()
    assert lost == ["h2"]
    assert coord.commit_loss(lost).epoch == 2
    assert store.load().epoch == 2

    assert follower.poll() == ["h2"]
    assert follower.view.epoch == 2
    assert follower.commit_loss(["h2"]).epoch == 2

    # the lost host itself, polling late, finds itself fenced off
    lost_host = dist.ElasticContext(hosts[2], view, store=store,
                                    coordinator=False)
    with pytest.raises(dist.StaleMembershipError, match="h2"):
        lost_host.poll()


def test_injected_host_loss_picks_the_same_victim_on_every_rank():
    """SPMD: every rank crosses `training.host_lost` at the same step, and
    each must declare the SAME peer — the first live host that is not
    the coordinator (never itself)."""
    hosts = [dist.HostInfo(f"h{i}", i, 1) for i in range(4)]
    view = dist.MembershipView(1, hosts)
    picked = []
    for me in hosts:
        ctx = dist.ElasticContext(me, view, coordinator=me.process_index == 0)
        with FAULTS.arm(FaultPlan(seed=1).on("training.host_lost", nth=[0])):
            picked.append(ctx.poll())
    assert picked[0] == picked[2] == picked[3] == ["h1"]
    assert picked[1] == ["h2"]  # the victim itself names the next one


def test_host_telemetry_server_serves_snapshot_wire_format():
    core_telemetry.incr("dist.rendezvous.attempt")
    srv = dist.HostTelemetryServer("h0")
    try:
        host, port = srv.start()
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics.json", timeout=10) as r:
            snap = json.load(r)
        assert snap["counters"]["dist.rendezvous.attempt"] >= 1
        assert "gauges" in snap and "histograms" in snap
        with urllib.request.urlopen(
                f"http://{host}:{port}/health", timeout=10) as r:
            assert json.load(r)["host_id"] == "h0"
    finally:
        srv.stop()

    from mmlspark_tpu_torch.core.telemetry.fleet import merge_snapshots
    merged = merge_snapshots({"h0": snap, "h1": snap})
    assert (merged["counters"]["dist.rendezvous.attempt"]
            == 2 * snap["counters"]["dist.rendezvous.attempt"])


def test_cuda_entry_points_raise_without_a_card_and_never_pick_gloo():
    """The mesh, ring and 3D entry points default to cuda + nccl: without
    a card they raise, before any process group is started for them."""
    import torch.distributed as tdist

    from mmlspark_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    assert not torch.cuda.is_available()
    had = tdist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshPlan(1, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.initialize_distributed("127.0.0.1:1", 1, 0, max_attempts=1)
    dist.reset_distributed_state()
    assert tdist.is_initialized() == had
