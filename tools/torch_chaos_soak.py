"""Chaos soak on mmlspark_tpu_torch: live HTTP serving, and the flow
runtime with the h2d leg, under a seeded fault plan.

The port's counterpart of tools/chaos_soak.py's default, `--gateway` and
`--flow` modes (same scenarios, sizes and assertions; it imports
mmlspark_tpu_torch only).  The default mode runs a real ServingServer
whose model computes through a DeviceFeed on `device` (the card unless
``device="cpu"``), so host->device copies cross the `feed.device_put`
fault point, while a burst of concurrent clients posts requests:

  * `feed.device_put` fails with >= 10% probability (bounded by
    `max_failures`) — exercising the transfer retry ladder;
  * `serving.batch_loop` takes exact-index `InjectedCrash`es — killing
    the consumer thread mid-batch so the supervisor + epoch replay path
    must absorb them;
  * the intake queue is small, so the burst sheds (503 + Retry-After);
  * a few requests carry an already-expired `X-Deadline-Ms` and must be
    failed fast with 504, never computed.

EVERY accepted request is answered exactly once with the correct
payload; nothing is lost and nothing is duplicated.

Usage: python tools/torch_chaos_soak.py [--seed N] [--requests N]
                                        [--gateway] [--flow]
                                        [--device cpu] [--json]
`--gateway` runs the same plan with two replicas behind the fleet
gateway (serving/fleet.py).  `--flow` soaks the flow runtime
(core/flow.py) directly: a bounded AdmissionStage, a multi-stage
FlowGraph with seeded faults at EVERY registered `flow.*` point, and the
h2d leg — a DeviceFeed behind an `H2DStage` graph, meshed when a process
group is up (each rank its own rows, the `"sharded"` strategy), with
`feed.shard_put` failing at probability 1 and one transient
`feed.device_put` fault: the shard ladder exhausts, the feed degrades
stickily to coalesced, and every item still arrives in order.
Also importable (tests/test_torch_soaks.py, chip_smoke.py): run_soak(...)
/ run_flow_soak(...) return the summary.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _make_model(device=None):
    """Transformer whose compute goes host->device through DeviceFeed."""
    import numpy as np

    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
    from mmlspark_tpu_torch.io.feed import DeviceFeed

    feed = DeviceFeed(device)

    def fn(table):
        v = np.asarray(table["v"], np.float32)
        dv = feed.put(v)                 # crosses feed.device_put
        y = (dv * 3.0).cpu().numpy()
        return table.with_column("y", y.astype(np.int64))

    model = LambdaTransformer(fn)
    model._soak_feed = feed              # expose degrade flag to the report
    return model


def run_soak(seed: int = 7, n_requests: int = 48, max_queue: int = 8,
             transfer_fail_p: float = 0.2, crash_nth=(1, 4, 8),
             n_expired: int = 3, gateway: bool = False,
             device=None) -> dict:
    """One seeded soak; returns a JSON-able summary dict.  Raises
    AssertionError if any robustness invariant is violated.

    `gateway=True` runs the same fault plan with TWO replicas behind a
    FleetGateway (serving/fleet.py) and drives all traffic through the
    gateway: the exactly-once/payload invariants are unchanged, but the
    shed and deadline accounting moves — the gateway retries a replica's
    503 on the alternate (so replica-level sheds >= client-observed
    503s) and fails an already-expired budget at the gateway without
    forwarding (serving.fleet.deadline_expired)."""
    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.io.http.clients import send_request
    from mmlspark_tpu_torch.io.http.schema import to_http_request
    from mmlspark_tpu_torch.serving.server import ServingServer
    from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan, InjectedCrash

    telemetry.reset_counters()
    model = _make_model(device)

    def make_server(m):
        return ServingServer(
            m, reply_col="y", name="chaos-soak", path="/soak",
            input_schema=["v"], max_batch=4, batch_timeout_ms=20.0,
            # every crash costs one attempt on the whole batch: the budget
            # must cover len(crash_nth) replays of an unlucky request plus
            # the original try, or a thrice-crashed request 500s
            max_attempts=len(crash_nth) + 2,
            max_queue=max_queue)

    srv = make_server(model)
    servers = [srv]
    gw = None
    if gateway:
        import random

        from mmlspark_tpu_torch.serving import FleetGateway

        servers.append(make_server(_make_model(device)))
        gw = FleetGateway(name="chaos-gw", path="/soak",
                          probe_interval_s=0.1, retries=2,
                          rng=random.Random(seed))
    plan = (FaultPlan(seed=seed)
            .on("feed.device_put", probability=transfer_fail_p,
                max_failures=max(4, n_requests // 4))
            .on("serving.batch_loop", nth=list(crash_nth),
                error=InjectedCrash))

    results: list = [None] * (n_requests + n_expired)

    def post(url, payload, i, headers=None):
        try:
            results[i] = send_request(
                to_http_request(url, payload, headers=headers), timeout=30)
        except Exception as e:  # noqa: BLE001 — a lost reply must surface
            results[i] = e

    # the injected consumer crashes are EXPECTED thread deaths: keep
    # their tracebacks out of the report (and out of pytest's
    # unhandled-thread-exception warnings); anything else still prints
    prev_hook = threading.excepthook

    def quiet_injected(args):
        if not issubclass(args.exc_type, InjectedCrash):
            prev_hook(args)

    threading.excepthook = quiet_injected
    info = srv.start()
    if gateway:
        servers[1].start()
        for s in servers:
            gw.add_server(s, version="v1")
        info = gw.start()
    try:
        with FAULTS.arm(plan):
            threads = [
                threading.Thread(target=post, daemon=True,
                                 name=f"chaos-soak-client-{i}",
                                 args=(info.url, {"v": i}, i))
                for i in range(n_requests)
            ]
            # waves, not one thundering herd: the consumer must get a
            # chance to both COMPUTE (200s) and shed (503s) — a single
            # instantaneous burst just fills the queue once and sheds
            # everything else, proving only the shed path
            for w in range(0, n_requests, 8):
                for t in threads[w:w + 8]:
                    t.start()
                time.sleep(0.08)
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads), \
                "client thread still waiting: a reply was lost"
            # already-expired deadlines AFTER the burst (the drained
            # queue admits them, so the 504 path — not the 503 shed —
            # must be the thing that stops them being computed)
            for j in range(n_expired):
                post(info.url, {"v": -1}, n_requests + j,
                     headers={"X-Deadline-Ms": "0"})
            if gw is not None:
                gw.stop()
            for s in servers:
                s.stop()  # graceful drain: no accepted request stranded
    finally:
        threading.excepthook = prev_hook
        if gw is not None and gw._running.is_set():
            gw.stop()
        for s in servers:
            if s._running.is_set():
                s.stop(drain=False)

    # ---- invariants ----------------------------------------------------
    lost = [i for i, r in enumerate(results) if r is None]
    errors = [(i, r) for i, r in enumerate(results)
              if isinstance(r, Exception)]
    assert not lost and not errors, \
        f"lost replies: {lost}, transport errors: {errors}"
    ok = [i for i in range(n_requests) if results[i].status_code == 200]
    shed = [i for i in range(n_requests) if results[i].status_code == 503]
    other = [(i, results[i].status_code) for i in range(n_requests)
             if results[i].status_code not in (200, 503)]
    assert not other, f"unexpected statuses (accepted but not answered " \
                      f"OK, or mis-shed): {other}"
    # every ACCEPTED request answered exactly once, with the right value
    # (the client socket gives at-most-once; the payload check proves the
    # reply is THIS request's, i.e. replay never cross-wired ids)
    for i in ok:
        got = results[i].json()["y"]
        assert got == 3 * i, f"request {i}: wrong payload {got}"
    for i in shed:
        ra = (results[i].headers.get("Retry-After")
              or results[i].headers.get("retry-after"))
        assert ra is not None, f"shed request {i} missing Retry-After"
    for j in range(n_expired):
        r = results[n_requests + j]
        assert r.status_code == 504, \
            f"expired-deadline request got {r.status_code}, want 504"
    fires = dict(FAULTS.fires)
    assert fires.get("serving.batch_loop", 0) >= len(crash_nth), \
        "batch-loop crashes did not all fire"
    assert fires.get("feed.device_put", 0) > 0, \
        "no transfer faults fired — the soak proved nothing"

    # ---- registry snapshot assertions ----------------------------------
    # the fault counters flow through the metrics registry now: assert on
    # the exported snapshot, not a raw counters() dict, so the soak also
    # proves the one-registry wiring (incr -> snapshot -> /metrics)
    snapshot = telemetry.export_snapshot()
    snap_counters = snapshot["counters"]
    assert snap_counters.get("faults.injected", 0) == sum(fires.values()), \
        (f"registry faults.injected {snap_counters.get('faults.injected')} "
         f"!= fault-injector fires {sum(fires.values())}")
    if gateway:
        # the gateway retries a replica's 503 on the alternate, so some
        # replica-level sheds never reach a client; and an already-
        # expired budget 504s AT the gateway, never forwarded
        assert snap_counters.get("serving.shed", 0) >= len(shed), \
            (f"registry serving.shed {snap_counters.get('serving.shed')} "
             f"< client-observed 503s {len(shed)}")
        expired_total = (snap_counters.get("serving.fleet.deadline_expired",
                                           0)
                         + snap_counters.get("serving.deadline_expired", 0))
        assert expired_total >= n_expired, \
            "deadline expiries missing from the registry snapshot"
    else:
        assert snap_counters.get("serving.shed", 0) == len(shed), \
            (f"registry serving.shed {snap_counters.get('serving.shed')} "
             f"!= observed 503s {len(shed)}")
        assert snap_counters.get("serving.deadline_expired",
                                 0) >= n_expired, \
            "deadline expiries missing from the registry snapshot"
    assert any(k.startswith("serving.request.latency")
               for k in snapshot["histograms"]), \
        "serving.request.latency histogram missing from the snapshot"

    return {
        "seed": seed,
        "gateway": gateway,
        "requests": n_requests + n_expired,
        "answered_200": len(ok),
        "shed_503": len(shed),
        "deadline_504": n_expired,
        "lost": 0,
        "duplicated": 0,
        "feed_degraded": bool(model._soak_feed.degraded),
        "faults_fired": fires,
        "recoveries": sum(s.stats["recoveries"] for s in servers),
        "replayed": sum(s.stats["replayed"] for s in servers),
        "counters": snap_counters,
        "gauges": snapshot["gauges"],
        "latency_p95_s": {
            k: v["p95"] for k, v in snapshot["histograms"].items()
            if k.startswith("serving.request.latency")},
    }


def _host(y):
    """A delivered tensor (a DTensor gathered whole) as a host array."""
    if hasattr(y, "full_tensor"):
        y = y.full_tensor()
    return y.cpu().numpy()


def run_flow_soak(seed: int = 7, n_items: int = 48, max_pending: int = 24,
                  n_expired: int = 4, n_tight: int = 4, device=None) -> dict:
    """Soak the graftflow runtime (core/flow.py) under seeded faults at
    every registered `flow.*` point PLUS the feed's transfer points
    (`io.feed.FEED_FAULT_POINTS`); returns a JSON-able summary dict,
    raises AssertionError on any violated invariant.

    The arming loop enumerates both registries, so a newly added flow
    stage or feed fault point is covered automatically — unscripted
    points get a harmless fire-once rule, and the exact fire-count
    reconciliation (`faults.injected == sum(fires)`) cannot go stale.
    After the flow-graph ledger, an h2d leg drives a meshed DeviceFeed
    through an `H2DStage` graph with every sharded attempt failing: the
    per-shard retry ladder must exhaust, degrade stickily to the
    coalesced rung, and still deliver every array byte-identical with a
    transient `feed.device_put` fault absorbed on the way.

    The ledger it proves:

      * every offered item lands in EXACTLY one bucket — shed at
        admission (Overloaded), reaped at intake (expired before
        admission), expired mid-graph (an `Expired` marker in its
        slot), or delivered with the correct payload;
      * delivered/expired slots come out in feed order (the reorder
        contract survives retries, faults, and expiry);
      * observed queue depths never exceed the declared credit budgets;
      * `flow.shed.admission` / `flow.expired.*` / `faults.injected`
        in the exported snapshot equal the observed ledger exactly.

    Runs under a `VirtualClock`: injected latency and retry backoffs
    advance virtual time only, so deadline lapses are scripted and the
    soak resolves in milliseconds of wall time."""
    import numpy as np
    import torch.distributed as dist

    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.core.flow import (AdmissionStage, Expired,
                                              FlowGraph, FlowItem, Stage,
                                              StagePolicy, flow_fault_points)
    from mmlspark_tpu_torch.io.feed import (FEED_FAULT_POINTS, DeviceFeed,
                                            FeedTelemetry)
    from mmlspark_tpu_torch.utils.fault_tolerance import Overloaded
    from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan,
                                                 InjectedFault, VirtualClock,
                                                 monotonic, use_clock)

    telemetry.reset_counters()
    clock = VirtualClock()
    with use_clock(clock):
        intake = AdmissionStage(max_pending=max_pending, label="flow-soak")
        policy = StagePolicy(retries=3, backoff_s=0.001)
        graph = FlowGraph(
            [Stage(name="decode", fn=lambda t: (t[0], t[1] * 2),
                   workers=1, credits=4, policy=policy),
             Stage(name="assemble", fn=lambda t: (t[0], t[1] + 1),
                   workers=2, credits=4, policy=policy),
             Stage(name="emit", fn=lambda t: t,
                   workers=1, credits=4, policy=policy)],
            queue_size=8, span_prefix="flow")
        # the h2d leg: a feed behind an H2DStage graph, built BEFORE the
        # plan so its `flow.h2d` point is registered and armed like every
        # other stage.  Inside a process group the feed is meshed and
        # takes the shard engine by directive ("sharded"): each rank puts
        # its one shard, so the shard ladder is exercised at any world
        # size, one card included
        meshed = dist.is_available() and dist.is_initialized()
        mesh = None
        if meshed:
            from mmlspark_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(device=device)
        feed = DeviceFeed(device=device, mesh=mesh,
                          telemetry=FeedTelemetry(), transfer_retries=3,
                          shard_strategy="sharded" if meshed
                          else "coalesced")
        h2d_graph = FlowGraph([feed.stage()], queue_size=8,
                              span_prefix="flow")
        # arm EVERY registered flow.* point plus the feed's transfer
        # points; each flow error rule fires at most retries-1 times so
        # no single item can exhaust its StagePolicy ladder whatever the
        # thread interleaving.  The decode rule is latency-only: one
        # injected 1s stall (virtual) lapses the medium deadlines
        # mid-graph — the shed must then happen at the NEXT boundary,
        # never silently drop the slot.  The shard rule is the opposite
        # by design: EVERY sharded attempt fails, so the per-shard
        # ladder exhausts and the feed must take its sticky
        # shard->coalesced degrade rung (then absorb one transient
        # coalesced-put fault via the transfer retry ladder).
        config = {
            "flow.admission": dict(nth=[2, 19]),
            "flow.decode": dict(nth=[1], latency_s=1.0, error=None),
            "flow.assemble": dict(nth=[2, 11]),
            "flow.emit": dict(nth=[3, 12]),
            "feed.shard_put": dict(probability=1.0),
            "feed.device_put": dict(nth=[1]),
        }
        armable = tuple(flow_fault_points()) + tuple(
            p for p in FEED_FAULT_POINTS if p not in flow_fault_points())
        plan = FaultPlan(seed=seed)
        for p in armable:
            # points registered by other graphs in this process get a
            # harmless latency-0 rule: armed, never consequential
            plan.on(p, **config.get(p, dict(nth=[0], latency_s=0.0,
                                            error=None)))
        missing = [p for p in config if p not in armable]
        assert not missing, f"expected fault points unregistered: {missing}"

        outcomes: dict = {}  # item id -> "accepted" | "shed"

        def offer(rec, i):
            for _ in range(4):  # an injected admission fault is transient
                try:
                    intake.offer(rec)
                    outcomes[i] = "accepted"
                    return
                except InjectedFault:
                    continue
                except Overloaded:
                    outcomes[i] = "shed"
                    return
            raise AssertionError("admission fault retries exhausted")

        total = n_tight + n_expired + n_items
        with FAULTS.arm(plan):
            # tight + medium budgets are offered first (room guaranteed):
            # tights lapse BEFORE admission and must be reaped at intake,
            # mediums lapse mid-graph when the latency fault fires
            next_id = 0
            for _ in range(n_tight):
                offer(((next_id, next_id), monotonic() + 0.05), next_id)
                next_id += 1
            for _ in range(n_expired):
                offer(((next_id, next_id), monotonic() + 0.5), next_id)
                next_id += 1
            # burst: concurrent unbudgeted offers with NO draining — the
            # bounded intake must shed everything past max_pending
            threads = [
                threading.Thread(
                    target=offer, daemon=True,
                    name=f"flow-soak-client-{i}",
                    args=(((i, i), None), i))
                for i in range(next_id, total)
            ]
            for w in range(0, len(threads), 8):
                for t in threads[w:w + 8]:
                    t.start()
                time.sleep(0.02)
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads), \
                "offer thread still waiting: an admission was lost"
            intake.drain_to_buffer()
            clock.advance(0.1)  # tights lapse; mediums (0.5s) survive
            reaped: list = []
            intake.reap_expired(lambda it: it[1], reaped.append)
            fed: list = []
            intake.drain_all(fed.append)
            out = list(graph.run(
                (FlowItem(val, dl) for val, dl in fed),
                yield_expired=True))
            # ---- the h2d leg: same plan, the feed's fault points ------
            n_h2d = 6
            dp = feed._dp()
            h2d_in = [np.full((4 * dp, 3), float(i), np.float32)
                      for i in range(n_h2d)]
            h2d_out = [_host(y) for y in h2d_graph.run(list(h2d_in))]
        fires = dict(FAULTS.fires)

    # ---- the ledger ------------------------------------------------------
    shed = [i for i, o in outcomes.items() if o == "shed"]
    accepted = [i for i, o in outcomes.items() if o == "accepted"]
    assert len(outcomes) == total, \
        f"offers lost: {total - len(outcomes)} items have no outcome"
    assert len(shed) + len(accepted) == total
    assert shed, "no admissions shed — the bounded intake proved nothing"
    assert len(reaped) == n_tight, \
        f"reaped {len(reaped)} tight deadlines at intake, want {n_tight}"
    assert len(fed) == len(accepted) - n_tight
    # ordered, exactly-once emission: slot i of `out` answers item i of
    # `fed` — delivered values are the full transform, expired markers
    # keep the item's id (shed at the next boundary, slot preserved)
    assert len(out) == len(fed), \
        f"graph emitted {len(out)} slots for {len(fed)} items"
    markers = []
    for (val, dl), got in zip(fed, out):
        if isinstance(got, Expired):
            assert got.value[0] == val[0], \
                f"expired marker cross-wired: {got.value[0]} != {val[0]}"
            assert dl is not None, "an unbudgeted item expired"
            markers.append(got)
        else:
            assert got == (val[0], val[1] * 2 + 1), \
                f"item {val[0]}: wrong payload {got}"
    assert markers, "no mid-graph expiries — the latency fault proved " \
                    "nothing"
    # credit budgets held: no hand-off queue ever exceeded its budget
    hw = graph.high_water()
    for name in ("decode", "assemble", "emit"):
        assert hw.get(name, 0) <= 4, f"{name} depth {hw[name]} > credits 4"
    assert hw.get("out", 0) <= 8
    # every consequential fault point fired its scripted schedule
    assert fires.get("flow.admission", 0) == 2
    assert fires.get("flow.decode", 0) == 1
    assert fires.get("flow.assemble", 0) == 2
    assert fires.get("flow.emit", 0) == 2

    # ---- the h2d leg's ledger --------------------------------------------
    # every array delivered exactly once, in order, byte-identical —
    # through the exhausted shard ladder, the sticky degrade, and the
    # retried coalesced-put fault
    assert len(h2d_out) == n_h2d, \
        f"h2d graph emitted {len(h2d_out)} arrays for {n_h2d} items"
    for want, got in zip(h2d_in, h2d_out):
        np.testing.assert_array_equal(got, want)
    # the harmless fire-once rule on flow.h2d proves the stage's point
    # is armed; the transient feed.device_put fault was absorbed by the
    # transfer retry ladder (fired exactly once, nothing degraded)
    assert fires.get("flow.h2d", 0) == 1
    assert fires.get("feed.device_put", 0) == 1
    assert not feed.degraded, "a retried transient put degraded the feed"
    if meshed:
        # the shard script: this rank's one shard x transfer_retries
        # attempts, every one failed -> ShardTransferError -> sticky shard
        # degrade; no later put re-enters the shard engine
        assert feed.shard_degraded, "shard faults never degraded the feed"
        assert fires.get("feed.shard_put", 0) == 3, \
            (f"feed.shard_put fired {fires.get('feed.shard_put')} times, "
             "want 3 (every attempt of this rank's shard)")
    else:
        assert fires.get("feed.shard_put", 0) == 0

    # ---- registry snapshot reconciliation --------------------------------
    snapshot = telemetry.export_snapshot()
    c = snapshot["counters"]
    assert c.get("flow.shed.admission", 0) == len(shed), \
        (f"flow.shed.admission {c.get('flow.shed.admission')} != "
         f"observed sheds {len(shed)}")
    assert c.get("flow.shed", 0) == len(shed)
    assert c.get("flow.expired.admission", 0) == len(reaped)
    assert c.get("flow.expired", 0) == len(reaped) + len(markers), \
        (f"flow.expired {c.get('flow.expired')} != reaped {len(reaped)} "
         f"+ mid-graph markers {len(markers)}")
    assert c.get("faults.injected", 0) == sum(fires.values()), \
        (f"registry faults.injected {c.get('faults.injected')} != "
         f"fault-injector fires {sum(fires.values())}")
    per_stage_expired = sum(v for k, v in c.items()
                            if k.startswith("flow.expired.")
                            and k != "flow.expired.admission")
    assert per_stage_expired == len(markers), \
        "per-stage flow.expired.* rows do not sum to the marker count"
    assert c.get("feed.shard_degraded", 0) == (1 if meshed else 0), \
        "feed.shard_degraded counter disagrees with the observed degrade"

    return {
        "seed": seed,
        "mode": "flow",
        "offered": total,
        "accepted": len(accepted),
        "shed": len(shed),
        "reaped_at_intake": len(reaped),
        "expired_mid_graph": len(markers),
        "delivered": len(fed) - len(markers),
        "lost": 0,
        "duplicated": 0,
        "h2d_delivered": len(h2d_out),
        "h2d_data_degree": dp,
        "h2d_shard_degraded": bool(feed.shard_degraded),
        "armed_points": list(armable),
        "faults_fired": fires,
        "high_water": hw,
        "counters": c,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-queue", type=int, default=8)
    ap.add_argument("--gateway", action="store_true",
                    help="two replicas behind the fleet gateway")
    ap.add_argument("--flow", action="store_true",
                    help="soak the flow runtime and the h2d leg instead "
                         "of the HTTP stack")
    ap.add_argument("--max-pending", type=int, default=24,
                    help="--flow: the admission bound")
    ap.add_argument("--device", default=None,
                    help="the feed's device: the card unless 'cpu'")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON")
    args = ap.parse_args(argv)
    if args.flow:
        report = run_flow_soak(seed=args.seed, n_items=args.requests,
                               max_pending=args.max_pending,
                               device=args.device)
    else:
        report = run_soak(seed=args.seed, n_requests=args.requests,
                          max_queue=args.max_queue, gateway=args.gateway,
                          device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print("chaos-soak OK:", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
