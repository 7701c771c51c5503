"""The port's soak tools (tools/torch_fleet_soak.py, tools/torch_chaos_soak.py)
at the sizes of the JAX package's soak tests (tests/test_fleet.py:558-577,
tests/test_chaos.py's run_soak, tests/test_graftsan.py's flow soak), on
the CPU: the fleet's kill and revive, the HTTP soak alone and behind the
gateway, the observability plane's kill -> alert -> autoscale ->
incident -> resolve, and the flow soak with its h2d leg — unmeshed, and
meshed inside a world-1 gloo group, where the shard ladder exhausts and
the feed degrades stickily to coalesced.  Each tool asserts its own
invariants (0 lost, 0 duplicated, the counters reconciled); these tests
re-check the summaries.  Seeded; the flow soak runs on a virtual clock.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)


def _load_tool(name):
    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.chaos
def test_fleet_soak_kill_and_revive_exactly_once():
    soak = _load_tool("torch_fleet_soak")
    report = soak.run_soak(seed=7, n_requests=30, kill_after=8,
                           n_verify=12, device="cpu")
    assert report["lost"] == 0 and report["duplicated"] == 0
    assert report["ejects"] >= 1
    assert report["reinstates"] >= 1
    assert report["revived_served"] > 0


@pytest.mark.chaos
def test_chaos_soak_gateway_mode_exactly_once():
    soak = _load_tool("torch_chaos_soak")
    report = soak.run_soak(seed=11, n_requests=24, max_queue=6,
                           gateway=True, device="cpu")
    assert report["gateway"] is True
    assert report["lost"] == 0 and report["duplicated"] == 0
    assert report["answered_200"] + report["shed_503"] == 24


@pytest.mark.chaos
def test_chaos_soak_exactly_once():
    soak = _load_tool("torch_chaos_soak")
    summary = soak.run_soak(seed=7, n_requests=24, max_queue=6, device="cpu")
    assert summary["answered_200"] + summary["shed_503"] == 24
    assert summary["lost"] == 0
    assert summary["faults_fired"]["serving.batch_loop"] >= 2
    assert summary["faults_fired"]["feed.device_put"] >= 1
    assert summary["recoveries"] >= 2
    assert json.dumps(summary)


@pytest.mark.chaos
def test_obs_soak_alert_autoscale_incident_resolve():
    soak = _load_tool("torch_fleet_soak")
    report = soak.run_obs_soak(seed=7, n_requests=40, kill_after=12,
                               n_verify=24, device="cpu")
    assert report["lost"] == 0 and report["duplicated"] == 0
    assert report["provisioned"] >= 1 and report["incidents"] >= 1
    assert report["alert_fired_after_s"] <= report["fast_window_s"] + 0.5


@pytest.mark.chaos
def test_flow_soak_without_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    soak = _load_tool("torch_chaos_soak")
    s = soak.run_flow_soak(seed=7, n_items=48, device="cpu")
    assert s["lost"] == 0 and s["duplicated"] == 0
    assert s["h2d_delivered"] == 6 and not s["h2d_shard_degraded"]
    assert s["faults_fired"].get("feed.shard_put", 0) == 0
    assert s["faults_fired"]["feed.device_put"] == 1


@pytest.mark.chaos
def test_flow_soak_h2d_leg_degrades_on_a_world1_mesh():
    from torch_world1 import world1_gloo

    soak = _load_tool("torch_chaos_soak")
    with world1_gloo():
        s = soak.run_flow_soak(seed=7, n_items=48, device="cpu")
    assert s["lost"] == 0 and s["duplicated"] == 0
    assert s["h2d_delivered"] == 6 and s["h2d_shard_degraded"]
    assert s["h2d_data_degree"] == 1
    assert s["faults_fired"]["feed.shard_put"] == 3
    assert s["counters"]["feed.shard_degraded"] == 1
    assert "feed.shard_put" in s["armed_points"]
