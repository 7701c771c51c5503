"""The port's training guard (mmlspark_tpu_torch.models.guard) against the
JAX package's: the scenarios of tests/test_train_guard.py's guard tests.
Each (loss, grad_norm) stream goes through both guards, which must take
the same actions, quarantine the same batches and back the learning rate
off alike; the persisted quarantine ledger is read across; the hung-step
watchdog fires once and joins, its budget taken from the step-latency
histogram of the port's registry.
"""
import math
import time

import pytest

from mmlspark_tpu.models import guard as JG
from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models import guard as PG

NAN, INF = float("nan"), float("inf")


def _counter(name):
    return telemetry.counters().get(name, 0)


def _healthy():
    return [(i, 1.0 + 0.01 * (i % 5), None) for i in range(32)]


def _spike_stream():
    return ([(i, 1.0, None) for i in range(8)]
            + [(100, 50.0, None), (101, 50.0, None), (102, 50.0, None)])


def _spike_reset_stream():
    return ([(i, 1.0, None) for i in range(8)]
            + [(50, 99.0, None), (51, 1.0, None), (52, 99.0, None)])


# name: (guard kwargs, stream of (batch_id, loss, grad_norm), expected
# actions, quarantined, rollbacks, lr_scale)
SCENARIOS = {
    "healthy_stream_is_silent": (
        dict(min_history=4), _healthy(), ["ok"] * 32, set(), 0, 1.0),
    "nonfinite_loss_quarantines_and_rolls_back": (
        dict(), [(7, NAN, None)], ["rollback"], {7}, 1, 0.5),
    "nonfinite_grad_detected_separately": (
        dict(), [(3, 0.5, INF)], ["rollback"], {3}, 1, 0.5),
    "spike_records_then_escalates_on_patience": (
        dict(min_history=8, window=16, spike_mads=6.0, spike_floor=0.1,
             spike_patience=3), _spike_stream(),
        ["ok"] * 8 + ["record", "record", "rollback"], {102}, 1, 0.5),
    "healthy_step_resets_the_spike_streak": (
        dict(min_history=8, spike_patience=2), _spike_reset_stream(),
        ["ok"] * 8 + ["record", "ok", "record"], set(), 0, 1.0),
    "aborts_after_rollback_budget": (
        dict(max_rollbacks=2), [(0, NAN, None), (1, NAN, None),
                                (2, NAN, None)],
        ["rollback", "rollback", "abort"], {0, 1, 2}, 2, 0.25),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guard_takes_the_jax_guards_actions(name):
    kw, stream, actions, quarantined, rollbacks, lr_scale = SCENARIOS[name]
    before = {k: _counter(k) for k in ("training.rollback", "training.abort",
                                       "training.quarantine")}
    guards = [JG.TrainingGuard(watchdog=False, **kw),
              PG.TrainingGuard(watchdog=False, **kw)]
    got = [[g.observe(b, loss, gn) for b, loss, gn in stream] for g in guards]
    assert got[0] == got[1] == actions
    for g in guards:
        assert g.quarantined == quarantined
        assert g.rollbacks == rollbacks and g.lr_scale == lr_scale
        kinds = [a["kind"] for a in g.anomalies]
        assert kinds == [a["kind"] for a in guards[0].anomalies]
    # the port's counters (the JAX guard counts in the JAX registry)
    assert _counter("training.rollback") == before["training.rollback"] + \
        rollbacks
    assert _counter("training.abort") == before["training.abort"] + \
        actions.count("abort")
    assert _counter("training.quarantine") == \
        before["training.quarantine"] + len(quarantined)
    if "nonfinite_grad" in name:
        assert guards[1].anomalies[-1]["kind"] == "grad_nonfinite"
    if "nonfinite_loss" in name:
        assert guards[1].anomalies[-1]["kind"] == "loss_nonfinite"


def test_guard_quarantine_persists_atomically_and_reads_across(tmp_path):
    g = PG.TrainingGuard(watchdog=False)
    g.quarantined = {3, 11, (2, 5)}
    g.quarantine_checkpoint(8, "/ckpt/quarantined/8")
    path = tmp_path / "q.json"
    g.save_quarantine(path)
    for cls in (PG.TrainingGuard, JG.TrainingGuard):  # same file format
        g2 = cls(watchdog=False)
        g2.load_quarantine(path)
        assert g2.quarantined == {3, 11, (2, 5)}
        assert g2.quarantined_checkpoints == {(8, "/ckpt/quarantined/8")}
    j = JG.TrainingGuard(watchdog=False)
    j.quarantined = {4}
    j.save_quarantine(tmp_path / "j.json")
    g3 = PG.TrainingGuard(watchdog=False)
    g3.load_quarantine(tmp_path / "j.json")
    assert g3.quarantined == {4}
    # torn/missing files are a no-op, never a crash
    path.write_text("{not json")
    g4 = PG.TrainingGuard(watchdog=False)
    g4.load_quarantine(path)
    g4.load_quarantine(tmp_path / "absent.json")
    assert g4.quarantined == set()


def test_watchdog_fires_on_hung_step_and_joins():
    g = PG.TrainingGuard(hang_timeout_s=0.15)
    before = _counter("training.hang")
    with g:
        assert g.running
        g.step_begin(42)
        time.sleep(0.5)          # "hung" well past the budget
        g.step_end()
        g.step_begin(43)         # healthy step: no second alarm
        g.step_end()
        time.sleep(0.2)
    assert g.hangs == 1          # latched: one alarm per hung step
    assert _counter("training.hang") == before + 1
    assert not g.running


def test_watchdog_budget_derives_from_step_latency_p95():
    h = telemetry.histogram("models.training.step_latency")
    for _ in range(50):
        h.observe(0.02)
    g = PG.TrainingGuard(watchdog=False, hang_multiplier=20.0, hang_min_s=0.1)
    p95 = h.percentile(0.95)
    assert math.isfinite(p95)
    assert g.hang_budget_s() == pytest.approx(max(0.1, 20.0 * p95))
    assert PG.TrainingGuard(watchdog=False,
                            hang_timeout_s=9.0).hang_budget_s() == 9.0
