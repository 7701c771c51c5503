"""The lm_train entry (drivers/lm_train.py) at a tiny LFM2-MoE on the CPU:
a sound run is correct and its calls carry their routing counters, each
planted fault and the fp8 control are not correct, the corpus is packed
documents of the mix; the readers of the cell (mfu.lm_train,
expert_gemm_roofline.lm_train, step_device_ms.lm_train, the causal
attention rooflines and idle_share.finetune) on fabricated views; and, on a card, the cell's own set-up and one call."""
import itertools
import types

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import telemetry
from perfbench.harness import runner, spec
from perfbench.harness.trace import TraceSummary
from perfbench.reference.precision import fp8_e4m3
from perfbench.tests import tiny

WORKLOAD = "lfm2_8b_a1b.train_s8192"
READERS = ("mfu.lm_train", "expert_gemm_roofline.lm_train",
           "step_device_ms.lm_train", "attn_fwd_roofline.lm_train",
           "attn_bwd_roofline.lm_train")
# the tiny cell computes in float32 on the CPU: its sound gaps are under
# 1e-6, a planted fault's above 1e-3
LIMITS = {"grad_norm_gap": 1e-4, "change_norm_gap": 1e-3,
          "trained_loss_gap": 1e-4, "trained_grad_gap": 1e-4}

torch.set_num_threads(2)


def _driver():
    return spec.driver("lm_train")


def parts():
    wl = spec.workload(tiny.BENCH, WORKLOAD)
    cfg = dict(spec.config(tiny.BENCH, wl["config"], tiny.ROOT),
               vocab_size=512, hidden_size=64,
               layer_types=["conv", "full_attention", "conv", "conv"],
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, moe_intermediate_size=32,
               num_dense_layers=1, num_experts=4, num_experts_per_tok=2,
               expert_offset=2, published={"num_experts": 8},
               dtype="float32")
    mix = dict(spec.traffic(wl["traffic"]), seq_len=32, steps_per_call=4,
               corpus_calls=3, document_median_tokens=16,
               document_max_tokens=64, traced_calls=1)
    return wl, cfg, mix


def test_a_sound_run_is_correct_and_counts_its_routing():
    rc, result, err = tiny.run(parts(), LIMITS)
    assert rc == 0 and result["correct"], err[-2000:]
    assert set(result["checks"]) == set(LIMITS)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert {"setup_s", "train_step_ms"} <= set(result["metrics"])


def test_a_call_records_its_steps_tokens_and_routing():
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, LIMITS, 2 ** 31 + 9, "cpu", False)
    cell = _driver().setup(ctx)
    assert cell.init_path == "direct"
    before = cell.counters()
    rec = cell.call()
    after = cell.counters()
    assert rec["ok"] and rec["steps"] == 4 and rec["tokens"] == 4 * 32
    # 3 expert layers x 4 steps x 32 tokens x top-2
    assert rec["held_pairs"] + rec["absent_pairs"] == 3 * 4 * 32 * 2
    assert 0 < rec["max_expert_pairs"] <= 32
    assert after["held_pairs"] - before["held_pairs"] == rec["held_pairs"]
    spans = telemetry.get_trace(rec["epoch_trace"])
    assert [s["name"] for s in spans].count("training.step") == 4
    cell.release()
    routes = cell.recorder.trained.routes
    assert [tuple(r.shape) for r in routes] == [(32, 2)] * 3
    assert all(v <= lim for _n, v, lim in cell.verify())
    # float32 on both sides: the reference's own top-k is the program's
    assert cell.route_flips == 0.0


def test_the_trained_reference_takes_the_programs_selection(monkeypatch):
    """With the recorded selections replaced by others, the trained
    step's reference follows them (its loss moves and a share of the
    pairs reads as chosen otherwise); the first steps route on their
    own."""
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, LIMITS, 2 ** 31 + 9, "cpu", False)
    cell = _driver().setup(ctx)
    cell.release()
    sound = dict((n, v) for n, v, _lim in cell.verify())
    trained = cell.recorder.trained
    trained.routes = [(r + 3) % 8 for r in trained.routes]
    moved = dict((n, v) for n, v, _lim in cell.verify())
    assert cell.route_flips > 0.5
    worst = _driver().worst_leaves({"a": 1.0, "b": 2.0, "c": 0.5},
                                   {"a": 1.0, "b": 1.0, "c": 1.0}, 2)
    assert [w[0] for w in worst] == ["b", "c"] and worst[0][1] == 1.0
    assert moved["trained_loss_gap"] > 100 * max(sound["trained_loss_gap"],
                                                  1e-9)
    for n in ("grad_norm_gap", "change_norm_gap"):
        assert moved[n] == sound[n]


def test_the_corpus_is_packed_documents_ended_by_eos():
    _wl, cfg, mix = parts()
    c = _driver().corpus(mix, 512, 2 ** 31 + 3)
    assert c.shape == (3, 4, 1, 32) and c.dtype == np.int32
    assert (c >= 0).all() and (c < 512).all()
    assert (c == mix["eos_token_id"]).any()
    assert np.array_equal(c, _driver().corpus(mix, 512, 2 ** 31 + 3))
    assert not np.array_equal(c, _driver().corpus(mix, 512, 2 ** 31 + 4))


@pytest.mark.parametrize("fault", ["bias_ignored", "conv_centred",
                                   "qk_norm_skipped", "half_tokens",
                                   "unchanged"])
def test_a_planted_fault_is_not_correct(fault):
    drv = _driver()
    assert fault in drv.FAULTS
    with drv.plant(fault):
        rc, result, err = tiny.run(parts(), LIMITS)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]


def test_the_fp8_control_is_not_correct():
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, LIMITS, 2 ** 31 + 5, "cpu", False)
    cell = _driver().setup(ctx)
    cell.call()
    cell.release()
    sound = cell.verify()
    control = cell.verify(fp8_e4m3)
    assert all(v <= lim for _n, v, lim in sound), sound
    assert any(v > lim for _n, v, lim in control), control


def test_the_trained_reference_rounds_the_masters_as_the_working_copy():
    """The trained step's reference computes from the masters cast to the
    working copy's dtypes: told the copy was bf16 (the tiny program
    computes in float32), its trained numbers move off the program's
    and the first steps' do not; the fp8 control's reference keeps the
    unrounded masters."""
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, LIMITS, 2 ** 31 + 13, "cpu", False)
    cell = _driver().setup(ctx)
    cell.release()
    trained = cell.recorder.trained
    assert set(trained.dtypes) == set(trained.masters)
    assert set(trained.dtypes.values()) == {torch.float32}
    sound = dict((n, v) for n, v, _lim in cell.verify())
    control = dict((n, v) for n, v, _lim in cell.verify(fp8_e4m3))
    trained.dtypes = {k: torch.bfloat16 for k in trained.dtypes}
    moved = dict((n, v) for n, v, _lim in cell.verify())
    assert moved["trained_grad_gap"] > 100 * max(sound["trained_grad_gap"],
                                                 1e-9)
    for n in ("grad_norm_gap", "change_norm_gap"):
        assert moved[n] == sound[n]
    assert dict((n, v) for n, v, _l in cell.verify(fp8_e4m3)) == control


def test_a_program_without_the_builder_fails_at_once(monkeypatch):
    from mmlspark_tpu_torch.models import bundle

    monkeypatch.delitem(bundle._BUILDERS, "lfm2_moe")
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, LIMITS, 1, "cpu", False)
    with pytest.raises(ValueError, match="unknown model builder"):
        _driver().setup(ctx)


# -- the readers ---------------------------------------------------------
_ids = itertools.count()


def _epoch(steps_s):
    trace = "lm%d" % next(_ids)
    for s in steps_s:
        telemetry.record_span("training.step.device", (trace, "p"), s)
    return trace


def _view(trace=None, device_steps=None):
    wl = spec.workload(tiny.BENCH, WORKLOAD)
    cfg = spec.config(tiny.BENCH, wl["config"], tiny.ROOT)
    mix = spec.traffic(wl["traffic"])
    ctx = runner.Context(wl, cfg, mix, {}, 1, "cpu", trace is not None)
    recs = [{"steps": 8, "held_pairs": 22 * 8 * 8192, "absent_pairs": 0,
             "epoch_trace": _epoch(device_steps[i]) if device_steps else None}
            for i in range(3)]
    calls = [runner.Call(2.0 * i, 2.0 * i + 2.0, r) for i, r in
             enumerate(recs)]
    return runner.View(ctx, calls, {}, trace, recs[:1] if trace else [])


def _read(view):
    return {n: spec.metric_reader(n).read(view) for n in READERS}


def test_mfu_counts_three_forwards_of_the_window_over_its_time():
    view = _view()
    got = _read(view)
    ref = view.family
    macs = ref.forward_macs(view.config, 3 * 22 * 8 * 8192, 8192, 24)
    assert got["mfu.lm_train"] == pytest.approx(
        100 * 6 * macs / 6.0 / 989e12)
    assert 5 < got["mfu.lm_train"] < 100
    assert got["expert_gemm_roofline.lm_train"] is None
    assert got["step_device_ms.lm_train"] is None


def test_the_expert_roofline_reads_the_grouped_kernels_alone():
    reader = spec.metric_reader("expert_gemm_roofline.lm_train")
    cfg = _view().config
    pairs = 22 * 8 * 8192   # 8 steps of 22 layers, 8,192 pairs each
    least = reader.least_seconds(cfg, pairs, 8 * 22)
    # 9 products of 2 * 8192 * 2048 * 1792 FLOPs a layer and step
    flops = 9 * 2 * 8192 * 2048 * 1792 * 8 * 22
    assert least == pytest.approx(flops / 989e12)
    grouped = ("void cutlass::device_kernel<at::cuda::detail::"
               "enable_3x_kernel_for_sm9x<cutlass::gemm::kernel::"
               "GemmUniversal<cutlass::gemm::GroupProblemShape<")
    summary = TraceSummary(3.0, 2.5, {grouped + "a": (2 * least, 100),
                                      "nvjet_tst_256x128": (1.0, 10)}, [])
    view = _view(trace=summary)
    assert _read(view)["expert_gemm_roofline.lm_train"] == pytest.approx(50)
    bare = TraceSummary(3.0, 2.5, {"nvjet_tst_256x128": (1.0, 10)}, [])
    assert _read(_view(trace=bare))["expert_gemm_roofline.lm_train"] is None


def test_the_attention_rooflines_count_the_causal_triangle():
    fwd = spec.metric_reader("attn_fwd_roofline.lm_train")
    bwd = spec.metric_reader("attn_bwd_roofline.lm_train")
    s = 8192
    # 32 heads of 64 at 8,192 tokens are bound by their FLOPs
    least = fwd.least_seconds(1, s, 32, 64)
    assert least == pytest.approx(4 * 32 * 64 * s * (s + 1) / 2 / 989e12)
    assert bwd.least_seconds(1, s, 32, 64) == pytest.approx(2 * least)
    # one traced call of 8 steps over the 6 attention layers
    calls = 8 * 6
    summary = TraceSummary(3.0, 2.5, {
        "void flash_fwd_hopper_kernel<64>(": (2 * calls * least, calls),
        "void flash_bwd_dkdv_hopper_kernel<64>(": (3 * calls * least, calls),
        "void flash_bwd_dq_hopper_kernel<64>(": (3 * calls * least, calls),
        "nvjet_tst_256x128": (1.0, 10)}, [])
    got = _read(_view(trace=summary))
    assert got["attn_fwd_roofline.lm_train"] == pytest.approx(50)
    assert got["attn_bwd_roofline.lm_train"] == pytest.approx(100 / 3)
    bare = TraceSummary(3.0, 2.5, {"nvjet_tst_256x128": (1.0, 10)}, [])
    assert _read(_view(trace=bare))["attn_fwd_roofline.lm_train"] is None


def test_the_idle_share_reads_the_lm_cells_trace():
    summary = TraceSummary(3.0, 2.5, {"nvjet_tst_256x128": (1.0, 10)}, [])
    idle = spec.metric_reader("idle_share.finetune").read(
        _view(trace=summary))
    assert idle == pytest.approx(100 * 0.5 / 3.0)
    names = {e["name"] for e in spec.metrics_for(tiny.BENCH, "per_layer",
                                                 WORKLOAD)}
    assert names == {"idle_share.finetune", *READERS}


def test_step_device_ms_is_the_median_device_step_of_the_window():
    view = _view(device_steps=[[0.20, 0.21], [0.22, 0.30], [0.19, 0.25]])
    assert _read(view)["step_device_ms.lm_train"] == pytest.approx(215.0)


@pytest.mark.cuda
def test_the_cells_set_up_and_one_call_at_full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = spec.workload(tiny.BENCH, WORKLOAD)
    cfg = spec.config(tiny.BENCH, wl["config"], tiny.ROOT)
    mix = spec.traffic(wl["traffic"])
    ctx = runner.Context(wl, cfg, mix, spec.limits(WORKLOAD), 2 ** 31 + 77,
                         "cuda", False)
    cell = _driver().setup(ctx)
    rec = cell.call()
    assert rec["ok"] and rec["tokens"] == 8 * 8192
    assert rec["held_pairs"] > 0
    assert rec["held_pairs"] + rec["absent_pairs"] == 8 * 22 * 8192 * 4
    assert torch.cuda.max_memory_allocated() > 50e9


def test_an_empty_view_reads_nothing():
    view = types.SimpleNamespace(calls=[], traced=[], trace=None,
                                 mix={"batch_size": 1, "seq_len": 8},
                                 config={}, family=None)
    assert set(_read(view).values()) == {None}
