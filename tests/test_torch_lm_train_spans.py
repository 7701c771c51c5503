"""The spans and counters of `training.make_lm_train_epoch` on an
`lfm2_moe` model: one `training.lm_epoch` span an epoch with one
`training.step` under it a step and none dropped over 8 steps, the
routing counters equal to the plain reference's count of the same
routing, and on a card one `training.step.device` record a step."""
import pytest
import torch

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models import training
from mmlspark_tpu_torch.models.bundle import DirectInit
from perfbench.reference import lfm2 as ref

torch.set_num_threads(2)

CFG = {"vocab_size": 256, "hidden_size": 32,
       "layer_types": ["conv", "full_attention", "conv"],
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "intermediate_size": 48, "moe_intermediate_size": 16,
       "num_dense_layers": 1, "num_experts": 2, "num_experts_per_tok": 2,
       "norm_eps": 1e-5, "rope_theta": 1e6, "conv_L_cache": 3,
       "expert_offset": 1, "published": {"num_experts": 6}}
_MOE = "models.moe."


def _state(device="cpu", seed=3):
    kw = {k: CFG[k] for k in CFG if k not in ("num_experts", "published")}
    kw.update(num_experts=CFG["published"]["num_experts"],
              experts_held=CFG["num_experts"])
    direct = DirectInit.build("lfm2_moe", kw, device)
    direct.land(direct.draw(seed))
    return training.TrainState.create(direct.module, training.adam(1e-3),
                                      device=device)


def _tokens(steps, seq=16, device="cpu"):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, CFG["vocab_size"], (steps, 2, seq),
                         generator=g).to(device)


def _epoch_spans():
    epoch = [s for s in telemetry.recent_spans()
             if s["name"] == "training.lm_epoch"][-1]
    return epoch, telemetry.get_trace(epoch["trace_id"])


def test_an_8_step_epoch_records_a_step_span_a_step_and_drops_none():
    dropped = telemetry.counters("telemetry.spans.").get(
        "telemetry.spans.dropped", 0)
    state, losses = training.make_lm_train_epoch()(_state(), _tokens(8))
    assert losses.shape == (8,) and torch.isfinite(losses).all()
    epoch, spans = _epoch_spans()
    assert epoch["attrs"]["steps"] == 8 and epoch["parent_id"] is None
    steps = [s for s in spans if s["name"] == "training.step"]
    assert len(steps) == 8
    assert all(s["parent_id"] == epoch["span_id"] for s in steps)
    # on a CPU the steps are not timed on a device
    assert not [s for s in spans if s["name"] == "training.step.device"]
    assert telemetry.counters("telemetry.spans.").get(
        "telemetry.spans.dropped", 0) == dropped


def test_the_routing_counters_are_the_references_count():
    state = _state()
    w = {k: v.detach().clone() for k, v in
         state.module.state_dict().items() if k != "lm_head.weight"}
    toks = _tokens(1)
    before = telemetry.counters(_MOE)
    largest = telemetry.gauge(_MOE + "max_expert_pairs")
    largest.set(0)
    training.make_lm_train_epoch()(state, toks)
    after = telemetry.counters(_MOE)
    _loss, _grads, held = ref.loss_and_grads(w, toks[0], CFG)
    held_layers = len(CFG["layer_types"]) - CFG["num_dense_layers"]
    total = held_layers * toks[0].numel() * CFG["num_experts_per_tok"]
    got = {k: after[_MOE + k] - before.get(_MOE + k, 0)
           for k in ("held_pairs", "absent_pairs")}
    assert got == {"held_pairs": held, "absent_pairs": total - held}
    assert 0 < largest.value <= toks[0].numel()


@pytest.mark.cuda
def test_on_a_card_each_step_has_a_device_record():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = _state("cuda")
    training.make_lm_train_epoch()(state, _tokens(8, device="cuda"))
    epoch, spans = _epoch_spans()
    device = [s for s in spans if s["name"] == "training.step.device"]
    assert len(device) == 8
    assert all(s["wall_s"] > 0 for s in device)
