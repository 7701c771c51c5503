"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have (faults.py), while the same run unbroken
comes out correct; and the lower-precision control, put in the program's
place, fails the comparison too.  Tiny cells on the CPU; the harness's look
for a card is skipped."""
import pytest
import torch

from perfbench import faults
from perfbench.harness import runner, spec
from perfbench.reference.precision import fp8_e4m3
from perfbench.tests import tiny

CELLS = {"featurize": (tiny.featurize_parts, tiny.FEATURIZE_LIMITS),
         "finetune": (tiny.finetune_parts, tiny.FINETUNE_LIMITS)}


@pytest.mark.parametrize("driver", sorted(CELLS))
def test_a_sound_run_is_correct(driver):
    parts, limits = CELLS[driver]
    rc, result, err = tiny.run(parts(), limits)
    assert rc == 0 and result["correct"], err[-2000:]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(limits)
    last = err.strip().splitlines()[-len(limits):]
    assert all(line.startswith("check ") for line in last)


@pytest.mark.parametrize("driver,fault", [(d, f) for d in sorted(CELLS)
                                          for f in faults.FAULTS[d]])
def test_a_planted_fault_is_not_correct(driver, fault):
    parts, limits = CELLS[driver]
    with faults.plant(driver, fault):
        rc, result, err = tiny.run(parts(), limits)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("driver", sorted(CELLS))
def test_the_fp8_control_is_not_correct(driver):
    parts, limits = CELLS[driver]
    wl, cfg, mix = parts()
    ctx = runner.Context(wl, cfg, mix, limits, 2 ** 31 + 5, "cpu", False)
    cell = spec.driver(mix["driver"]).setup(ctx)
    for _ in range(3):
        cell.call()
    cell.release()
    sound = cell.verify()
    control = cell.verify(fp8_e4m3)
    assert all(v <= lim for _n, v, lim in sound), sound
    assert any(v > lim for _n, v, lim in control), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet50.featurize",
                                      "vit_b16.finetune"])
def test_the_fp8_control_fails_at_the_cells_size(workload):
    """On the card, at the cell's own size: the committed limits pass the
    program and fail the fp8 control (three seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl, cfg, mix = tiny.full_parts(workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = runner.Context(wl, cfg, mix, spec.limits(workload), seed,
                             "cuda", False)
        cell = spec.driver(mix["driver"]).setup(ctx)
        for _ in range(2):
            cell.call()
        cell.release()
        assert all(v <= lim for _n, v, lim in cell.verify())
        assert any(v > lim for _n, v, lim in cell.verify(fp8_e4m3))
