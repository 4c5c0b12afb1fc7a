"""The comparison fails its control and every planted fault."""
from __future__ import annotations

import pytest

from benchmark import control, harness
from benchmark.tests import tiny

CELLS = ["pretrain-r50-bar", "finetune-r50-s2s"]


def _state_unchanged(state, step):
    state.tx.optimizer.device_step = lambda: None


def _half_batch(state, step):
    loss_fn = step.loss_fn

    def half(model, batch, rng, pix):
        rows = next(iter(batch.values())).shape[0] // 2
        return loss_fn(model, {n: t[:rows] for n, t in batch.items()}, rng,
                       pix)
    step.loss_fn = half


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault):
    """The harness's run, the chip's look skipped, with the timed path
    broken underneath (one chip: no exchange to leave out; a training step
    produces no token to alter)."""
    result, lines = tiny.run(tiny.cell(name), fault=fault)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("name", CELLS)
def test_stand_ins_fail_at_a_small_size(name):
    import torch

    numbers = control.stand_ins(tiny.cell(name), 2 ** 31 + 5,
                                torch.device("cpu"))
    cell = tiny.cell(name)
    assert control.passes(cell, numbers.pop("witness"))
    for stand_in, got in numbers.items():
        assert not control.passes(cell, got), (stand_in, got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_stand_ins_fail_at_the_cells_size(name, cuda):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        numbers = control.stand_ins(cell, seed, cuda)
        assert control.passes(cell, numbers.pop("witness")), seed
        for stand_in, got in numbers.items():
            assert not control.passes(cell, got), (seed, stand_in, got)
