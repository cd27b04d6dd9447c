"""The comparison that decides ``correct`` fails what it must fail.

- The control, the reference computed in fp8 in the program's place, fails
  each cell's limits (``check.judge``), on three seeds, at 512 wide with
  heads of the cells' 128 and 256 tokens a row.
- A run of the harness on the CPU (the look for a card skipped), with the
  port's train step broken underneath, reads ``correct`` false, for each
  fault a training cell on one card can have: a step that returns its state
  unchanged, and a step over half the batch with the mean taken over the
  rest. The same run unbroken reads true.
"""

import pytest
import torch

from portbench import calibrate, check, reference, weights
from portbench.tests.conftest import SMALL, run_tiny, tiny_cell

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_fails_the_limits(cell_name, seed):
    cell = tiny_cell(cell_name, size=SMALL, seq_len=256)
    k = cell.limits["steps"]
    batches = list(weights.tokens(cell.config, cell.mix, seed, torch.device("cpu"))[:k])
    ref = reference.train_readings(cell.config, batches, seed)
    control = reference.train_readings(cell.config, batches, seed, "fp8")
    judged = check.judge(check.numbers(control, ref), cell.limits["limits"])
    assert not all(j["ok"] for j in judged.values()), judged


def test_a_sound_run_is_correct(cell_name):
    result = run_tiny(tiny_cell(cell_name, torch_dtype="float32"))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def _break(monkeypatch, fault):
    """Plant ``fault`` under the port's train step as the harness builds it."""
    from pytorch_operator_tpu_torch.workloads import trainer

    make = trainer.make_lm_train_step

    def broken(model, optimizer, *a, **kw):
        step = make(model, optimizer, *a, **kw)

        class _Prog:
            pass

        prog = _Prog()
        prog.model, prog.step = model, step
        return calibrate.FAULTS[fault](prog)

    monkeypatch.setattr(trainer, "make_lm_train_step", broken)


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_broken_step_is_not_correct(monkeypatch, cell_name, fault):
    _break(monkeypatch, fault)
    result = run_tiny(tiny_cell(cell_name, torch_dtype="float32"))
    assert not result["correct"], result["checks"]
