"""The control, the reference computed in bfloat16 put in the program's
place, comes out not correct against the float32 reference in every
cell's comparison (at the tests' sizes; on the card at the cells' own
sizes the readings are PERF.md's)."""

import pytest
import torch

from portbench.harness import check, runner
from portbench.harness.scene import CONTROLS, make_inputs

from .common import SEED, SMALL, UNLISTED


def as_program(run, params0, beta1):
    return dict(params0=params0, losses=torch.tensor(run["losses"]),
                m1={n: g * (1.0 - beta1) for n, g in run["grad1"].items()},
                params=run["params"])


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_bfloat16_control_is_not_correct(name, seed):
    cell = runner.cell_with(name, SMALL[name], UNLISTED.get(name))
    cfg = cell["config"]
    beta1 = cfg["optimizer"]["beta1"]
    inputs = make_inputs(cfg, seed, "cpu")
    leaves = inputs["leaves"]
    ref = runner.reference_run(cell, inputs, leaves)
    assert CONTROLS[cfg["dtype"]] is torch.bfloat16
    control = runner.reference_run(cell, inputs, leaves, dtype=CONTROLS[cfg["dtype"]])
    numbers = check.readings(as_program(control, leaves, beta1), ref, beta1)
    ok, checks = check.judge(numbers, cell["limits"]["limits"])
    assert not ok, checks
