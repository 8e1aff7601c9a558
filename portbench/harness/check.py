"""The comparison that decides ``correct``: the program's first steps
against the plain reference's from the same inputs.

The numbers compared (each against the cell's limit, ``limits/<cell>``):

- ``loss_gap``: the largest relative gap of the three steps' losses;
- ``grad_gap``: over the leaves (each object's rows of each of the
  task's named tensors), the largest gap between the program's and the
  reference's norm of the first gradient (the program's from Adam's first
  moment after step 1, m1 / (1 - beta1)), over the reference's norm of
  that leaf or of the median leaf of its tensor, whichever is larger;
- ``change_gap``: the same of the parameters' change after the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's of its tensor (a leaf with no gradient
  moves by round-off alone under Adam);
- ``rank_gap`` (several ranks): the largest norm of a rank's parameters
  after the three steps minus rank 0's, over rank 0's change, the worst
  tensor's: 0 when every rank holds the same bits.

A number taken over several tensors or ranks is their worst, and NaN
where any of them is NaN.
"""

from __future__ import annotations

import math

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of change_gap
MOVES_FROM = 1e-3


def leaf_norms(t):
    """Norm of each object's rows of ``t`` [O, ...], float64."""
    return torch.linalg.vector_norm(t.double().reshape(t.shape[0], -1), dim=1)


def _worst(got, want, keep=None):
    floor = torch.median(want)
    scale = torch.maximum(want, floor)
    gap = (got - want).abs() / scale
    if keep is not None:
        gap = gap[keep]
    if not gap.numel():
        return 0.0
    return float(gap.max())


def worst(values):
    """The largest of ``values``, NaN where any is NaN."""
    return float(torch.tensor(list(values), dtype=torch.float64).max())


def readings(program, reference, beta1):
    """The numbers compared, from the program's first steps (``program``:
    losses, and m1, params0, params each a dict of one tensor a leaf; CPU
    or device tensors) and the reference's (losses, and grad1, params by
    leaf)."""
    losses = program["losses"].double().cpu()
    want = torch.tensor(reference["losses"], dtype=torch.float64)
    loss_gap = float(((losses - want).abs() / want.abs()).max())
    grad_gaps, change_gaps = [], []
    for name, p0 in program["params0"].items():
        g_prog = leaf_norms(program["m1"][name].cpu() / (1.0 - beta1))
        g_ref = leaf_norms(reference["grad1"][name].cpu())
        grad_gaps.append(_worst(g_prog, g_ref))
        p0 = p0.cpu()
        d_prog = leaf_norms(program["params"][name].cpu() - p0)
        d_ref = leaf_norms(reference["params"][name].cpu() - p0)
        keep = g_ref >= MOVES_FROM * torch.median(g_ref)
        change_gaps.append(_worst(d_prog, d_ref, keep))
    return dict(loss_gap=loss_gap, grad_gap=worst(grad_gaps), change_gap=worst(change_gaps))


def rank_gap(params, params0):
    """The largest norm of rank r's parameters minus rank 0's, over rank
    0's change from ``params0``, the worst leaf's (``params``: each rank's
    dict of one tensor a leaf)."""
    gaps = []
    for name, p0 in params0.items():
        base = params[0][name].double()
        change = float(torch.linalg.vector_norm(base - p0.double()))
        far = max(float(torch.linalg.vector_norm(p[name].double() - base)) for p in params)
        gaps.append(far / change if change else math.inf)
    return worst(gaps)


def judge(numbers, limits):
    """(correct, {name: {value, limit}}): every number finite and at or
    under its limit."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, checks
