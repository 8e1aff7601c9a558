"""A configuration's fit taken from its files alone: a task the harness
has never seen (``two_leaf/``: two leaves of different shapes, a mean
squared error, its own reference) run through the harness on the CPU; an
unknown task; the silhouette task's numbers as the harness of one tensor
computed them; the port's spans and counters in a traced run's context."""

import time
from pathlib import Path

import pytest
import torch

from portbench.harness import check, runner, spec
from portbench.harness.fit import Fit, port
from portbench.harness.scene import make_inputs

from .common import SEED, SMALL

HOME = Path(__file__).resolve().parent / "two_leaf"
TWO_LEAF = {"name": "two-leaf-whole", "config": "two-leaf", "traffic": "whole", "chips": 1}


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch", "altered"])
def test_a_task_added_as_files_alone(fault):
    result = runner.single(TWO_LEAF["name"], SEED, 0.2, False, time.time(), device="cpu",
                           fault=fault, workload=TWO_LEAF, home=HOME)
    assert result["correct"] is (fault is None), result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def test_each_leaf_steps():
    cell = runner.cell_with(TWO_LEAF["name"], workload=TWO_LEAF, home=HOME)
    cfg = cell["config"]
    fit = Fit(make_inputs(cfg, SEED, "cpu", cell["task"]), cfg, "whole", task=cell["task"])
    first = fit.first_steps(runner.FIRST_STEPS)
    assert {n: tuple(t.shape) for n, t in first["params"].items()} == {
        "vertices": (3, 42, 3), "scale": (3, 3)}
    for name, p0 in first["params0"].items():
        assert not torch.equal(first["params"][name], p0), name


def test_a_task_without_the_sharded_form_raises():
    cell = runner.cell_with(TWO_LEAF["name"], workload=TWO_LEAF, home=HOME)
    cfg = cell["config"]
    with pytest.raises(ValueError, match="sharded"):
        Fit(make_inputs(cfg, SEED, "cpu", cell["task"]), cfg, "sharded", task=cell["task"])


def test_an_unknown_task_raises_and_names_the_known():
    cfg = dict(runner.cell_with("recon642-b128-whole")["config"], reference="rgb_fit")
    with pytest.raises(ValueError, match=r"rgb_fit.*\['silhouette_fit'\]"):
        spec.task(cfg)
    with pytest.raises(ValueError, match=r"\['scaled_fit', 'silhouette_fit'\]"):
        spec.reference(cfg, HOME)
    with pytest.raises(ValueError, match="rgb_fit"):
        make_inputs(cfg, SEED, "cpu")


def one_leaf_readings(program, reference, beta1):
    """``check.readings`` as the harness of one tensor, ``vertices``,
    computed it."""
    p, r = ({k: (v["vertices"] if isinstance(v, dict) else v) for k, v in d.items()}
            for d in (program, reference))
    losses = p["losses"].double().cpu()
    want = torch.tensor(r["losses"], dtype=torch.float64)
    loss_gap = float(((losses - want).abs() / want.abs()).max())
    g_prog = check.leaf_norms(p["m1"].cpu() / (1.0 - beta1))
    g_ref = check.leaf_norms(r["grad1"].cpu())
    p0 = p["params0"].cpu()
    d_prog = check.leaf_norms(p["params"].cpu() - p0)
    d_ref = check.leaf_norms(r["params"].cpu() - p0)
    keep = g_ref >= check.MOVES_FROM * torch.median(g_ref)
    return dict(loss_gap=loss_gap, grad_gap=check._worst(g_prog, g_ref),
                change_gap=check._worst(d_prog, d_ref, keep))


@pytest.mark.parametrize("name", ["mesh164k-v32-512-whole", "recon642-b128-whole"])
def test_the_silhouette_readings_keep_their_bits(name):
    """The readings over named leaves are, bit for bit, those of one
    tensor; the program's losses and changes equal the reference's."""
    cell = runner.cell_with(name, SMALL[name])
    cfg = cell["config"]
    inputs = make_inputs(cfg, SEED, "cpu")
    assert list(inputs["leaves"]) == ["vertices"]
    fit = Fit(inputs, cfg, "whole")
    program = runner.program_readings(fit.first_steps(runner.FIRST_STEPS))
    ref = runner.reference_run(cell, inputs, program["params0"])
    beta1 = cfg["optimizer"]["beta1"]
    numbers = check.readings(program, ref, beta1)
    assert {k: v.hex() for k, v in numbers.items()} == {
        k: v.hex() for k, v in one_leaf_readings(program, ref, beta1).items()}
    assert numbers["loss_gap"] == 0.0 and numbers["change_gap"] == 0.0


def test_spans_and_counters_reach_the_readers(monkeypatch):
    """A traced run on the CPU: the port's counters copied right after the
    window (tracing off then), and its spans from the second fit's steps
    (tracing on), eager host spans standing in for the card's marks."""
    nr_trace = port().utils.trace
    contexts, counted = [], []
    reader = spec.reader

    def capturing(metric):
        def read(ctx):
            contexts.append(ctx)
            return reader(metric)(ctx)
        return read

    counters = nr_trace.counters

    def counters_now():
        counted.append(nr_trace._state["on"])
        return counters()

    def host_ms(outermost=False):
        total, steps = {}, {}
        for s in nr_trace.spans():
            total[s["name"]] = total.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e6
            steps.setdefault(s["name"], set()).add(s["step"])
        return {n: total[n] / len(steps[n]) for n in total}

    monkeypatch.setattr(spec, "reader", capturing)
    monkeypatch.setattr(nr_trace, "counters", counters_now)
    monkeypatch.setattr(nr_trace, "device_ms", host_ms)
    name = "recon642-b128-whole"
    result = runner.single(name, SEED, 0.2, True, time.time(), device="cpu",
                           overrides=SMALL[name])
    assert result["correct"], result["checks"]
    assert counted == [False]
    assert not nr_trace._state["on"]
    ctx = contexts[0]
    assert {"launches", "graphs", "bins"} <= set(ctx["counters"])
    assert ctx["spans"]["resolve.vjp"] > 0
    assert result["metrics"]["scatter_span_ms"]["value"] == ctx["spans"]["resolve.vjp"]
    steps = {s["step"] for s in nr_trace.spans("resolve.vjp")}
    assert len(steps) == runner.SPAN_STEPS
