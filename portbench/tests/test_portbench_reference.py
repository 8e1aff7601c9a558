"""The plain reference against the port's plain kernels on the CPU: the
same index maps (the sequential rule, near-ties included), the same
silhouettes, the same first gradient to rounding, and a fit of the
harness that the comparison passes."""

import time

import numpy as np
import pytest
import torch

from portbench.harness import check, runner, spec
from portbench.harness.scene import icosphere, make_inputs, torus
from portbench.reference import silhouette_fit as ref
from portbench.tasks import silhouette_fit as task

from .common import SEED, SMALL, UNLISTED


def port_index_map(fv, size):
    from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import compute_face_index_map

    with torch.no_grad():
        return compute_face_index_map(fv.contiguous(), size, 0.1, 100.0, True)


@pytest.mark.parametrize("scene", ["sphere", "torus", "stacked"])
def test_zbuffer_is_the_ports(scene):
    rng = np.random.default_rng(3)
    if scene == "sphere":
        v, f = icosphere(2)
        v = v + np.array([0.0, 0.0, 2.0], np.float32)
    elif scene == "torus":
        v, f = torus(16, 12)
        v = v[:, [0, 2, 1]] + np.array([0.0, 0.0, 2.0], np.float32)
    else:
        # copies of one square at depths 1e-4 apart and nearer: near-ties
        # that an argmin would resolve otherwise
        base = np.array([[-0.6, -0.6], [0.6, -0.6], [0.6, 0.6], [-0.6, 0.6]], np.float32)
        depths = 1.0 + np.array([0.0, 0.00005, -0.00002, 0.0001, -0.0003], np.float32)
        v = np.concatenate([np.c_[base + rng.normal(0, 0.05, base.shape), np.full(4, d)]
                            for d in depths]).astype(np.float32)
        f = np.concatenate([np.array([[0, 1, 2], [0, 2, 3]]) + 4 * k for k in range(5)])
    fv = torch.tensor(v)[torch.tensor(f, dtype=torch.long)][None]
    size = 40
    want = port_index_map(fv, size).long()
    got = ref.zbuffer(fv, size)
    assert torch.equal(got, want)


def test_blocks_fold_in_face_order(monkeypatch):
    v, f = torus(16, 12)
    v = v[:, [0, 2, 1]] + np.array([0.0, 0.0, 2.0], np.float32)
    fv = torch.tensor(v)[torch.tensor(f, dtype=torch.long)][None].repeat(2, 1, 1, 1)
    whole = ref.zbuffer(fv, 32)
    monkeypatch.setattr(ref, "PAIR_BLOCK", 97)
    assert torch.equal(ref.zbuffer(fv, 32), whole)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_fit_matches_the_port(name):
    cell = runner.cell_with(name, SMALL[name], UNLISTED.get(name))
    cfg = cell["config"]
    inputs = make_inputs(cfg, SEED, "cpu")
    from portbench.harness.fit import Fit

    fit = Fit(inputs, cfg, "whole")
    with torch.no_grad():
        got = fit.images(fit.leaves)
        want = ref.forward_images(inputs["leaves"]["vertices"],
                                  dict(inputs, faces=inputs["faces"].long()))
    assert torch.equal(got, want)
    program = runner.program_readings(fit.first_steps(runner.FIRST_STEPS))
    reference = runner.reference_run(cell, inputs, program["params0"])
    numbers = check.readings(program, reference, cfg["optimizer"]["beta1"])
    ok, checks = check.judge(numbers, cell["limits"]["limits"])
    assert ok, checks
    assert numbers["grad_gap"] < 1e-6


def test_reference_is_short_beside_the_window():
    cell = runner.cell_with("recon642-b128-whole", SMALL["recon642-b128-whole"])
    inputs = make_inputs(cell["config"], SEED, "cpu")
    t0 = time.perf_counter()
    runner.reference_run(cell, inputs, inputs["leaves"])
    assert time.perf_counter() - t0 < 10.0


def test_each_configuration_names_its_reference():
    for name in sorted(SMALL):
        cell = runner.cell_with(name, workload=UNLISTED.get(name))
        assert spec.reference(cell["config"]) is cell["reference"] is ref
        assert spec.task(cell["config"]) is cell["task"] is task


@pytest.mark.parametrize("key, value", [("reference", "rgb_fit"), ("dtype", "bfloat16"),
                                        ("loss", "mse"), ("faces", 1281)])
def test_a_setting_the_benchmark_does_not_make_raises(key, value):
    cell = runner.cell_with("recon642-b128-whole")
    cfg = dict(cell["config"], **{key: value})
    with pytest.raises(ValueError, match=key):
        if key == "reference":
            spec.reference(cfg)
        else:
            make_inputs(cfg, SEED, "cpu")
