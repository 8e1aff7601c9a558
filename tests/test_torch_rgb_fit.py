"""The textured, lit fit of the benchmark (``portbench/tasks/rgb_fit.py``)
on the CPU at a small size (``tests/data/rgb_fit_small/``, laid out as
``portbench/``: torus(8, 6), 2 views, 32^2 anti-aliased, a 24 x 40
atlas, the cell's three lights), the port on its plain kernels: the task
against the plain reference (``portbench/reference/rgb_fit.py``), the
reference in bfloat16 outside the tolerances, the harness's run and its
faults, the sampler's yardstick and the readers of the new spans."""

import time
from pathlib import Path

import pytest
import torch

from portbench.harness import check, runner, spec
from portbench.harness.fit import Fit
from portbench.harness.scene import make_inputs
from portbench.yardstick import roofline, sampler

HOME = Path(__file__).resolve().parent / "data" / "rgb_fit_small"
SMALL = {"name": "rgb-fit-small-whole", "config": "rgb-fit-small", "traffic": "whole",
         "chips": 1}
SEED = 2 ** 33 + 12345
STEPS = 3
# every tolerance below: the port's plain kernels and the reference add in
# other orders (K3's and K6's scatters, the segment sum of the normals
# against index_add, the NMR gradient's channel sum), so they part at
# float32's rounding, some ulps of the largest value; measured at this
# size: images 1.8e-7, losses 1e-7, first gradients 1.5e-7 and the
# change after three steps 1e-6 of their norms
IMAGE_ATOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-6
CHANGE_RTOL = 1e-5


@pytest.fixture(scope="module")
def cell():
    return runner.cell_with(SMALL["name"], workload=SMALL, home=HOME)


@pytest.fixture(scope="module")
def run(cell):
    """The program's first steps and the reference's from one seed's
    inputs, and the program's images at the seed's leaves."""
    cfg = cell["config"]
    inputs = make_inputs(cfg, SEED, "cpu", cell["task"])
    fit = Fit(inputs, cfg, "whole", task=cell["task"])
    with torch.no_grad():
        images = fit.images(fit.leaves)
    program = runner.program_readings(fit.first_steps(STEPS))
    reference = runner.reference_run(cell, inputs, program["params0"], steps=STEPS)
    return dict(inputs=inputs, images=images, program=program, reference=reference)


def rel(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def test_the_task_is_the_reference(cell, run):
    """Images, losses, each leaf's first gradient (the program's from
    Adam's first moment) and the leaves after three Adam steps."""
    inputs, program, reference = run["inputs"], run["program"], run["reference"]
    leaves = inputs["leaves"]
    ref = cell["reference"]
    with torch.no_grad():
        want = ref.render(leaves["vertices"], torch.tanh(leaves["textures"]), inputs)
    assert run["images"].shape == want.shape == (2, 3, 32, 32)
    assert float(want.amax()) > 0.5 and float((want > 0).float().mean()) > 0.1
    torch.testing.assert_close(run["images"], want, rtol=0.0, atol=IMAGE_ATOL)
    torch.testing.assert_close(program["losses"].double(),
                               torch.tensor(reference["losses"], dtype=torch.float64),
                               rtol=LOSS_RTOL, atol=0.0)
    beta1 = cell["config"]["optimizer"]["beta1"]
    assert list(program["params0"]) == ["vertices", "textures"]
    for name, p0 in program["params0"].items():
        grad = program["m1"][name] / (1.0 - beta1)
        assert rel(grad, reference["grad1"][name]) < GRAD_RTOL, name
        change, want_change = program["params"][name] - p0, reference["params"][name] - p0
        assert float(torch.linalg.vector_norm(want_change)) > 0, name
        assert rel(change, want_change) < CHANGE_RTOL, name


def test_the_targets_are_the_references_renders(cell, run):
    """The targets: the reference's renders of the template under an atlas
    other than the leaf's start, so the loss is not 0."""
    inputs = run["inputs"]
    assert inputs["targets"].shape == (2, 3, 32, 32)
    assert run["program"]["losses"][0] > 1.0
    assert not torch.equal(inputs["targets"], run["images"])


def test_bfloat16_reference_is_outside_the_tolerances(cell, run):
    """The control: the reference computed in bfloat16 in the program's
    place reads outside the first gradient's tolerance on each leaf and
    fails the cell's limits."""
    program, reference = run["program"], run["reference"]
    control = runner.reference_run(cell, run["inputs"], program["params0"], steps=STEPS,
                                   dtype=torch.bfloat16)
    for name in program["params0"]:
        assert rel(control["grad1"][name], reference["grad1"][name]) > 100 * GRAD_RTOL, name
    beta1 = cell["config"]["optimizer"]["beta1"]
    as_program = dict(params0=program["params0"], losses=torch.tensor(control["losses"]),
                      m1={n: g * (1.0 - beta1) for n, g in control["grad1"].items()},
                      params=control["params"])
    numbers = check.readings(as_program, reference, beta1)
    ok, _ = check.judge(numbers, cell["limits"]["limits"])
    assert not ok and numbers["grad_gap"] > 100 * cell["limits"]["limits"]["grad_gap"]


@pytest.mark.parametrize("fault", [None, "half_batch", "altered", "frozen"])
def test_the_harness_run_catches_each_fault(fault):
    result = runner.single(SMALL["name"], SEED, 0.2, False, time.time(), device="cpu",
                           fault=fault, workload=SMALL, home=HOME)
    assert result["correct"] is (fault is None), result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(result["metrics"]) == {"pixels_per_s", "step_ms_p95", "peak_mem_mib", "setup_s"}


def test_sampler_counts_a_hand_counted_case():
    """A 2 x 2 image, 3 of its pixels covered, one 2 x 2 atlas: per covered
    pixel 6 + 3 + 3 floats read (texel triangle, depths, weights), 12 (the
    taps), 3 written (RGB), 3 read (its gradient), 12 added (the taps'
    gradients): 42 floats, 168 bytes; the atlas read and its gradient
    written once, 2 x 3 x 4 floats; 48 operations a pixel."""
    assert sampler.sample_work(3, 1, 4) == (3 * 168 + 96, 3 * 48)
    # a second view of the same object adds its pixels, not another atlas
    assert sampler.sample_work(6, 1, 4) == (6 * 168 + 96, 6 * 48)
    assert sampler.sample_work(6, 2, 4) == (6 * 168 + 192, 6 * 48)


def test_step_work_counts_the_covered_pixels(cell, run):
    """``step_work``'s covered pixels are the foreground of the port's
    render at the seed's leaves (its alpha channel, before the pool)."""
    inputs = run["inputs"]
    leaves0 = run["program"]["params0"]
    work = cell["task"].step_work(cell["config"], inputs, leaves0)
    nbytes, ops = work["sample"]
    covered = ops // sampler.PIXEL_OPS
    assert nbytes == covered * 168 + 2 * 3 * 24 * 40 * 4
    r = Fit(inputs, cell["config"], "whole", task=cell["task"]).renderer
    r.anti_aliasing = False
    r.image_size = 64
    with torch.no_grad():
        alpha = r.render(leaves0["vertices"].expand(2, -1, -1), inputs["faces"],
                         inputs["vertices_t"][None].expand(2, -1, -1), inputs["faces_t"],
                         torch.ones(2, 3, 24, 40))[:, 3]
    assert covered == int(alpha.sum()) > 0


def test_the_readers_of_the_new_spans():
    """``sample_span_ms``, ``lights_span_ms`` and ``sample_roofline`` read
    the spans' device ms; None where the port has no such span (a parent
    without them), whatever else the spans hold."""
    spans = {"sample": 1.5, "sample.vjp": 2.5, "lights": 0.25, "lights.vjp": 0.5,
             "planes": 9.0}
    work = {"sample": sampler.sample_work(10 ** 6, 1, 1190 * 1920)}
    ctx = dict(spans=spans, work=work, kind="NVIDIA H100 80GB HBM3")
    assert spec.reader("sample_span_ms")(ctx) == 4.0
    assert spec.reader("lights_span_ms")(ctx) == 0.75
    bound, by = roofline.bound_ms(*work["sample"])
    assert by == "bytes"
    assert spec.reader("sample_roofline")(ctx) == pytest.approx(100.0 * bound / 4.0)
    parent = dict(ctx, spans={"planes": 9.0, "atlas.vjp": 1.0})
    for name in ("sample_span_ms", "lights_span_ms", "sample_roofline"):
        assert spec.reader(name)(parent) is None
        assert spec.reader(name)(dict(ctx, spans=None)) is None
