"""The port's examples end to end on the CPU (``--device cpu``, the kernels'
plain versions), a few steps at 64^2 (example 5: 32^2 on two gloo ranks),
on the inputs ``scenes.write_example_data`` writes; after the JAX package's
tests/test_examples.py: the artifacts appear, and each fit's loss falls."""

import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch.examples import (
    example1,
    example2,
    example3,
    example4,
    example5_sharded,
)
from neural_renderer_v2_pytorch_tpu_torch.utils import scenes


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread, so that this file neither slows
    nor is slowed by the test processes it shares the cores with."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.write_example_data(tmp_path_factory.mktemp("data"), 64, device="cpu")


def _assert_optimized(losses):
    assert len(losses) >= 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_example_data(data):
    vertices, faces = nr.load_obj(data["torus.obj"], device="cpu")
    assert faces.dtype == torch.int32 and faces.shape == (2560, 3)
    np.testing.assert_array_equal(faces.numpy(),
                                  scenes.fan_triangles(scenes.torus_quads(40, 32)))
    assert sorted(map(tuple, faces.numpy())) == sorted(map(tuple, scenes.torus(40, 32)[1]))
    for name in ("example2_ref.png", "example3_ref.png", "example4_ref.png"):
        image = nr.imread(data[name])
        assert image.shape == (64, 64, 3) and 0.05 < image.mean() < 0.5


def test_example1_viewpoint_sweep(data, tmp_path):
    out = tmp_path / "ex1.gif"
    assert example1.run(["-i", data["torus.obj"], "-o", str(out), "-s", "64", "-b", "8",
                         "--azimuth_step", "45", "--device", "cpu"]) == 8
    assert out.exists() and out.stat().st_size > 0


def test_example2_vertex_fit(data, tmp_path):
    oo, orr = tmp_path / "opt.gif", tmp_path / "res.gif"
    losses = example2.run(["-io", data["torus.obj"], "-ir", data["example2_ref.png"],
                           "-oo", str(oo), "-or", str(orr), "-s", "64", "-n", "3",
                           "--sweep_step", "90", "--device", "cpu"])
    assert oo.exists() and orr.exists()
    _assert_optimized(losses)


def test_example3_texture_fit(data, tmp_path):
    out = tmp_path / "res.gif"
    losses = example3.run(["-io", data["torus.obj"], "-ir", data["example3_ref.png"],
                           "-or", str(out), "-s", "64", "-n", "3", "--sweep_step", "90",
                           "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 0
    _assert_optimized(losses)


def test_example4_camera_fit(data, tmp_path):
    """Six steps: from (6, 10, -14) the torus spans ~6 pixels of 64, and the
    first three steps of 0.1 move no edge across a sample (the loss first
    moves at the fifth step)."""
    out = tmp_path / "res.gif"
    losses = example4.run(["-io", data["torus.obj"], "-ir", data["example4_ref.png"],
                           "-or", str(out), "-s", "64", "-n", "6", "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 0
    _assert_optimized(losses)


def test_example5_sharded(data, tmp_path):
    out = tmp_path / "ex5.gif"
    losses = example5_sharded.main(["-i", data["torus.obj"], "-o", str(out), "-s", "32",
                                    "-n", "3", "--ranks", "2", "--device", "cpu"])
    assert out.exists() and out.stat().st_size > 0
    _assert_optimized(losses)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal shows without a card")
@pytest.mark.parametrize("example", ["example1", "example2", "example3", "example4",
                                     "example5_sharded"])
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_examples_refuse_a_missing_card(data, tmp_path, example, device):
    """Asked for a card that is not there, each example raises before its
    first step rather than running on the CPU; example 5's ranks each take
    a card of their own, so it takes no card index."""
    argv = {
        "example1": ["-i", data["torus.obj"], "-o", str(tmp_path / "ex1.gif")],
        "example2": ["-io", data["torus.obj"], "-ir", data["example2_ref.png"],
                     "-oo", str(tmp_path / "opt.gif"), "-or", str(tmp_path / "res.gif")],
        "example3": ["-io", data["torus.obj"], "-ir", data["example3_ref.png"],
                     "-or", str(tmp_path / "res.gif")],
        "example4": ["-io", data["torus.obj"], "-ir", data["example4_ref.png"],
                     "-or", str(tmp_path / "res.gif")],
        "example5_sharded": ["-i", data["torus.obj"], "-o", str(tmp_path / "ex5.gif"),
                             "--ranks", "2"],
    }[example] + ["-s", "64", "-n", "1", "--device", device]
    module = {"example1": example1, "example2": example2, "example3": example3,
              "example4": example4, "example5_sharded": example5_sharded}[example]
    if example == "example5_sharded" and device != "cuda":
        with pytest.raises(SystemExit):
            module.parse_args(argv)
        return
    with pytest.raises((RuntimeError, AssertionError, OSError)):
        (module.main if example == "example5_sharded" else module.run)(argv)
    assert not list(tmp_path.glob("*.gif")) and not list(tmp_path.glob("_tmp_*.png"))
