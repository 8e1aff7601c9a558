"""The frozen work counts against the port's measurement module at
``bench``'s shapes, on either resolve route."""

import numpy as np
import pytest
import torch

from portbench.reference import silhouette_fit as ref
from portbench.yardstick import roofline


@pytest.fixture(scope="module")
def bench_ndc():
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks import steps

    v, f = steps.bench_mesh()
    eye = torch.tensor(steps.eyes([0.0]))
    x = torch.tensor(v[None])
    with torch.no_grad():
        ndc = ref.camera(x, eye, steps.VIEWING_ANGLE)
    return ndc, torch.tensor(f)


@pytest.mark.parametrize("route", ["tiled", "binned"])
def test_resolve_and_scatter_counts_match_the_ports_at_bench(bench_ndc, route):
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks import roofline as port_roofline
    from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda

    ndc, faces = bench_ndc
    size = 512                          # bench: 256^2 with anti-aliasing
    with resolve_cuda.forced_route(route):
        want = port_roofline.step_work(ndc, faces, size)
    got = roofline.step_work(ndc, faces, size)
    assert got["resolve"] == want["resolve (K2, or K7 + K8)"]
    assert got["pixel_scatter"] == want["pixel -> face scatter (K3)"]
    assert got["gather"] == want["face-vertex gather (K5)"]
    assert got["vertex_scatter"] == want["vertex gradient sum (K4)"]


def test_bound_takes_the_larger_side():
    t, by = roofline.bound_ms(3.35e9, 0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.bound_ms(0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)


def test_tests_count_only_faces_that_can_win():
    # one face inside the image, one degenerate (zero area), one off-screen
    fv = torch.tensor([[[[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]],
                        [[0.1, 0.1, 1.0], [0.1, 0.1, 1.0], [0.1, 0.1, 1.0]],
                        [[2.0, 2.0, 1.0], [3.0, 2.0, 1.0], [2.0, 3.0, 1.0]]]])
    size = 16
    c = ((2 * np.arange(size) + 1 - size) / size)
    inside = ((c >= -0.5) & (c <= 0.5)).sum()
    assert roofline.pixel_face_tests(fv, size) == inside * inside
