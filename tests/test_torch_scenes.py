"""The port's procedural scenes against the JAX package's perf-matrix
tooling: ``scenes.subdivide`` is ``benchmarks/scaling.py``'s midpoint
subdivision, which builds the face-count sweep that the port's
``neural_renderer_v2_pytorch_tpu_torch.benchmarks.scaling`` times (2,560
faces of ``torus(40, 32)`` to 655,360), bit for bit."""

import importlib.util
import os

import numpy as np
import pytest

from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere, subdivide, torus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scaling():
    spec = importlib.util.spec_from_file_location(
        "scaling", os.path.join(ROOT, "benchmarks", "scaling.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mesh", ["torus(40, 32)", "icosphere(1)"])
def test_subdivide_is_the_perf_matrix_sweeps(mesh):
    want_subdivide = _scaling().subdivide
    v, f = torus(40, 32) if mesh == "torus(40, 32)" else icosphere(1)
    nf = f.shape[0]
    for level in range(1, 4):
        want = want_subdivide(v, f)
        v, f = subdivide(v, f)
        for got, w in zip((v, f), want):
            assert got.dtype == w.dtype
            np.testing.assert_array_equal(got, w)
        assert f.shape == (nf * 4 ** level, 3) and v.shape == (3 * f.shape[0] // 2, 3)
