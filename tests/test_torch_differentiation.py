"""The NMR gradient op of the PyTorch port against the JAX package: exact
(same float32 ops in the same order; the step 2/H is a power of two here,
so dividing by it is exact whichever way a backend rounds it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.ops import differentiation as jd
from neural_renderer_v2_pytorch_tpu_torch.ops import differentiation as td


def test_maximum_tie_break():
    r = np.array([0.0, -1.0, 2.0, 2.0, 1.0, 3.0, 0.5], np.float32)
    l = np.array([0.0, -2.0, 1.0, 2.00005, 3.0, -1.0, 0.5 + 5e-5], np.float32)
    want = np.asarray(jd.maximum(jnp.asarray(r), jnp.asarray(l)))
    got = td.maximum(torch.tensor(r), torch.tensor(l)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, -2, 0, 3, -3, 0])


@pytest.mark.parametrize("C,size,binary", [(1, 32, True), (3, 32, False), (4, 16, False)])
def test_differentiation_vjp_matches_jax(C, size, binary):
    rng = np.random.RandomState(C)
    images = rng.rand(2, C, size, size).astype(np.float32)
    if binary:
        images = (images > 0.5).astype(np.float32)
    coords = rng.randn(2, 2, size, size).astype(np.float32)
    g = rng.randn(2, C, size, size).astype(np.float32)

    out, vjp = jax.vjp(jd.differentiation, jnp.asarray(images), jnp.asarray(coords))
    want_gi, want_gc = vjp(jnp.asarray(g))

    ti = torch.tensor(images, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=True)
    got = td.differentiation(ti, tc)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(ti.grad.numpy(), np.asarray(want_gi))
    np.testing.assert_array_equal(tc.grad.numpy(), np.asarray(want_gc))
    assert np.abs(tc.grad.numpy()).max() > 0
