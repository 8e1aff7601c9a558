"""The NMR gradient's north star on the port (JAX package
tests/test_rasterize.py:165-204): a two-triangle square at z = 1, 0.1 of
the canvas, fitted by 350 steps of the port's ``Adam(lr=0.005)`` to a
target silhouette under the IoU loss ``1 - sum(i r) / sum(i + r - i r)``;
the loss must fall below 0.01.  The reference's target, gradient.png, is not
in the repository: the target is the silhouette of a larger square moved
off the centre (``scenes.CONVERGENCE_TARGET``).  256^2 without
anti-aliasing, the JAX test's size, through the kernels' plain versions.
The first 5 losses are held to the same fit run eagerly in JAX with
``optax.adam(0.005)`` (rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops.rasterize import RasterizeHyperparam as JaxHP
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import CONVERGENCE_TARGET, square

SIZE = 256
STEPS = 350


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread, so that this file neither slows
    nor is slowed by the test processes it shares the cores with."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _target():
    tv, tf = square(**CONVERGENCE_TARGET)
    hp = tnr.RasterizeHyperparam(image_size=SIZE, anti_aliasing=False)
    with torch.no_grad():
        return tnr.rasterize_silhouettes(torch.tensor(tv)[None], torch.tensor(tf), None, hp)[0]


def _port_fit(ref, steps):
    v0, faces = square(0.1)
    v = torch.tensor(v0, requires_grad=True)
    faces = torch.tensor(faces)
    hp = tnr.RasterizeHyperparam(image_size=SIZE, anti_aliasing=False)
    opt = tnr.Adam([v], lr=0.005)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        image = tnr.rasterize_silhouettes(v[None], faces, None, hp)[0]
        loss = 1.0 - torch.sum(image * ref) / torch.sum(image + ref - image * ref)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if losses[-1] < 0.01:
            break
    return losses


def test_silhouette_fit_converges():
    ref = _target()
    assert 0.05 < float(ref.mean()) < 0.2
    losses = _port_fit(ref, STEPS)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.01, f"did not converge: last losses {losses[-5:]}"


def test_first_losses_match_jax():
    ref = _target()
    v0, faces = square(0.1)
    hyper = JaxHP(image_size=SIZE, anti_aliasing=False)
    jref = jnp.asarray(ref.numpy())

    def loss_fn(v):
        image = jnr.rasterize_silhouettes(v[None], jnp.asarray(faces), None, hyper)[0]
        return 1.0 - jnp.sum(image * jref) / jnp.sum(image + jref - image * jref)

    opt = optax.adam(0.005)
    v = jnp.asarray(v0)
    state = opt.init(v)
    want = []
    with jax.disable_jit():
        for _ in range(5):
            loss, g = jax.value_and_grad(loss_fn)(v)
            updates, state = opt.update(g, state)
            v = optax.apply_updates(v, updates)
            want.append(float(loss))
    np.testing.assert_allclose(_port_fit(ref, 5), want, rtol=1e-4)
