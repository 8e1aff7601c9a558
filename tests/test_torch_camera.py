"""Camera transforms of the PyTorch port against the JAX package.

Not bit-equal: XLA fuses and contracts the camera math (47% of coordinates
equal on a torus scene, largest difference 4.8e-7), so the comparison is at
rtol 1e-6, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import torus

TOL = dict(rtol=1e-6, atol=1e-6)


def _vertices(bs=2, nv=50, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (bs, nv, 3)).astype(np.float32)


@pytest.mark.parametrize("eye", [
    (0.0, 0.0, -2.732),
    jnr.get_points_from_angles(2.732, 30, 45),
    np.array([[1.0, 2.0, -3.0], [-2.0, 0.5, 2.5]], np.float32),
])
def test_look_at_matches_jax(eye):
    v = _vertices()
    want = np.asarray(jnr.look_at(jnp.asarray(v), eye))
    got = tnr.look_at(torch.tensor(v), eye).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("angle", [30.0, 15, np.array([30.0, 45.0], np.float32)])
def test_perspective_matches_jax(angle):
    v = _vertices()
    v[..., 2] = np.abs(v[..., 2]) + 1.0
    want = np.asarray(jnr.perspective(jnp.asarray(v), angle))
    a = torch.tensor(angle) if isinstance(angle, np.ndarray) else angle
    got = tnr.perspective(torch.tensor(v), a).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_get_points_from_angles_matches_jax():
    assert tnr.get_points_from_angles(2.732, 30, 45) == jnr.get_points_from_angles(2.732, 30, 45)
    d, e, a = (np.array(x, np.float32) for x in ([2.0, 3.0], [30.0, -10.0], [45.0, 200.0]))
    want = np.asarray(jnr.get_points_from_angles(jnp.asarray(d), jnp.asarray(e), jnp.asarray(a)))
    got = tnr.get_points_from_angles(torch.tensor(d), torch.tensor(e), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(TypeError):
        tnr.get_points_from_angles(d, e, a)        # numpy only: no device given


def test_renderer_transform_matches_jax():
    v, _ = torus(16, 12)
    eye = jnr.get_points_from_angles(2.732, 30, 20)
    jr = jnr.Renderer()
    jr.viewpoints = eye
    tr = tnr.Renderer("cpu")
    tr.viewpoints = eye
    want = np.asarray(jr.transform_vertices(jnp.asarray(v[None])))
    got = tr.transform_vertices(torch.tensor(v[None])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_camera_gradient_matches_jax():
    """The camera is differentiable (examples optimise the eye position)."""
    v, _ = torus(16, 12)
    v = v[None]
    eye = np.array([0.5, 1.2, -2.5], np.float32)

    def jloss(e):
        return jnp.sum(jnr.perspective(jnr.look_at(jnp.asarray(v), e[None])) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(eye)))
    e = torch.tensor(eye, requires_grad=True)
    torch.sum(tnr.perspective(tnr.look_at(torch.tensor(v), e[None])) ** 2).backward()
    np.testing.assert_allclose(e.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_renderer_rejects_unported_and_misplaced_inputs():
    """``camera_mode="look"`` renders (it is ported); an unknown camera
    mode applies no viewpoint transform, only the perspective, as the JAX
    Renderer does (equal to its ``transform_vertices`` on the same
    inputs); inputs on another device than the renderer's raise."""
    v, f = torus(16, 12)
    r = tnr.Renderer("cpu")
    r.image_size = 16
    r.camera_mode = "look"
    r.viewpoints = (0.0, 0.0, -2.732)
    images = r.render_silhouettes(torch.tensor(v[None]), f)
    assert images.shape == (1, 16, 16) and 0.05 < float(images.mean()) < 0.95
    r.camera_mode = "orbit"
    jr = jnr.Renderer()
    jr.camera_mode = "orbit"
    x = _vertices()
    x[..., 2] = np.abs(x[..., 2]) + 1.0
    for perspective in (True, False):
        r.perspective = jr.perspective = perspective
        want = np.asarray(jr.transform_vertices(jnp.asarray(x), lights=None))
        np.testing.assert_allclose(r.transform_vertices(torch.tensor(x), lights=None).numpy(),
                                   want, **TOL)
    np.testing.assert_array_equal(want, x)
    r = tnr.Renderer("meta")
    with pytest.raises(ValueError):
        r.transform_vertices(torch.zeros(1, 3, 3))


@pytest.mark.parametrize("direction,up", [
    (None, None),
    ((0.3, -0.2, 1.0), None),
    (np.array([[0.3, -0.2, 1.0], [-0.1, 0.4, 0.8]], np.float32), (0.1, 1.0, 0.2)),
])
def test_look_matches_jax(direction, up):
    v = _vertices()
    eye = np.random.RandomState(1).uniform(-3, 3, (2, 3)).astype(np.float32)
    want = np.asarray(jnr.look(jnp.asarray(v), eye, direction, up))
    got = tnr.look(torch.tensor(v), torch.tensor(eye),
                   None if direction is None else torch.tensor(direction),
                   None if up is None else torch.tensor(up)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _look_renderers(direction):
    eye = (0.4, 0.9, -2.6)
    jr, tr = jnr.Renderer(), tnr.Renderer("cpu")
    for r in (jr, tr):
        r.camera_mode = "look"
        r.image_size = 64
        r.viewpoints = eye
    jr.camera_direction = jnp.asarray(direction)
    return jr, tr


def test_renderer_look_matches_jax():
    """``camera_mode="look"`` at 64^2 (resolve at 128^2): silhouettes and
    face-index maps equal to the JAX Renderer's; the gradient with respect
    to ``camera_direction`` within 1e-4 of the eager JAX one's largest
    magnitude."""
    from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map as jfim

    v, f = torus(10, 8)
    direction = np.array([-0.15, -0.3, 1.0], np.float32)
    jr, tr = _look_renderers(direction)
    target = np.random.RandomState(2).rand(1, 64, 64).astype(np.float32)

    def jloss(d):
        jr.camera_direction = d
        im = jr.render_silhouettes(jnp.asarray(v[None]), jnp.asarray(f))
        return jnp.sum((im - target) ** 2), im

    with jax.disable_jit():
        (_, want_im), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(direction))
        jr.camera_direction = jnp.asarray(direction)
        want_fim = np.asarray(jfim(jnp.take(jr.transform_vertices(jnp.asarray(v[None])), f,
                                            axis=1), 128))

    d = torch.tensor(direction, requires_grad=True)
    tr.camera_direction = d
    im = tr.render_silhouettes(torch.tensor(v[None]), f)
    torch.sum((im - torch.tensor(target)) ** 2).backward()
    with torch.no_grad():
        got_fim = tnr.compute_face_index_map(
            tr.transform_vertices(torch.tensor(v[None]))[:, torch.tensor(f).long()], 128)

    np.testing.assert_array_equal(got_fim.numpy(), want_fim)
    np.testing.assert_array_equal(im.detach().numpy(), np.asarray(want_im))
    assert 0.05 < float(im.detach().mean()) < 0.5
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), want_g, rtol=1e-4,
                               atol=1e-4 * np.abs(want_g).max())
