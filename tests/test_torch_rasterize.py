"""The silhouette slice of the PyTorch port end to end, against the JAX
package and the in-repo goldens.

The JAX oracle for gradients runs eagerly (``jax.disable_jit``): under
``jit`` XLA contracts the barycentric weights into multiply-adds, which
moves edge-pixel weights by up to ~1e-5 relative and the vertex gradients
with them; eagerly, both sides round every float32 op alike.

``tests/data/torch_port_golden.npz`` is made by the JAX package on CPU
(``python tests/test_torch_rasterize.py`` rewrites it); a test here
regenerates it and compares, and ``chip_smoke.py`` holds the GPU to it.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops.rasterize import RasterizeHyperparam as JaxHP
from neural_renderer_v2_pytorch_tpu.ops.rasterize import rasterize_silhouettes as jax_sil
from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map
from neural_renderer_v2_pytorch_tpu_torch.utils.convert import (
    hyperparams_from_jax,
    scene_from_numpy,
)
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere, torus

DATA = os.path.join(os.path.dirname(__file__), "data")
PORT_GOLDEN = os.path.join(DATA, "torch_port_golden.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _target(size):
    yy, xx = np.mgrid[0:size, 0:size]
    return ((xx + yy) % 7 / 6.0).astype(np.float32)[None]


def _jax_scene(n_major=16, n_minor=12, azimuth=20):
    v, f = torus(n_major, n_minor)
    r = jnr.Renderer()
    r.viewpoints = jnr.get_points_from_angles(2.732, 30, azimuth)
    ndc = np.asarray(r.transform_vertices(jnp.asarray(v[None])))
    return ndc, f


def _jax_image_and_grads(ndc, faces, hp, target):
    def loss(x):
        im = jax_sil(x, faces, None, hp)
        return jnp.sum((im - target) ** 2), im

    with jax.disable_jit():
        (_, im), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(ndc))
    return np.asarray(im), np.asarray(g)


def _port_image_and_grads(ndc, faces, hp, target):
    x = torch.tensor(ndc, requires_grad=True)
    im = tnr.rasterize_silhouettes(x, torch.tensor(faces), None, hp)
    torch.sum((im - torch.tensor(target)) ** 2).backward()
    return im.detach().numpy(), x.grad.numpy()


def _assert_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("anti_aliasing,draw_backside", [(True, True), (False, False)])
def test_slice_matches_jax(anti_aliasing, draw_backside):
    ndc, faces = _jax_scene()
    # 64^2: the golden's shapes, so the eager oracle's compiled ops are shared
    jhp = JaxHP(image_size=64, anti_aliasing=anti_aliasing, draw_backside=draw_backside)
    target = _target(64)
    want_im, want_g = _jax_image_and_grads(ndc, faces, jhp, target)
    hp = hyperparams_from_jax(dataclasses.asdict(jhp))
    got_im, got_g = _port_image_and_grads(ndc, faces, hp, target)
    np.testing.assert_array_equal(got_im, want_im)
    assert 0.05 < want_im.mean() < 0.5
    _assert_grads(got_g, want_g)
    # the jitted JAX pipeline gives the same image
    np.testing.assert_array_equal(got_im, np.asarray(jax_sil(ndc, faces, None, jhp)))


def test_vertex_gradients_match_in_repo_golden():
    """The scene and loss of tests/test_gradient_golden.py."""
    verts = np.array(
        [[0.8, 0.8, 1.0], [-0.5, -0.8, 1.0], [-0.8, 0.8, 1.0], [0.5, -0.8, 1.0]], np.float32
    )
    faces = np.array([[0, 1, 2], [3, 1, 0]], np.int32)
    hp = tnr.RasterizeHyperparam(image_size=64, anti_aliasing=False)
    _, g = _port_image_and_grads(verts[None], faces, hp, _target(64))
    golden = np.load(os.path.join(DATA, "vertex_grads_golden.npz"))["grads"]
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, golden, rtol=1e-5, atol=1e-7)


def _make_port_golden():
    """torus(16, 12) at 64^2 with anti-aliasing (resolve at 128^2)."""
    ndc, faces = _jax_scene()
    target = _target(64)
    image, grads = _jax_image_and_grads(ndc, faces, JaxHP(image_size=64), target)
    fv = np.take(ndc, faces, axis=1)
    fim = np.asarray(compute_face_index_map(jnp.asarray(fv), 128))
    return dict(ndc=ndc, faces=faces, target=target, fim=fim, image=image, grads=grads)


def test_port_golden_is_current_and_port_matches_it():
    stored = dict(np.load(PORT_GOLDEN))
    fresh = _make_port_golden()
    assert sorted(stored) == sorted(fresh)
    for k in ("ndc", "faces", "target", "fim", "image"):
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    _assert_grads(stored["grads"], fresh["grads"])

    image, grads = _port_image_and_grads(
        stored["ndc"], stored["faces"], tnr.RasterizeHyperparam(image_size=64), stored["target"]
    )
    np.testing.assert_array_equal(image, stored["image"])
    _assert_grads(grads, stored["grads"])


def test_vertex_fit_loss_falls():
    """20 Adam steps fitting a sphere's vertices to a torus silhouette."""
    device = torch.device("cpu")
    tv, tf = torus(16, 12)
    sv, sf = icosphere(2)
    renderer = tnr.Renderer(device)
    renderer.image_size = 32
    renderer.viewpoints = tnr.get_points_from_angles(2.732, 30, 0)
    target = renderer.render_silhouettes(torch.tensor(tv[None]), tf)
    x = torch.tensor(sv[None], requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.01)
    losses = []
    for _ in range(20):
        opt.zero_grad()
        loss = torch.sum((renderer.render_silhouettes(x, sf) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], losses


def test_import_leaves_jax_out():
    code = (
        "import sys, neural_renderer_v2_pytorch_tpu_torch as m; "
        "m.Renderer('cpu'); "
        "assert not any(k == 'jax' or k.startswith(('jax.', 'neural_renderer_v2_pytorch_tpu.')) "
        "for k in sys.modules), sorted(k for k in sys.modules if 'jax' in k)"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_convert_carries_inputs_and_rejects_unknown_fields():
    fields = dataclasses.asdict(JaxHP(image_size=96, anti_aliasing=False))
    hp = hyperparams_from_jax(fields)
    assert hp == tnr.RasterizeHyperparam(image_size=96, anti_aliasing=False)
    with pytest.raises(ValueError, match="lights"):
        hyperparams_from_jax({**fields, "lights": 1})
    v, f = torus(4, 3)
    tv, tf, eye = scene_from_numpy(v, f, (0.0, 1.0, -2.0), "cpu")
    assert (tv.dtype, tf.dtype, eye.dtype) == (torch.float32, torch.int32, torch.float32)
    np.testing.assert_array_equal(tf.numpy(), f)


if __name__ == "__main__":
    np.savez_compressed(PORT_GOLDEN, **_make_port_golden())
    print("wrote", PORT_GOLDEN, os.path.getsize(PORT_GOLDEN), "bytes")
