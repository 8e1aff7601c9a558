"""The JAX package's pipeline edge cases (tests/test_pipeline_edge.py) through
the port against the eager JAX pipeline, on the CPU (the kernels' plain
versions).

The scenes are ``utils.scenes.edge_scenes()``: one face wholly off screen,
one in front of the near plane, one visible face, a batch mixing an empty
slot with a full one (with and without anti-aliasing), and the fuzz test's
three random soups of duplicate and degenerate faces (its seed, 77, and its
draws), at 32^2.  Silhouettes and index maps are compared for every case;
the soups' textured RGBA over their ``create_textures`` atlas
(``texture_size`` 2), with gradients into the vertices and the atlas.

The oracle runs eagerly (``jax.disable_jit``), as in
``tests/test_torch_rasterize.py``: under ``jit`` XLA contracts the weight
math into multiply-adds.  Tolerances:

- silhouettes and index maps equal;
- RGBA within 1e-5 absolute (the JAX file's own bound between its backends);
- gradients within 1e-4 times the largest magnitude of JAX's (its bound
  between backends), exactly zero wherever JAX's is exactly zero, and
  finite everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops import rasterize as jras
from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map as jax_index_map
from neural_renderer_v2_pytorch_tpu_torch.utils.convert import params_from_jax, scene_from_numpy
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    EDGE_SIZE,
    EDGE_TEXTURE_SIZE,
    edge_scenes,
)

SCENES = edge_scenes()
SOUPS = sorted(name for name in SCENES if "textures" in SCENES[name])


def _assert_grads(got, want):
    """Within 1e-4 of JAX's largest magnitude, zero where JAX's is zero,
    finite."""
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[want == 0], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _index_maps(scene):
    """(port, JAX) index maps at the resolve's size."""
    size = EDGE_SIZE * (2 if scene["anti_aliasing"] else 1)
    v, f = scene["vertices"], scene["faces"]
    want = np.asarray(jax_index_map(jnp.asarray(v)[:, f], size))
    got = tnr.compute_face_index_map(torch.tensor(v)[:, torch.tensor(f).long()], size)
    return got.numpy(), want


@pytest.mark.parametrize("name", sorted(SCENES))
def test_edge_silhouettes_match_jax(name):
    """Images and index maps equal, the gradient of sum(images^2) as the
    module says; the JAX file's own checks of each case too."""
    scene = SCENES[name]
    v, f = scene["vertices"], scene["faces"]
    jhp = jras.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=scene["anti_aliasing"])
    hp = tnr.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=scene["anti_aliasing"])

    def loss(x):
        images = jras.rasterize_silhouettes(x, f, None, jhp)
        return jnp.sum(images ** 2), images

    with jax.disable_jit():
        (_, want), want_grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(v))
    x, faces, _ = scene_from_numpy(v, f, 0.0, "cpu")
    x.requires_grad_(True)
    images = tnr.rasterize_silhouettes(x, faces, None, hp)
    torch.sum(images ** 2).backward()

    np.testing.assert_array_equal(images.detach().numpy(), np.asarray(want))
    got_fim, want_fim = _index_maps(scene)
    np.testing.assert_array_equal(got_fim, want_fim)
    want_grad = np.asarray(want_grad)
    _assert_grads(x.grad.numpy(), want_grad)
    images = images.detach().numpy()
    if name in ("empty", "near"):
        assert images.max() == 0 and (got_fim == -1).all()
    if name == "empty":
        assert (want_grad == 0).all()
    if name.startswith("mixed"):
        assert images[0].sum() == 0 and images[1].sum() > 0
        assert np.abs(want_grad[0]).max() == 0 and np.abs(want_grad[1]).max() > 0
    if name == "single" or name.startswith("soup"):
        assert images.sum() > 0 and np.abs(want_grad).max() > 0


@pytest.mark.parametrize("name", SOUPS)
def test_edge_soup_rgba_matches_jax(name):
    """The soup's RGBA within 1e-5, the gradients of sum(rgba^2) into its
    vertices and atlas as the module says."""
    scene = SCENES[name]
    v, f = scene["vertices"], scene["faces"]
    jp = jras.RasterizeParam(vertices_textures=scene["vertices_t"], faces_textures=scene["faces_t"],
                             textures=scene["textures"], texture_size=EDGE_TEXTURE_SIZE)
    jhp = jras.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=False)

    def loss(x, t):
        rgba = jras.rasterize_rgba(x, f, jp.replace(textures=t), jhp)
        return jnp.sum(rgba ** 2), rgba

    with jax.disable_jit():
        (_, want), (want_gv, want_gt) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(v), jnp.asarray(scene["textures"]))
    params = params_from_jax(jp, "cpu")
    params = params.replace(textures=params.textures.requires_grad_(True))
    x, faces, _ = scene_from_numpy(v, f, 0.0, "cpu")
    x.requires_grad_(True)
    rgba = tnr.rasterize_rgba(x, faces, params,
                              tnr.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=False))
    torch.sum(rgba ** 2).backward()

    want = np.asarray(want)
    assert want[:, 3].sum() > 0
    np.testing.assert_allclose(rgba.detach().numpy(), want, rtol=0, atol=1e-5)
    _assert_grads(x.grad.numpy(), np.asarray(want_gv))
    _assert_grads(params.textures.grad.numpy(), np.asarray(want_gt))
    assert np.abs(np.asarray(want_gt)).max() > 0
