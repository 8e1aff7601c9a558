"""The textured, lit and depth paths of the PyTorch port end to end, against
the JAX package and an in-repo golden.

The JAX oracle runs eagerly (``jax.disable_jit``), as in
tests/test_torch_rasterize.py.  Index maps must be equal and images within
1e-6; gradients with respect to the vertices, the atlas, the texel
coordinates and the light parameters within rtol 1e-5 and 1e-6 of the
largest magnitude: the two frameworks' autodiff rounds some VJPs in another
association, and the NMR backward sums 3-5 channels.

``tests/data/torch_port_rgb_golden.npz`` is made by the JAX package on CPU
(``python tests/test_torch_rgb.py`` rewrites it): the ``atlas`` and ``lit``
scenes of ``chip_smoke.py`` at 64^2 with anti-aliasing, with the atlas cut
to 40 x 64 texels so that its gradient fits the file.  A test here
regenerates it and compares, and ``chip_smoke.py`` holds the GPU to it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_renderer_v2_pytorch_tpu as jnr
import neural_renderer_v2_pytorch_tpu_torch as tnr
from neural_renderer_v2_pytorch_tpu.ops import rasterize as jras
from neural_renderer_v2_pytorch_tpu.ops.resolve import compute_face_index_map
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import (
    gather_face_vertices,
    resolve_and_gather,
)
from neural_renderer_v2_pytorch_tpu_torch.utils.convert import (
    lights_from_jax,
    params_from_jax,
)
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    atlas_scene,
    lit_light_arrays,
    texel_scene,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_rgb_golden.npz")
# the lights of the JAX perf matrix (benchmarks/scaling.py:161-166)
LIT = tuple((kind, False) for kind, _ in lit_light_arrays())


def _scene(n_major, n_minor, texture, azimuth=20):
    """NDC vertices [1, nv, 3] (through the JAX camera), faces, texel
    coordinates [1, nvt, 2], their faces, an atlas [1, 3, th, tw] and the
    texture_size to render it with; the atlas is cut to 40 x 64."""
    if texture == "atlas":
        ts = None
        v, f, vt, ft, tex = atlas_scene(n_major, n_minor, 40, 64)
    else:
        ts = int(texture[-1])
        v, f, vt, ft, tex = texel_scene(n_major, n_minor, ts)
    r = jnr.Renderer()
    r.viewpoints = jnr.get_points_from_angles(2.732, 30, azimuth)
    ndc = np.asarray(r.transform_vertices(jnp.asarray(v[None])))
    return ndc, f, vt, ft, tex, ts


def _light_arrays(spec, seed=3):
    """(kind, backside) -> the light's float arrays: the perf matrix's for
    ``LIT``, seeded otherwise."""
    if spec == LIT:
        return [a for _, a in lit_light_arrays()]
    rng = np.random.RandomState(seed)
    out = []
    for kind, _ in spec:
        a = dict(color=rng.uniform(0.2, 0.8, (1, 3)).astype(np.float32))
        if kind == "directional":
            a["direction"] = rng.uniform(-1, 1, (1, 3)).astype(np.float32)
        if kind == "specular":
            a["alpha"] = np.array([2.0], np.float32)
        out.append(a)
    return out


def _lights(lib, spec, arrays):
    cls = {"ambient": lib.AmbientLight, "directional": lib.DirectionalLight,
           "specular": lib.SpecularLight}
    out = []
    for (kind, backside), a in zip(spec, arrays):
        out.append(cls[kind](**a) if kind == "ambient" else cls[kind](**a, backside=backside))
    return tuple(out)


def _target(entry, image_size, seed=4):
    c = {"rgba": 4, "rgb": 3, "depth": 1, "all": 5}[entry]
    shape = (1, image_size, image_size) if entry == "depth" else (1, c, image_size, image_size)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_render(entry, scene, spec, hp, target, background_color=None):
    """(image, {name: gradient}) of sum((image - target)^2), or of
    sum(image^2) when ``target`` is None, through the JAX package."""
    ndc, f, vt, ft, tex, ts = scene
    arrays = _light_arrays(spec) if spec is not None else None
    fn = getattr(jras, "rasterize_" + entry)

    def loss(x, vt_, tex_, la):
        p = jras.RasterizeParam(
            vertices_textures=vt_, faces_textures=jnp.asarray(ft), textures=tex_,
            texture_size=ts, background_color=background_color,
            lights=None if la is None else _lights(jnr, spec, la),
        )
        im = fn(x, f, p, hp)
        return jnp.sum(im ** 2 if target is None else (im - target) ** 2), im

    with jax.disable_jit():
        grads, im = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(ndc), jnp.asarray(vt), jnp.asarray(tex),
            None if arrays is None else jax.tree_util.tree_map(jnp.asarray, arrays),
        )
    out = dict(vertices=grads[0], vertices_textures=grads[1], textures=grads[2])
    for i, a in enumerate(grads[3] or ()):
        out.update({f"light{i}_{k}": v for k, v in a.items()})
    return np.asarray(im), {k: np.asarray(v) for k, v in out.items()}


def _port_render(entry, scene, spec, hp, target, background_color=None, device="cpu"):
    """The port's counterpart of :func:`_jax_render`, on ``device``."""
    ndc, f, vt, ft, tex, ts = scene
    leaves = {"vertices": ndc, "vertices_textures": vt, "textures": tex}
    arrays = _light_arrays(spec) if spec is not None else []
    for i, a in enumerate(arrays):
        leaves.update({f"light{i}_{k}": v for k, v in a.items()})
    t = {k: torch.tensor(v, device=device, requires_grad=True) for k, v in leaves.items()}
    lights = None
    if spec is not None:
        la = [{k: t[f"light{i}_{k}"] for k in a} for i, a in enumerate(arrays)]
        lights = _lights(tnr, spec, la)
    p = tnr.RasterizeParam(
        vertices_textures=t["vertices_textures"], faces_textures=torch.tensor(ft, device=device),
        textures=t["textures"], texture_size=ts, background_color=background_color,
        lights=lights,
    )
    im = getattr(tnr, "rasterize_" + entry)(t["vertices"], torch.tensor(f, device=device), p, hp)
    d = im if target is None else im - torch.tensor(target, device=device)
    torch.sum(d * d).backward()
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu().numpy()
             for k, v in t.items()}
    return im.detach().cpu().numpy(), grads


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)


def _index_maps(ndc, f, size):
    want = np.asarray(compute_face_index_map(jnp.asarray(np.take(ndc, f, axis=1)), size))
    x = torch.tensor(ndc)
    got = resolve_and_gather(gather_face_vertices(x, torch.tensor(f)), size, 0.1, 100.0,
                             True, None, True)[0].numpy()
    return got, want


CASES = {
    # name: (entry, texture, lights, background_color, anti_aliasing)
    "rgba-atlas": ("rgba", "atlas", None, None, True),
    "rgba-texel2-lit": ("rgba", "texel2", LIT, None, True),
    "rgb-texel4-background": ("rgb", "texel4", None, (0.2, 0.4, 0.6), False),
    "depth": ("depth", "atlas", None, None, True),
    "all-atlas-lights-background": (
        "all", "atlas", (("directional", True), ("specular", True), ("ambient", False)),
        (0.9, 0.1, 0.3), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_point_matches_jax(case):
    entry, texture, spec, bg, aa = CASES[case]
    scene = _scene(16, 12, texture)
    hp_fields = dict(image_size=32, anti_aliasing=aa)
    target = _target(entry, 32)
    want_im, want_g = _jax_render(entry, scene, spec, jras.RasterizeHyperparam(**hp_fields),
                                  target, bg)
    got_im, got_g = _port_render(entry, scene, spec, tnr.RasterizeHyperparam(**hp_fields),
                                 target, bg)
    np.testing.assert_allclose(got_im, want_im, rtol=0, atol=1e-6)
    assert np.abs(want_im).max() > 0.1
    _assert_grads(got_g, want_g)
    assert np.abs(want_g["vertices"]).max() > 0
    if entry != "depth":
        assert np.abs(want_g["textures"]).max() > 0
        assert np.abs(want_g["vertices_textures"]).max() > 0
    got_fim, want_fim = _index_maps(scene[0], scene[1], 64 if aa else 32)
    np.testing.assert_array_equal(got_fim, want_fim)


def test_empty_lights_render_black():
    scene = _scene(16, 12, "atlas")
    im, _ = _port_render("rgb", scene, (), tnr.RasterizeHyperparam(image_size=16), None)
    assert np.all(im == 0)


def _make_rgb_golden():
    """The atlas and lit scenes at 64^2 with anti-aliasing, loss
    sum(rgba^2)."""
    hp = jras.RasterizeHyperparam(image_size=64)
    out = {}
    for name, texture, spec in (("atlas", "atlas", None), ("lit", "texel2", LIT)):
        ndc, f, vt, ft, tex, ts = scene = _scene(40, 32, texture, azimuth=0)
        image, grads = _jax_render("rgba", scene, spec, hp, None)
        keep = ("vertices", "textures", "vertices_textures") if name == "atlas" else (
            ["vertices"] + sorted(k for k in grads if k.startswith("light")))
        out[f"{name}_image"] = image
        out.update({f"{name}_grad_{k}": grads[k] for k in keep})
    out["ndc"], out["faces"] = ndc, f
    out["fim"] = np.asarray(compute_face_index_map(jnp.asarray(np.take(ndc, f, axis=1)), 128))
    return out


def test_rgb_golden_is_current_and_port_matches_it():
    stored = dict(np.load(GOLDEN))
    fresh = _make_rgb_golden()
    assert sorted(stored) == sorted(fresh)
    for k in ("ndc", "faces", "fim", "atlas_image", "lit_image"):
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    _assert_grads({k: stored[k] for k in fresh if "_grad_" in k},
                  {k: fresh[k] for k in fresh if "_grad_" in k})

    hp = tnr.RasterizeHyperparam(image_size=64)
    for name, texture, spec in (("atlas", "atlas", None), ("lit", "texel2", LIT)):
        _, f, vt, ft, tex, ts = _scene(40, 32, texture, azimuth=0)
        scene = (stored["ndc"], stored["faces"], vt, ft, tex, ts)
        image, grads = _port_render("rgba", scene, spec, hp, None)
        np.testing.assert_allclose(image, stored[f"{name}_image"], rtol=0, atol=1e-6)
        _assert_grads({k: grads[k] for k in grads if f"{name}_grad_{k}" in stored},
                      {k[len(name) + 6:]: v for k, v in stored.items()
                       if k.startswith(f"{name}_grad_")})
    got_fim, _ = _index_maps(stored["ndc"], stored["faces"], 128)
    np.testing.assert_array_equal(got_fim, stored["fim"])


def test_params_and_lights_from_jax_render_the_same_image():
    ndc, f, vt, ft, tex, ts = _scene(16, 12, "texel2")
    arrays = _light_arrays(LIT)
    jp = jras.RasterizeParam(
        vertices_textures=vt, faces_textures=ft, textures=tex, texture_size=ts,
        lights=_lights(jnr, LIT, arrays), background_color=(0.1, 0.2, 0.3),
        slot_occupancy=(np.zeros(1, np.int32), np.zeros(1, np.int32)),
    )
    fields = {fd.name: getattr(jp, fd.name) for fd in dataclasses.fields(jp)}
    params = params_from_jax(fields, "cpu")
    assert params.faces_textures.dtype == torch.int32 and params.texture_size == 2
    assert all(type(a).__name__ == type(b).__name__ for a, b in zip(params.lights, jp.lights))
    hp = jras.RasterizeHyperparam(image_size=32, batch_chunk=None)
    with jax.disable_jit():
        want = np.asarray(jras.rasterize_rgba(ndc, f, jp.replace(slot_occupancy=None), hp))
    got = tnr.rasterize_rgba(torch.tensor(ndc), torch.tensor(f), params,
                             tnr.RasterizeHyperparam(image_size=32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="bogus"):
        params_from_jax({**fields, "bogus": 1}, "cpu")
    spec = jnr.SpecularLight(color=np.ones((1, 3), np.float32), backside=True)
    (light,) = lights_from_jax([spec], "cpu")
    assert isinstance(light, tnr.SpecularLight) and light.alpha is None and light.backside
    with pytest.raises(TypeError):
        lights_from_jax([object()], "cpu")


def test_renderer_render_rgb_and_depth_match_jax():
    """Through both Renderers (their cameras agree to ~5e-7, see
    tests/test_torch_camera.py)."""
    v, f, vt, ft, tex = texel_scene(16, 12, 2)
    jr, tr = jnr.Renderer(), tnr.Renderer("cpu")
    for r in (jr, tr):
        r.image_size, r.texture_size = 32, 2
        r.viewpoints = jnr.get_points_from_angles(2.732, 30, 20)
    x = torch.tensor(v[None])
    args = (vt, ft, tex)
    targs = tuple(torch.tensor(a) for a in args)
    pairs = [
        (jr.render(v[None], f, *args), tr.render(x, f, *targs)),
        (jr.render_rgb(v[None], f, *args), tr.render_rgb(x, f, *targs)),
        (jr.render_depth(v[None], f), tr.render_depth(x, f)),
    ]
    for want, got in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_texture_and_vertex_fit_loss_falls():
    """20 Adam steps fitting a torus's atlas and vertices to a target render."""
    v, f, vt, ft, tex = atlas_scene(16, 12, 40, 64)
    renderer = tnr.Renderer("cpu")
    renderer.image_size = 32
    renderer.viewpoints = tnr.get_points_from_angles(2.732, 30, 0)
    vt_t, ft_t = torch.tensor(vt), torch.tensor(ft)
    target = renderer.render(torch.tensor(v[None]), f, vt_t, ft_t, torch.tensor(tex)).detach()
    x = torch.tensor(0.9 * v[None], requires_grad=True)
    tex = torch.full((1, 3, 40, 64), 0.5, requires_grad=True)
    opt = torch.optim.Adam([{"params": [x], "lr": 0.005}, {"params": [tex], "lr": 0.05}])
    losses = []
    for _ in range(20):
        opt.zero_grad()
        loss = torch.sum((renderer.render(x, f, vt_t, ft_t, tex) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **_make_rgb_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
