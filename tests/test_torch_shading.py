"""The port's shading functions against the JAX package's, on the same
seeded inputs: values and gradients.

The JAX side runs eagerly (``jax.disable_jit``), so that each op rounds on
its own as the port's do.  Tolerance 1e-5 of the largest magnitude (as the
JAX package's tests/test_lighting.py:114-129), and rtol 1e-5: autodiff
rounds some VJPs in another association (``(-g * x) / y**2`` against
``(-g * x) * y**-2``), which a sum of cancelling terms, as in the gradient
of the perspective-correct texel coordinates with respect to z, magnifies;
and ``pow`` is computed by two libraries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_renderer_v2_pytorch_tpu.models import lights as jl
from neural_renderer_v2_pytorch_tpu.ops import maps as jm
from neural_renderer_v2_pytorch_tpu.ops import shading as js
from neural_renderer_v2_pytorch_tpu_torch.models import lights as tl
from neural_renderer_v2_pytorch_tpu_torch.ops import gather_resolve as tgr
from neural_renderer_v2_pytorch_tpu_torch.ops import maps as tm
from neural_renderer_v2_pytorch_tpu_torch.ops import shading as ts
from neural_renderer_v2_pytorch_tpu_torch.utils.helpers import create_textures
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import icosphere

BS, H, W = 2, 12, 16


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    scale = np.abs(want[finite]).max() if finite.any() else 1.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5 * scale)


def _both(jax_fn, torch_fn, inputs, seed):
    """Run both on ``inputs`` (numpy; float arrays are differentiated, the
    rest passed as they are) with a seeded cotangent; compare values and
    every gradient."""
    diff = [i for i, x in enumerate(inputs) if np.asarray(x).dtype == np.float32]

    def jf(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        return jax_fn(*full)

    with jax.disable_jit():
        out, vjp = jax.vjp(jf, *(jnp.asarray(inputs[i]) for i in diff))
        ct = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
        want_grads = vjp(jnp.asarray(ct))
    targs = [torch.tensor(x) for x in inputs]
    for i in diff:
        targs[i].requires_grad_(True)
    got = torch_fn(*targs)
    got.backward(torch.tensor(ct))
    _close(got.detach().numpy(), out)
    for i, want in zip(diff, want_grads):
        grad = targs[i].grad                 # None where the input is unused
        _close(np.zeros_like(want) if grad is None else grad.numpy(), want)
    return np.asarray(out)


def _planes(seed, th=40, tw=64):
    """fvm [bs, 9, H, W] (z > 0), texel-coordinate triangles [bs, 6, H, W]
    inside a th x tw atlas, weights [bs, 3, H, W] summing to 1, and a face
    index map with background."""
    rng = np.random.RandomState(seed)
    fvm = rng.uniform(-1, 1, (BS, 9, H, W)).astype(np.float32)
    fvm[:, 2::3] = rng.uniform(0.5, 3.0, (BS, 3, H, W))
    uv = np.empty((BS, 6, H, W), np.float32)
    uv[:, 0::2] = rng.uniform(0, tw - 1, (BS, 3, H, W))
    uv[:, 1::2] = rng.uniform(0, th - 1, (BS, 3, H, W))
    w = rng.uniform(0, 1, (BS, 3, H, W)).astype(np.float32)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    fim = rng.randint(-1, 30, (BS, H, W)).astype(np.int32)
    return fvm, uv, w, fim


def test_uv_coords():
    fvm, uv, w, fim = _planes(0)

    def run(lib, fvm, uv, w, fim):
        x, y = lib._uv_coords(
            (fvm[:, 2], fvm[:, 5], fvm[:, 8]), (uv[:, 0], uv[:, 2], uv[:, 4]),
            (uv[:, 1], uv[:, 3], uv[:, 5]), (w[:, 0], w[:, 1], w[:, 2]), fim >= 0, 1e-5,
        )
        return (jnp if lib is js else torch).stack((x, y), 1)

    out = _both(lambda *a: run(js, *a), lambda *a: run(ts, *a), [fvm, uv, w, fim], 1)
    assert (out[:, :, fim[0] < 0][0] == 0).all()


ATLAS = (40, 64)
# the loaded-atlas sampler's cases: random triangles; coordinates exactly at
# the uv-bbox's lo and at hi - eps (ties, whose gradient torch.minimum and
# torch.maximum split evenly); anchors on the atlas's last column and last
# row (the anchor's clamp); images all background; one atlas expanded over
# four views (batch stride 0)
ATLAS_CASES = ["random", "ties", "atlas_edges", "background", "shared_atlas"]


def _atlas_case(case):
    """(fvm, uv, w, fim, atlas, views) of one of :data:`ATLAS_CASES`: the
    inputs of ``sample_textures_atlas_planes`` (:func:`_planes` in a 40 x 64
    atlas), with ``views`` the batch the one atlas [1, 3, th, tw] is
    expanded to, or None."""
    th, tw = ATLAS
    fvm, uv, w, fim = _planes(2)
    atlas = np.random.RandomState(3).rand(BS, 3, th, tw).astype(np.float32)
    views = None
    group = np.random.RandomState(4).randint(0, 4, (BS, H, W))
    if case == "ties":
        # weights (1, 0, 0) at depth 1: the coordinates are exactly u0, v0
        tie = group > 0
        w[:, 0][tie], w[:, 1][tie], w[:, 2][tie] = 1.0, 0.0, 0.0
        fvm[:, 2][tie] = 1.0
        fim[tie] = np.abs(fim[tie])
        u, v = uv[:, 0::2], uv[:, 1::2]
        # x at lo (u0 the least), and in group 2 also u0 == u1
        lo = group >= 1
        u[:, 1][lo] = u[:, 0][lo] + 7.5
        u[:, 2][lo] = u[:, 0][lo] + 3.25
        u[:, 1][group == 2] = u[:, 0][group == 2]
        # y at hi - eps (v1 the greatest, v0 = v1 - eps in float32)
        v[:, 1][tie] = np.float32(30.0)
        v[:, 2][tie] = np.float32(5.0)
        v[:, 0][tie] = np.float32(30.0) - np.float32(1e-5)
        uv[:, 0::2], uv[:, 1::2] = u, v
    elif case == "atlas_edges":
        # group 1: the last column (x in [tw - 1, tw)); group 2: the last
        # row (the anchor clamped to T - tw - 2); group 3: both
        u, v = uv[:, 0::2], uv[:, 1::2]
        u[np.broadcast_to((group & 1)[:, None] > 0, u.shape)] = tw - 0.5
        v[np.broadcast_to((group & 2)[:, None] > 0, v.shape)] = th - 0.5
        uv[:, 0::2], uv[:, 1::2] = u, v
    elif case == "background":
        fim[:] = -1
    elif case == "shared_atlas":
        more = _planes(12)
        fvm, uv, w, fim = (np.concatenate([a, b]) for a, b in zip((fvm, uv, w, fim), more))
        atlas, views = atlas[:1], 2 * BS
    return fvm, uv, w, fim, atlas, views


def _check_atlas_case(case, fvm, uv, w, fim):
    """The case reaches what it names: ties at lo and hi - eps, anchors
    on the last column and row."""
    if case not in ("ties", "atlas_edges"):
        return
    z, u, v, wt = (torch.tensor(a) for a in (fvm[:, 2::3], uv[:, 0::2], uv[:, 1::2], w))
    x, y = ts._uv_coords(z.unbind(1), u.unbind(1), v.unbind(1), wt.unbind(1),
                         torch.tensor(fim) >= 0, 1e-5)
    fg = torch.tensor(fim) >= 0
    if case == "ties":
        assert (fg & (x == u.min(1).values)).sum() > 10
        assert (fg & (y == v.max(1).values - 1e-5) & (y > v.min(1).values)).sum() > 10
    else:
        th, tw = ATLAS
        assert (fg & (torch.floor(x) == tw - 1)).sum() > 10
        assert (fg & (torch.floor(y) == th - 1)).sum() > 10


@pytest.mark.parametrize("case", ATLAS_CASES)
def test_atlas_sampler_values_and_gradients(case):
    """Gradients with respect to the atlas (K14's adds, K6's plain version
    on the CPU), the texel coordinates, z and the weights; the atlas is
    small, so taps cross its rows."""
    fvm, uv, w, fim, atlas, views = _atlas_case(case)
    _check_atlas_case(case, fvm, uv, w, fim)

    def run(lib, fvm, uv, tex, fim, w):
        if views is not None:
            tex = (jnp.broadcast_to(tex, (views, *tex.shape[1:])) if lib is js
                   else tex.expand(views, -1, -1, -1))
        return lib.sample_textures_atlas_planes(fvm, uv, tex, fim, w, 1e-5)

    out = _both(lambda *a: run(js, *a), lambda *a: run(ts, *a), [fvm, uv, atlas, fim, w], 4)
    if case == "background":
        assert (out == 0).all()


@pytest.mark.parametrize("case", ATLAS_CASES)
def test_atlas_sampler_vjp_matches_autograd_of_its_expression(case):
    """The sampler's hand-written VJP (``resolve_cuda.atlas_sample_vjp_plain``,
    K14's plain version) against autograd through the expression it
    replaced: ``_uv_coords``, ``_bilinear_taps``, the taps gathered by
    ``_AtlasTaps`` at the clamped anchors and summed from 0.  The same
    values, bit for bit; every gradient to rtol 1e-5."""
    fvm, uv, w, fim, atlas, views = _atlas_case(case)
    th, tw = ATLAS
    bs = fim.shape[0]
    z = torch.tensor(fvm[:, 2::3].copy(), requires_grad=True)
    uvt, wt = (torch.tensor(a, requires_grad=True) for a in (uv, w))
    tex = torch.tensor(atlas, requires_grad=True)
    index = torch.tensor(fim)

    def expression(z, uv, tex, w):
        fg = index >= 0
        x, y = ts._uv_coords(z.unbind(1), uv[:, 0::2].unbind(1), uv[:, 1::2].unbind(1),
                             w.unbind(1), fg, 1e-5)
        x0, y0, tap_w = ts._bilinear_taps(x, y)
        idx00 = torch.where(fg, y0 * tw + x0, -1).reshape(bs, H * W)
        taps = ts._AtlasTaps.apply(tex.reshape(bs, 3, th * tw), idx00, tw)
        taps = taps.reshape(bs, 4, 3, H, W)
        images = sum(t[:, None] * taps[:, i] for i, t in enumerate(tap_w))
        return torch.where(fg[:, None], images, 0.0)

    views_of = (lambda t: t) if views is None else (lambda t: t.expand(views, -1, -1, -1))
    ct = torch.tensor(np.random.RandomState(8).randn(bs, 3, H, W).astype(np.float32))
    want = expression(z, uvt, views_of(tex), wt)
    want_grads = torch.autograd.grad(want, (z, uvt, tex, wt), ct)
    got = ts._sample_atlas(z, uvt, views_of(tex), index, wt, 1e-5)
    got_grads = torch.autograd.grad(got, (z, uvt, tex, wt), ct)
    assert torch.equal(got, want)
    for g, w_ in zip(got_grads, want_grads):
        _close(g.numpy(), w_.numpy())


@pytest.mark.parametrize("texture_size", [2, 4])
def test_texel_sampler_values_and_gradients(texture_size):
    fvm, _, w, fim = _planes(5)
    nf = 30
    vt, ft, tex = create_textures(nf, texture_size, device="cpu")
    tile_width = tex.shape[2] // texture_size
    # each pixel's winner's own texel triangle (u0, v0, u1, v1, u2, v2)
    tri = vt.numpy()[ft.numpy().reshape(-1)].reshape(nf, 6)
    uv = np.ascontiguousarray(tri[np.maximum(fim, 0)].transpose(0, 3, 1, 2))
    texels = np.random.RandomState(6).rand(BS, texture_size ** 2 * 3, H, W).astype(np.float32)
    _both(
        lambda fvm, uv, tx, fim, w: js.sample_textures_texel_planes(
            fvm, uv, tx, fim, w, 1e-5, texture_size, tile_width),
        lambda fvm, uv, tx, fim, w: ts.sample_textures_texel_planes(
            fvm, uv, tx, fim, w, 1e-5, texture_size, tile_width),
        [fvm, uv, texels, fim, w], 7,
    )


def test_mask_foreground_and_cross():
    _, _, _, fim = _planes(19)
    data = np.random.RandomState(20).randn(BS, H, W, 3).astype(np.float32)
    _both(jm.mask_foreground, tm.mask_foreground, [data, fim], 21)
    a, b = np.random.RandomState(22).randn(2, 5, 7, 3).astype(np.float32)
    _both(jm.cross, tm.cross, [a, b], 23)


def test_face_texel_attrs():
    tex = np.random.RandomState(8).rand(BS, 3, 12, 8).astype(np.float32)
    _both(lambda t: js.face_texel_attrs(t, 20, 2), lambda t: ts.face_texel_attrs(t, 20, 2),
          [tex], 9)


def test_face_vertex_normals_and_normal_planes():
    v, faces = icosphere(1)
    v = np.stack([v, 0.7 * v + 0.1]).astype(np.float32)
    faces_t = torch.tensor(faces)
    _both(
        lambda x: js.face_vertex_normals(x, jnp.asarray(faces), jnp.take(x, faces, axis=1)),
        lambda x: ts.face_vertex_normals(x, faces_t, tgr.gather_face_vertices(x, faces_t)),
        [v], 10,
    )
    nvp = np.random.RandomState(11).randn(BS, 9, H, W).astype(np.float32)
    _, _, w, _ = _planes(12)
    _both(js.normal_planes, ts.normal_planes, [nvp, w], 13)


def test_depth_plane():
    fvm, _, w, fim = _planes(14)
    fvm[:, :, fim[0] < 0] = 0.0     # background planes are 0, as latched
    w[:, :, fim[0] < 0] = 0.0
    _both(js.depth_plane, ts.depth_plane, [fvm, fim, w], 15)


def _light_inputs(seed):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(BS, 3, H, W).astype(np.float32)
    normals = rng.uniform(-1, 1, (BS, 3, H, W)).astype(np.float32)
    normals[:, 2, :3] = 0.0          # a zero base for the specular power
    colors = rng.rand(3, BS, 3).astype(np.float32)
    direction = rng.uniform(-1, 1, (BS, 3)).astype(np.float32)
    alpha = np.array([1.0, 2.5], np.float32)
    return rgb, normals, colors, direction, alpha


@pytest.mark.parametrize("backside", [False, True])
@pytest.mark.parametrize("kind", ["ambient", "directional", "specular", "specular_alpha", "all"])
def test_lights(kind, backside):
    """Each light type, gradients into the colours, the direction and the
    specular exponent; the exponent's gradient is 0, not NaN, where the
    base is 0."""
    rgb, normals, colors, direction, alpha = _light_inputs(16)

    def lights(lib, colors, direction, alpha):
        amb = lib.AmbientLight(color=colors[0])
        dire = lib.DirectionalLight(color=colors[1], direction=direction, backside=backside)
        spec = lib.SpecularLight(color=colors[2], backside=backside)
        spec_a = lib.SpecularLight(color=colors[2], alpha=alpha, backside=backside)
        return {"ambient": (amb,), "directional": (dire,), "specular": (spec,),
                "specular_alpha": (spec_a,), "all": (dire, amb, spec_a)}[kind]

    _both(
        lambda rgb, n, c, d, a: js.apply_lights_planar(rgb, n, lights(jl, c, d, a)),
        lambda rgb, n, c, d, a: ts.apply_lights_planar(rgb, n, lights(tl, c, d, a)),
        [rgb, normals, colors, direction, alpha], 17,
    )


def test_float64_light_fields_shade_in_float32():
    """Float64 light fields are read in float32, as the JAX package reads
    them (x64 off): the bits of their float32 copies, float32 planes, and
    the gradients back in float64."""
    rgb, normals, *_ = _light_inputs(19)
    rng = np.random.RandomState(20)
    fields = [rng.rand(BS, 3) for _ in range(3)] + [rng.uniform(-1, 1, (BS, 3)),
                                                    np.array([1.5, 3.0])]
    outs, grads = [], []
    for dtype in (torch.float64, torch.float32):
        c0, c1, c2, d, a = (torch.tensor(f).to(dtype).requires_grad_(True) for f in fields)
        lights = (tl.DirectionalLight(color=c1, direction=d), tl.AmbientLight(color=c0),
                  tl.SpecularLight(color=c2, alpha=a))
        out = ts.apply_lights_planar(torch.tensor(rgb), torch.tensor(normals), lights)
        out.sum().backward()
        outs.append(out)
        grads.append([t.grad for t in (c0, c1, c2, d, a)])
    assert outs[0].dtype == torch.float32 and torch.equal(outs[0], outs[1])
    for g64, g32 in zip(*grads):
        assert g64.dtype == torch.float64 and torch.equal(g64, g32.double())


def test_empty_lights_render_black():
    rgb, normals, *_ = _light_inputs(18)
    out = ts.apply_lights_planar(torch.tensor(rgb), torch.tensor(normals), ())
    assert torch.equal(out, torch.zeros_like(out))


# --- the lights' per-pixel pass: K15 and K16's plain versions --------------

# each light kind on either side, the three together, no light, and the
# three with float64 fields; every field takes gradients
SHADE_CASES = ["ambient", "directional", "directional-backside", "specular",
               "specular-backside", "specular_alpha", "specular_alpha-backside", "all",
               "all-backside", "empty", "float64"]


def _shade_inputs(seed):
    """RGB [bs, 3, H, W], the winner's vertex normals [bs, 9, H, W] and
    weights summing to 1, and the light fields (colours [3, bs, 3], a
    direction [bs, 3], exponents [bs]).  The normals' z is 0 on rows 0-1
    (the specular's base exactly 0), every normal is 0 on rows 2-3 (each
    kind's dot product exactly 0), and the last row is background (weights
    and normals 0, as the resolve latches them)."""
    rng = np.random.RandomState(seed)
    rgb = rng.rand(BS, 3, H, W).astype(np.float32)
    normals = rng.uniform(-1, 1, (BS, 9, H, W)).astype(np.float32)
    normals[:, 2::3, :2] = 0.0
    normals[:, :, 2:4] = 0.0
    normals[:, :, -1] = 0.0
    w = rng.uniform(0, 1, (BS, 3, H, W)).astype(np.float32)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    w[:, :, -1] = 0.0
    fields = [*rng.rand(3, BS, 3).astype(np.float32), rng.uniform(-1, 1, (BS, 3)).astype(np.float32),
              np.array([1.0, 2.5], np.float32)]
    return rgb, normals, w, fields


def _shade_lights(lib, case, c0, c1, c2, direction, alpha):
    """The lights of ``case`` from ``lib`` (the JAX package's lights module
    or the port's) over the fields."""
    kind, _, side = case.partition("-")
    backside = side == "backside"
    amb = lib.AmbientLight(color=c0)
    dire = lib.DirectionalLight(color=c1, direction=direction, backside=backside)
    spec = lib.SpecularLight(color=c2, backside=backside)
    spec_a = lib.SpecularLight(color=c2, alpha=alpha, backside=backside)
    three = (dire, amb, spec_a)
    return {"ambient": (amb,), "directional": (dire,), "specular": (spec,),
            "specular_alpha": (spec_a,), "all": three, "float64": three, "empty": ()}[kind]


def _shade_leaves(rgb, normals, fields, case):
    """The port's leaves: RGB, normals and fields (float64 in that case),
    each taking gradients."""
    dtype = torch.float64 if case == "float64" else torch.float32
    return ([torch.tensor(x).requires_grad_(True) for x in (rgb, normals)]
            + [torch.tensor(f).to(dtype).requires_grad_(True) for f in fields])


@pytest.mark.parametrize("case", SHADE_CASES)
def test_shade_planes_values_and_gradients(case):
    """The lights' per-pixel pass (``shade_planes``: K15's plain version,
    K16's as its backward) against the JAX package's ``normal_planes`` and
    ``apply_lights_planar``, run eagerly: the images and the gradients of
    the RGB, the normal planes and every light field (the weights take
    none), the fields' in their own dtype."""
    rgb, normals, w, fields = _shade_inputs(30)

    def jax_fn(rgb, normals, *fields):
        lights = _shade_lights(jl, case, *fields)
        return js.apply_lights_planar(rgb, js.normal_planes(normals, jnp.asarray(w)), lights)

    with jax.disable_jit():
        out, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (rgb, normals, *fields)))
        ct = np.random.RandomState(31).randn(*out.shape).astype(np.float32)
        want_grads = vjp(jnp.asarray(ct))
    leaves = _shade_leaves(rgb, normals, fields, case)
    got = ts.shade_planes(leaves[0], leaves[1], torch.tensor(w),
                          _shade_lights(tl, case, *leaves[2:]))
    got.backward(torch.tensor(ct))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), out)
    for leaf, want in zip(leaves, want_grads):
        if leaf.grad is None:                 # a field no light of the case reads
            _close(np.zeros_like(want), want)
        else:
            assert leaf.grad.dtype == leaf.dtype
            _close(leaf.grad.numpy(), want)


@pytest.mark.parametrize("case", SHADE_CASES)
def test_shade_planes_vjp_matches_autograd_of_its_expression(case):
    """K16's plain version (``resolve_cuda.lights_shade_vjp_plain``, the VJP
    written by hand) against autograd through the expression that K15
    replaced (``normal_planes``, then ``apply_lights_planar``): the same
    images and RGB gradient (``g * cw``), bit for bit; the normal planes'
    and the fields' gradients to rtol 1e-5 of each one's largest magnitude,
    since autograd adds the normal map's gradient over the lights, a
    directional light's three channels and each field's terms over the
    pixels in orders of its own."""
    rgb, normals, w, fields = _shade_inputs(32)
    ct = torch.tensor(np.random.RandomState(33).randn(BS, 3, H, W).astype(np.float32))
    weights = torch.tensor(w)
    runs = []
    for fused in (False, True):
        leaves = _shade_leaves(rgb, normals, fields, case)
        lights = _shade_lights(tl, case, *leaves[2:])
        if fused:
            out = ts.shade_planes(leaves[0], leaves[1], weights, lights)
        else:
            out = ts.apply_lights_planar(leaves[0], ts.normal_planes(leaves[1], weights), lights)
        out.backward(ct)
        runs.append((out, [leaf.grad for leaf in leaves]))
    (want, want_grads), (got, got_grads) = runs
    assert torch.equal(got, want)
    assert torch.equal(got_grads[0], want_grads[0])
    for leaf, g, wg in zip(leaves[1:], got_grads[1:], want_grads[1:]):
        # None: nothing read the leaf (autograd's normals without a light
        # that reads them; K16 writes their zero gradient)
        g, wg = (torch.zeros_like(leaf) if t is None else t for t in (g, wg))
        assert g.dtype == wg.dtype == leaf.dtype
        _close(g.numpy(), wg.numpy())


# --- the NHWC functions (layouts over the planar ones) ----------------------

NF = 30


def _nhwc_inputs(seed):
    """Face vertices [bs, nf, 3, 3] (z > 0), face texel triangles [bs, nf,
    3, 2] inside a 40 x 64 atlas, the atlas, an index map with background
    and weights [bs, H, W, 3] summing to 1."""
    rng = np.random.RandomState(seed)
    faces = rng.uniform(-1, 1, (BS, NF, 3, 3)).astype(np.float32)
    faces[..., 2] = rng.uniform(0.5, 3.0, (BS, NF, 3))
    uv = np.empty((BS, NF, 3, 2), np.float32)
    uv[..., 0] = rng.uniform(0, 63, (BS, NF, 3))
    uv[..., 1] = rng.uniform(0, 39, (BS, NF, 3))
    atlas = rng.rand(BS, 3, 40, 64).astype(np.float32)
    fim = rng.randint(-1, NF, (BS, H, W)).astype(np.int32)
    w = rng.uniform(0, 1, (BS, H, W, 3)).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    return faces, uv, atlas, fim, w


def _shim(jax_fn, torch_fn, *inputs, exact=True):
    want = np.asarray(jax_fn(*(jnp.asarray(x) for x in inputs)))
    got = torch_fn(*(torch.tensor(x) for x in inputs)).numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    return got


def test_nhwc_depth_and_coordinate_maps():
    faces, _, _, fim, w = _nhwc_inputs(30)
    fv_map = np.take_along_axis(faces, np.maximum(fim, 0).reshape(BS, -1, 1, 1), 1)
    fv_map = np.where((fim >= 0).reshape(BS, -1, 1, 1), fv_map, 0).reshape(BS, H, W, 3, 3)
    d = _shim(js.compute_depth_map_from, ts.compute_depth_map_from,
              fv_map[..., 2], fim, w)
    assert (d[fim < 0] == 0).all() and (d[fim >= 0] > 0).all()
    _shim(js.compute_depth_map, ts.compute_depth_map, faces, fim, w)
    _shim(js.compute_coordinate_map_from, ts.compute_coordinate_map_from, fv_map, w)
    _shim(js.compute_coordinate_map, ts.compute_coordinate_map, faces, fim, w)


def test_nhwc_texture_sampling_and_backgrounds():
    faces, uv, atlas, fim, w = _nhwc_inputs(31)
    _shim(lambda f, t, a, i, w: js.sample_textures(f, t, a, i, w, 1e-5),
          lambda f, t, a, i, w: ts.sample_textures(f, t, a, i, w, 1e-5),
          faces, uv, atlas, fim, w)
    z_map = np.random.RandomState(32).uniform(0.5, 3.0, (BS, H, W, 3)).astype(np.float32)
    uv_map = np.take_along_axis(uv, np.maximum(fim, 0).reshape(BS, -1, 1, 1), 1)
    _shim(lambda z, t, a, i, w: js.sample_textures_from(z, t, a, i, w, 1e-5),
          lambda z, t, a, i, w: ts.sample_textures_from(z, t, a, i, w, 1e-5),
          z_map, uv_map.reshape(BS, H, W, 3, 2), atlas, fim, w)
    rgb, bg = np.random.RandomState(33).rand(2, BS, H, W, 3).astype(np.float32)
    _shim(js.blend_backgrounds, ts.blend_backgrounds, fim, rgb, bg)


@pytest.mark.parametrize("smooth", [True, False])
def test_nhwc_normals(smooth):
    v, faces = icosphere(1)
    v = np.stack([v, 0.7 * v + 0.1]).astype(np.float32)
    fv = v[:, faces]                                   # [bs, nf, 3, 3]
    fim = np.random.RandomState(34).randint(-1, len(faces), (BS, H, W)).astype(np.int32)
    _, _, _, _, w = _nhwc_inputs(35)
    nvm = np.random.RandomState(36).randn(BS, H, W, 3, 3).astype(np.float32)
    # XLA sums the three weighted normals in another order than the planar
    # function's (n0 + n1) + n2: within 1e-6, not equal
    _shim(lambda n, w: js.normal_map_from_gathered(n, w, smooth),
          lambda n, w: ts.normal_map_from_gathered(n, w, smooth), nvm, w, exact=False)
    _shim(lambda v, i, f, m, w: js.compute_normal_map(v, i, f, m, w, smooth),
          lambda v, i, f, m, w: ts.compute_normal_map(v, i, f, m, w, smooth),
          v, faces, fv, fim, w, exact=False)


def test_nhwc_apply_lights():
    """Within 1e-6: XLA sums the directional light's dot product in another
    order."""
    rgb, normals, colors, direction, alpha = _light_inputs(37)
    rgb, normals = rgb.transpose(0, 2, 3, 1), normals.transpose(0, 2, 3, 1)

    def lights(lib, colors, direction, alpha):
        return (lib.DirectionalLight(color=colors[1], direction=direction, backside=True),
                lib.AmbientLight(color=colors[0]),
                lib.SpecularLight(color=colors[2], alpha=alpha))

    _shim(lambda r, n, c, d, a: js.apply_lights(r, n, lights(jl, c, d, a)),
          lambda r, n, c, d, a: ts.apply_lights(r, n, lights(tl, c, d, a)),
          rgb, normals, colors, direction, alpha, exact=False)
