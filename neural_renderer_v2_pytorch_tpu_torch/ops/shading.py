"""Channel-planar shading maps: coordinates, depth, texture sampling,
normals and lights (counterpart of the planar functions of
``neural_renderer_v2_pytorch_tpu/ops/shading.py``), and at the end the JAX
package's NHWC functions (``compute_depth_map``, ``sample_textures``,
``apply_lights``, ...), the reference-shaped API, as layouts over the
planar ones.

Plain PyTorch, as the JAX package leaves this layer to XLA, except two
passes of a render.  The loaded-atlas sampler is kernel K13
(:func:`resolve_cuda.atlas_sample`) with kernel K14
(:func:`resolve_cuda.atlas_sample_vjp`) as its backward: K14 recomputes the
texel coordinates and taps, writes the gradients of the depths and texel
coordinates, and adds each tap's gradient at its texel of the atlas's as K6
(:func:`resolve_cuda.atlas_taps_grad`) does, inside the span ``atlas.vjp``
with the atlas gradient's zero fill.  The lights' per-pixel pass
(:func:`shade_planes`: the per-pixel normals, the colour weight and the
product with the RGB) is kernel K15 (:func:`resolve_cuda.lights_shade`)
with kernel K16 (:func:`resolve_cuda.lights_shade_vjp`) as its backward,
which recomputes it and writes the gradients of the RGB, the normal planes
and, where a light's field takes one, the light table
(:func:`light_table`).  Every expression is
the JAX package's, in the same order and association, so on the CPU the two
agree to the last bit where each op is correctly rounded (division by
tensors only, sums of three written out).
"""

from __future__ import annotations

import torch

from ..models import lights as light_lib
from ..utils import trace
from .maps import cross, mask_foreground, to_map
from .resolve import coordinate_planes
from .resolve_cuda import (
    LIGHT_FIELDS,
    atlas_sample,
    atlas_sample_vjp,
    atlas_taps_grad,
    lights_shade,
    lights_shade_vjp,
    vertex_slots,
)


def _depth(z, w):
    """Perspective-correct depth ``1 / sum(w / z)`` from triples of planes."""
    return 1.0 / (w[0] / z[0] + w[1] / z[1] + w[2] / z[2])


def depth_plane(fvm_planar, face_index_map, weight_planes):
    """Perspective-correct depth [bs, 1, H, W], 0 on background."""
    d = _depth((fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]),
               (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]))
    return torch.where((face_index_map >= 0)[:, None], d[:, None], 0.0)


def _uv_coords(z, u, v, w, fg, eps):
    """Perspective-correct texel coordinates (x, y) [bs, H, W], clamped into
    the winning face's uv-bbox minus ``eps``, 0 on background.  ``z``,
    ``u``, ``v`` and ``w`` are triples of [bs, H, W] planes (one per face
    vertex); ``fg`` is the foreground mask."""
    depth = 1.0 / (
        w[0] / (z[0] + 1e-10) + 1e-10
        + w[1] / (z[1] + 1e-10) + 1e-10
        + w[2] / (z[2] + 1e-10) + 1e-10
    )

    def interp(c):
        val = (
            w[0] * c[0] / (z[0] + 1e-10)
            + w[1] * c[1] / (z[1] + 1e-10)
            + w[2] * c[2] / (z[2] + 1e-10)
        ) * depth
        lo = torch.minimum(torch.minimum(c[0], c[1]), c[2])
        hi = torch.maximum(torch.maximum(c[0], c[1]), c[2]) - eps
        # jnp.clip's order, and torch's even split of the gradient at ties
        return torch.where(fg, torch.minimum(hi, torch.maximum(lo, val)), 0.0)

    return interp(u), interp(v)


def _bilinear_taps(x, y):
    """Floor texel coordinates (int32) and the four bilinear weights, in the
    order floor/floor, floor-y/ceil-x, ceil-y/floor-x, ceil/ceil."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx0, wx1 = x0f + 1 - x, x - x0f
    wy0, wy1 = y0f + 1 - y, y - y0f
    return (x0f.to(torch.int32), y0f.to(torch.int32),
            (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1))


class _AtlasTaps(torch.autograd.Function):
    """The four bilinear taps [bs, 4, 3, P] of a flattened atlas [bs, 3, T]
    at anchor texels ``idx00`` [bs, P] (the others are +1, +tw, +tw+1): the
    counterpart of the JAX package's ``_atlas_taps``, with K6 as its
    backward.  No render runs it: the sampler's backward (K14, in
    :class:`_AtlasSample`) adds the taps' gradients as K6 does.
    The anchor is clamped to [0, T - tw - 2] as a unit, so all four taps
    stay in the atlas (texel coordinates must lie in [0, tw-1] x [0, th-1]).

    The backward adds each tap's three gradient channels at its own texel,
    straight into the planar [bs, 3, T] gradient (kernel K6; its plain
    version scatters the 12 channels at the anchor and folds them with
    three shifted adds, in the JAX package's order).  A negative ``idx00``
    marks a pixel whose gradient is 0 (background): it reads the anchor 0
    and scatters nothing.  (The JAX package adds its zeros at texel 0; with
    atomics, hundreds of thousands of them there serialise on one
    address.)"""

    @staticmethod
    def forward(ctx, flat, idx00, tw):
        T = flat.shape[-1]
        anchors = torch.clamp(idx00, 0, T - tw - 2)
        ctx.save_for_backward(torch.where(idx00 < 0, -1, anchors))
        ctx.tw = tw
        ctx.num_texels = T
        a = anchors.long()[:, None].expand(-1, 3, -1)
        return torch.stack(
            [torch.gather(flat, 2, a + off) for off in (0, 1, tw, tw + 1)], dim=1
        )

    @staticmethod
    def backward(ctx, grad):
        (anchors,) = ctx.saved_tensors            # -1: scatter nothing
        bs, P = anchors.shape
        # contiguous [bs, 3, T]: the atlas's own layout, so autograd keeps it
        with trace.span("atlas.vjp", grad):
            out = atlas_taps_grad(grad.reshape(bs, 12, P).contiguous(),
                                  anchors.to(torch.int32).contiguous(), ctx.tw, ctx.num_texels)
        return out, None, None


class _AtlasSample(torch.autograd.Function):
    """Bilinear sampling from a loaded atlas (``resolve_cuda.atlas_sample``,
    kernel K13): RGB [bs, 3, H, W] from the winner's vertex depths
    ``z_planes`` [bs, 3, H, W], texel-coordinate triangle ``uv_planes``
    [bs, 6, H, W], the atlas ``textures`` [bs, 3, th, tw], the index map and
    the weights [bs, 3, H, W].  The forward saves its inputs and no plane
    of its own.

    The backward is kernel K14 (``resolve_cuda.atlas_sample_vjp``), which
    recomputes the forward and writes the gradients of the depths, the
    texel coordinates and the weights, each asked for, as one tensor each,
    and adds each tap's gradient at its texel of the atlas's, as K6 does
    (span ``atlas.vjp``: the kernel and the atlas gradient's zero fill)."""

    @staticmethod
    def forward(ctx, z_planes, uv_planes, textures, face_index_map, weight_planes, eps):
        ctx.save_for_backward(z_planes, uv_planes, textures, face_index_map, weight_planes)
        ctx.eps = eps
        return atlas_sample(z_planes, uv_planes, textures, face_index_map, weight_planes, eps)

    @staticmethod
    def backward(ctx, grad):
        z_planes, uv_planes, textures, face_index_map, weight_planes = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with trace.span("atlas.vjp", grad):
            gz, guv, gtex, gw = atlas_sample_vjp(
                grad, z_planes, uv_planes, textures, face_index_map, weight_planes, ctx.eps,
                (needs[0], needs[1], needs[2], needs[4]))
        return gz, guv, gtex, None, gw, None


def sample_textures_atlas_planes(fvm_planar, uv_planes, textures, face_index_map,
                                 weight_planes, eps):
    """Bilinear sampling from a general (loaded) atlas: RGB [bs, 3, H, W].

    ``fvm_planar`` [bs, 9, H, W] latched winner coordinates (z on planes 2,
    5, 8); ``uv_planes`` [bs, 6, H, W] its texel-coordinate triangle
    u0,v0,u1,v1,u2,v2; ``textures`` [bs, 3, th, tw], differentiable;
    ``weight_planes`` [bs, 3, H, W]."""
    return _sample_atlas(fvm_planar[:, 2::3], uv_planes, textures, face_index_map,
                         weight_planes, eps)


def _uv_triangle(uv_planes):
    """The winner's texel coordinates from ``uv_planes`` [bs, 6, H, W]
    (u0,v0,u1,v1,u2,v2): (u, v), each three [bs, H, W] planes."""
    return ((uv_planes[:, 0], uv_planes[:, 2], uv_planes[:, 4]),
            (uv_planes[:, 1], uv_planes[:, 3], uv_planes[:, 5]))


def _sample_atlas(z_planes, uv_planes, textures, face_index_map, weight_planes, eps):
    """:func:`sample_textures_atlas_planes` from the winner's vertex depths
    ``z_planes`` [bs, 3, H, W] (:class:`_AtlasSample`: K13, and K14 as its
    backward).  Span ``sample``; its backward, K14's ``atlas.vjp`` inside,
    span ``sample.vjp``."""
    with trace.span("sample", textures):
        # the inputs as views made inside the span: its backward span closes
        # once the sampler's gradients of them are made
        z, uv, tex = (t.view_as(t) for t in (z_planes, uv_planes, textures))
        rgb = _AtlasSample.apply(z, uv, tex, face_index_map, weight_planes, eps)
    trace.vjp("sample.vjp", rgb, [z, uv, tex])
    return rgb


def face_texel_attrs(textures, num_faces, texture_size):
    """Per-face texel patches [bs, nf, ts*ts*3] of a ``create_textures``
    atlas [bs, 3, th*ts, tw*ts] (face f owns the patch at grid cell
    (f // tw, f % tw)); texel t = y_local * ts + x_local, channel-minor."""
    bs = textures.shape[0]
    ts = texture_size
    th = textures.shape[2] // ts
    tw = textures.shape[3] // ts
    t = textures.reshape(bs, 3, th, ts, tw, ts).permute(0, 2, 4, 3, 5, 1)
    return t.reshape(bs, th * tw, ts * ts * 3)[:, :num_faces]


def sample_textures_texel_planes(fvm_planar, uv_planes, texel_planes, face_index_map,
                                 weight_planes, eps, texture_size, tile_width):
    """Bilinear sampling from the winner's latched texel patch
    ``texel_planes`` [bs, ts*ts*3, H, W] (``create_textures`` atlases):
    RGB [bs, 3, H, W].  Other arguments as
    :func:`sample_textures_atlas_planes`.  Spans ``sample`` and
    ``sample.vjp``, as the atlas sampler's."""
    ts = texture_size
    with trace.span("sample", texel_planes):
        fg = face_index_map >= 0
        # as the atlas sampler's
        z = (fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8])
        u, v = _uv_triangle(uv_planes)
        x_f, y_f = _uv_coords(
            z, u, v,
            (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]),
            fg, eps,
        )
        # patch-local texel coordinates of the winning face
        fid = torch.clamp(face_index_map, min=0)
        x_f = x_f - ((fid % tile_width) * ts).to(torch.float32)
        y_f = y_f - ((fid // tile_width) * ts).to(torch.float32)
        x0, y0, tap_w = _bilinear_taps(x_f, y_f)

        bs = texel_planes.shape[0]
        texels = texel_planes.reshape(bs, ts * ts, 3, *texel_planes.shape[2:])
        if ts == 2:
            # the clamp pins local coordinates to [0, 1 - eps]: floor 0, ceil
            # 1, so the taps are the four patch texels
            taps = tuple(texels[:, t] for t in range(4))
        else:
            # ceil may weigh 0 at the bbox edge; the clip keeps it in the patch
            xi_f = torch.clamp(x0, 0, ts - 1)
            yi_f = torch.clamp(y0, 0, ts - 1)
            xi_c = torch.clamp(xi_f + 1, 0, ts - 1)
            yi_c = torch.clamp(yi_f + 1, 0, ts - 1)
            texel_ids = torch.arange(ts * ts, device=texels.device)[None, :, None, None]

            def tap(xi, yi):
                sel = (yi * ts + xi)[:, None] == texel_ids             # [bs, ts*ts, H, W]
                return torch.sum(sel[:, :, None] * texels, dim=1)

            taps = (tap(xi_f, yi_f), tap(xi_c, yi_f), tap(xi_f, yi_c), tap(xi_c, yi_c))
        images = sum(w[:, None] * t for w, t in zip(tap_w, taps))
        rgb = torch.where(fg[:, None], images, 0.0)
    trace.vjp("sample.vjp", rgb, [*z, *u, *v, texels])
    return rgb


def face_vertex_normals(vertices, faces, face_vertices):
    """Smoothed per-face per-vertex normals [bs, nf, 3 (vertex), 3 (xyz)]
    from the planar face vertices [bs, 3, 3, nf]: face normals by cross
    products, summed per vertex, normalised, gathered per face.

    The per-vertex sum is a segment sum over the face-major slots grouped
    by vertex in ascending order (K4's vertex -> slot table, kept per faces
    tensor, so a step sorts and counts nothing and makes no host sync), so
    it adds in the JAX package's segment-sum order and, unlike an atomic
    ``index_add_`` on CUDA, gives the same bits on every run."""
    bs, nv = vertices.shape[:2]
    v01 = face_vertices[:, :, 1] - face_vertices[:, :, 0]          # [bs, 3, nf]
    v12 = face_vertices[:, :, 2] - face_vertices[:, :, 1]
    n = cross(v01, v12, dim=1).permute(0, 2, 1)                    # [bs, nf, 3]
    offsets, slots = vertex_slots(faces, nv)
    counts = (offsets[1:] - offsets[:-1]).expand(bs, nv)
    # unsafe: no check of the lengths against the data, which reads them
    # back to the host; the table's lengths sum to 3 nf by construction
    vn = torch.segment_reduce(n.repeat_interleave(3, dim=1).index_select(1, slots), "sum",
                              lengths=counts, axis=1, unsafe=True)
    ids = faces.long()
    norm = torch.sqrt(torch.sum(vn * vn, dim=2, keepdim=True))
    vn = vn / torch.clamp(norm, min=1e-12)
    return vn[:, ids]


def normal_planes(normal_vertex_planes, weight_planes):
    """Smoothed per-pixel normals [bs, 3, H, W] from the latched per-vertex
    normals [bs, 9, H, W] (plane 3 * vertex + xyz)."""
    n = normal_vertex_planes.reshape(
        normal_vertex_planes.shape[0], 3, 3, *normal_vertex_planes.shape[2:]
    )
    t = weight_planes[:, :, None] * n
    return t[:, 0] + t[:, 1] + t[:, 2]


def _abs(x):
    """``|x|`` whose gradient at 0 is +1, as ``jnp.abs``'s (torch.abs's is 0)."""
    return torch.where(x >= 0, x, -x)


def light_table(lights, like):
    """The fields of ``lights`` as the lights' kernels read them: (a float32
    table [bs, L, 7] on ``like``'s device, a light's row its colour,
    direction and exponent, each broadcast over the batch of ``like`` [bs,
    ...] (0 where the kind has none, an exponent 1 where a specular light's
    ``alpha`` is None); the lights' (kind, backside) pairs, kind "ambient",
    "directional" or "specular").  The fields in float32, as the JAX
    package reads them (x64 off): a float64 field would make float64
    images, which the NMR kernels refuse.  Made on the card, from the
    fields alone, so a captured step copies nothing from the host; the
    table's gradient reaches each field, in the field's dtype."""
    bs = like.shape[0]
    zero = like.new_zeros((), dtype=torch.float32).expand(bs, 4)
    pieces, kinds = [], []
    for light in lights:
        if not isinstance(light, (light_lib.AmbientLight, light_lib.DirectionalLight,
                                  light_lib.SpecularLight)):
            raise TypeError(f"unknown light type: {light!r}")
        pieces.append(light.color.to(torch.float32).expand(bs, 3))
        if isinstance(light, light_lib.AmbientLight):
            pieces.append(zero)
            kinds.append(("ambient", False))
        elif isinstance(light, light_lib.DirectionalLight):
            pieces += [light.direction.to(torch.float32).expand(bs, 3), zero[:, :1]]
            kinds.append(("directional", bool(light.backside)))
        else:
            alpha = (like.new_ones((), dtype=torch.float32) if light.alpha is None
                     else light.alpha.to(torch.float32))
            pieces += [zero[:, :3], alpha.expand(bs)[:, None]]
            kinds.append(("specular", bool(light.backside)))
    if not pieces:
        return like.new_zeros((bs, 0, LIGHT_FIELDS), dtype=torch.float32), ()
    return torch.cat(pieces, 1).view(bs, len(kinds), LIGHT_FIELDS), tuple(kinds)


def light_intensity(normal_map_planes, row, kind, backside):
    """A directional or specular light's intensity at the normals [bs, 3,
    H, W], from its row [bs, 7] of :func:`light_table`: (pre, the
    directional's ``-direction . normal`` or the specular's ``(0, 0, 1) .
    -normal``; base, ``relu(pre)`` or with ``backside`` ``_abs(pre)``;
    value, the directional's base or the specular's ``base ** alpha``),
    each [bs, H, W]."""
    if kind == "directional":
        t = -row[:, 3:6, None, None] * normal_map_planes
        pre = t[:, 0] + t[:, 1] + t[:, 2]
    else:
        pre = -normal_map_planes[:, 2]
    base = _abs(pre) if backside else torch.relu(pre)
    value = base if kind == "directional" else base ** row[:, 6, None, None]
    return pre, base, value


def color_weight_planes(normal_map_planes, table, kinds):
    """The colour weight [bs, 3, H, W] that the lights of :func:`light_table`
    (``table`` [bs, L, 7] and ``kinds``) give the normals [bs, 3, H, W]
    (reference rasterize.py:252-283), summed from 0 in their order."""
    color_weight = torch.zeros_like(normal_map_planes)
    for l, (kind, backside) in enumerate(kinds):
        color = table[:, l, 0:3, None, None]
        if kind == "ambient":
            color_weight = color_weight + color
        else:
            intensity = light_intensity(normal_map_planes, table[:, l], kind, backside)[2]
            color_weight = color_weight + intensity[:, None] * color
    return color_weight


def apply_lights_planar(rgb_planes, normal_map_planes, lights):
    """RGB [bs, 3, H, W] times the colour weight that ``lights`` give the
    normals [bs, 3, H, W] (reference rasterize.py:252-283).  An empty
    ``lights`` gives black."""
    return rgb_planes * color_weight_planes(normal_map_planes,
                                            *light_table(lights, normal_map_planes))


class _LightsShade(torch.autograd.Function):
    """:func:`apply_lights_planar` at the :func:`normal_planes` of the
    winner's vertex normals [bs, 9, H, W] and the weights [bs, 3, H, W],
    over the lights' ``table`` and ``kinds`` (:func:`light_table`): kernel
    K15 (``resolve_cuda.lights_shade``).  The forward saves its inputs and
    no plane of its own.  The weights take no gradient (they come from
    ``rasterize._CoordinatePlanes``, which marks them so).

    The backward is kernel K16 (``resolve_cuda.lights_shade_vjp``), which
    recomputes the forward and writes the gradients of the RGB, the normal
    planes and the table, each asked for."""

    @staticmethod
    def forward(ctx, rgb, normals, weights, table, kinds):
        ctx.save_for_backward(rgb, normals, weights, table)
        ctx.kinds = kinds
        return lights_shade(rgb, normals, weights, table, kinds)

    @staticmethod
    def backward(ctx, grad):
        rgb, normals, weights, table = ctx.saved_tensors
        needs = ctx.needs_input_grad
        g_rgb, g_normals, g_table = lights_shade_vjp(grad, rgb, normals, weights, table,
                                                     ctx.kinds, (needs[0], needs[1], needs[3]))
        return g_rgb, g_normals, None, g_table, None


def shade_planes(rgb_planes, normal_vertex_planes, weight_planes, lights):
    """``apply_lights_planar(rgb_planes, normal_planes(normal_vertex_planes,
    weight_planes), lights)``: RGB [bs, 3, H, W] shaded at the normals of
    the winner's vertex normals [bs, 9, H, W] (a slice of the attribute
    planes, read in place on the card) and the weights [bs, 3, H, W], which
    take no gradient.  :class:`_LightsShade`: K15, and K16 as its
    backward; the light table is made here."""
    table, kinds = light_table(lights, rgb_planes)
    return _LightsShade.apply(rgb_planes, normal_vertex_planes, weight_planes, table, kinds)


def blend_background_planes(foreground, rgb_planes, backgrounds):
    """The RGB planes [bs, 3, H, W] over ``backgrounds`` [bs, 3, H, W] where
    ``foreground`` [bs, 1, H, W] is 0.  The backgrounds are flipped in H and
    W here because the merged image is flipped at the end of the pipeline
    (chainer rasterize.py:574-577)."""
    return foreground * rgb_planes + (1.0 - foreground) * backgrounds.flip(2, 3)


# ---------------------------------------------------------------------------
# The NHWC functions of the JAX package (reference rasterize.py:80-190,
# 252-283), each a layout over the planar function above: maps [bs, H, W,
# ...], weights [bs, H, W, 3], face vertices [bs, nf, 3 (vertex), 3].


def _planar(t):
    """[bs, H, W, C] -> [bs, C, H, W]."""
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    """[bs, C, H, W] -> [bs, H, W, C]."""
    return t.permute(0, 2, 3, 1)


def compute_depth_map_from(faces_z_map, face_index_map, weight_map):
    """Perspective-correct depth [bs, H, W] from the winner's vertex depths
    [bs, H, W, 3]; 0 on background."""
    d = _depth(faces_z_map.unbind(-1), weight_map.unbind(-1))
    return mask_foreground(d, face_index_map)


def compute_depth_map(faces, face_index_map, weight_map):
    """:func:`compute_depth_map_from` with the depths gathered from the face
    vertices [bs, nf, 3, 3] (reference rasterize.py:80-88)."""
    faces_z_map = to_map(faces[:, :, :, -1:], face_index_map)[:, :, :, :, 0]
    return compute_depth_map_from(faces_z_map, face_index_map, weight_map)


def compute_coordinate_map_from(face_vertex_map, weight_map):
    """Barycentric screen XY [bs, H, W, 2] from the winner's vertices
    [bs, H, W, 3, 3]: the map through which the NMR backward reaches the
    vertices (:func:`coordinate_planes`)."""
    bs, H, W = face_vertex_map.shape[:3]
    fvm_planar = face_vertex_map.reshape(bs, H, W, 9).permute(0, 3, 1, 2)
    return _nhwc(coordinate_planes(fvm_planar, _planar(weight_map)))


def compute_coordinate_map(faces, face_index_map, weight_map):
    """:func:`compute_coordinate_map_from` with the winners gathered from
    the face vertices [bs, nf, 3, 3] (reference rasterize.py:91-97)."""
    return compute_coordinate_map_from(to_map(faces, face_index_map), weight_map)


def sample_textures_from(faces_z_map, vertices_textures_map, textures, face_index_map,
                         weight_map, eps):
    """Bilinear atlas sampling, RGB [bs, H, W, 3]
    (:func:`sample_textures_atlas_planes`): the winner's vertex depths
    [bs, H, W, 3] and texel-coordinate triangle [bs, H, W, 3, 2], the atlas
    [bs, 3, th, tw], the weights [bs, H, W, 3].  Differentiable with respect
    to the atlas, the depths and the texel coordinates, as the reference's
    torch path (rasterize.py:100-153)."""
    bs, H, W = face_index_map.shape
    uv_planes = vertices_textures_map.reshape(bs, H, W, 6).permute(0, 3, 1, 2)
    return _nhwc(_sample_atlas(_planar(faces_z_map), uv_planes, textures, face_index_map,
                               _planar(weight_map), eps))


def sample_textures(faces, faces_textures, textures, face_index_map, weight_map, eps):
    """:func:`sample_textures_from` with the winners' depths and texel
    triangles gathered from the face vertices [bs, nf, 3, 3] and the face
    texel coordinates [bs, nf, 3, 2] (reference rasterize.py:100-153)."""
    faces_z_map = to_map(faces[:, :, :, 2], face_index_map)
    vertices_textures_map = to_map(faces_textures, face_index_map)
    return sample_textures_from(faces_z_map, vertices_textures_map, textures, face_index_map,
                                weight_map, eps)


def blend_backgrounds(face_index_map, rgb_map, backgrounds):
    """:func:`blend_background_planes` of RGB [bs, H, W, 3] over
    ``backgrounds`` [bs, H, W, 3] (pre-flipped in H and W)."""
    foreground = (face_index_map >= 0).to(torch.float32)[:, None]
    return _nhwc(blend_background_planes(foreground, _planar(rgb_map), _planar(backgrounds)))


def normal_map_from_gathered(normal_vertex_map, weight_map, smooth=True):
    """Per-pixel normals [bs, H, W, 3] from the winner's vertex normals
    [bs, H, W, 3, 3]: weighted (:func:`normal_planes`), or with ``smooth``
    off their mean."""
    if not smooth:
        return torch.mean(normal_vertex_map, dim=-2)
    bs, H, W = normal_vertex_map.shape[:3]
    nvp = normal_vertex_map.reshape(bs, H, W, 9).permute(0, 3, 1, 2)
    return _nhwc(normal_planes(nvp, _planar(weight_map)))


def compute_normal_map(vertices, face_indices, faces, face_index_map, weight_map,
                       smooth=True):
    """Per-pixel normals [bs, H, W, 3] of ``vertices`` [bs, nv, 3] with faces
    ``face_indices`` [nf, 3] and face vertices ``faces`` [bs, nf, 3, 3]
    (:func:`face_vertex_normals`; reference rasterize.py:162-190)."""
    normals = face_vertex_normals(vertices, face_indices, faces.permute(0, 3, 2, 1))
    return normal_map_from_gathered(to_map(normals, face_index_map), weight_map, smooth)


def apply_lights(rgb_map, normal_map, lights):
    """RGB [bs, H, W, 3] times the colour weight that ``lights`` give the
    normals [bs, H, W, 3] (:func:`apply_lights_planar`)."""
    return _nhwc(apply_lights_planar(_planar(rgb_map), _planar(normal_map), lights))
