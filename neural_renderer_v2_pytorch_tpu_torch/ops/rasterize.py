"""Rasterization pipeline (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/rasterize.py``).

  1. supersample 2x when anti-aliasing
  2. planar face vertices = vertices[:, faces]      (K5; K4 backward)
  3. z-buffer resolve with winner latch             (K2 for silhouettes, K2L
                                                     for RGB/depth; K3
                                                     backward; or K7 + K8)
     or, faces sharded across ranks, the id/depth
     resolve, the ordered fold, the winner gather    (K9; K3 backward)
  4. stopped barycentric weights, coordinate map    (K10; K11 backward)
  5. silhouette / RGB (textures, lights) / depth    (the atlas sampler: K13;
                                                     K14 backward; the
                                                     lights: K15; K16
                                                     backward)
  6. background blend, NMR differentiation hook    (K12 backward)
  7. flip H and W, then the 2x2 anti-aliasing pool

All maps are channel-planar (NCHW).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..utils import trace
from . import graphs, shading
from .differentiation import differentiation
from .gather_resolve import gather_face_vertices, gather_winner_planes, resolve_and_gather
from .resolve_cuda import nmr_planes, nmr_planes_vjp

DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_DRAW_BACKSIDE = True
DEFAULT_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class RasterizeHyperparam:
    """Static rendering configuration (reference rasterize_param.py:13-33)."""

    image_size: int = DEFAULT_IMAGE_SIZE
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    eps: float = DEFAULT_EPS
    anti_aliasing: bool = DEFAULT_ANTI_ALIASING
    draw_backside: bool = DEFAULT_DRAW_BACKSIDE
    draw_rgb: bool = True
    draw_silhouettes: bool = True
    draw_depth: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RasterizeParam:
    """Tensor inputs of the rasterizer (reference rasterize_param.py:36-50).

    ``texture_size``: set it when ``textures`` is a ``create_textures``
    atlas of that texel size; sampling then reads each face's latched texel
    patch.  Leave it None for any other (loaded) atlas."""

    vertices_textures: Optional[torch.Tensor] = None    # [bs, nvt, 2] texel coords
    faces_textures: Optional[torch.Tensor] = None       # [nf, 3] int32
    textures: Optional[torch.Tensor] = None             # [bs, 3, th, tw]
    background_color: Optional[Any] = None
    texture_size: Optional[int] = None
    backgrounds: Optional[torch.Tensor] = None          # [bs, 3, H, W]
    lights: Optional[Tuple[Any, ...]] = None            # models.lights

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def face_attributes(vertices, faces, face_vertices, params):
    """The per-face attributes the RGB path latches, [bs, nf, A]: the
    texel-coordinate triangle u0,v0,u1,v1,u2,v2 (6), then with lights the
    smoothed vertex normals (9), then with ``texture_size`` the texel patch
    (ts*ts*3)."""
    bs, nf = vertices.shape[0], faces.shape[0]
    faces_textures = params.vertices_textures[:, params.faces_textures.long()]
    attrs = [faces_textures.reshape(bs, nf, 6)]
    if params.lights is not None:
        with trace.span("lights", face_vertices):
            normals = shading.face_vertex_normals(vertices, faces, face_vertices)
        trace.vjp("lights.vjp", normals, face_vertices)
        attrs.append(normals.reshape(bs, nf, 9))
    if params.texture_size is not None:
        attrs.append(shading.face_texel_attrs(params.textures, nf, params.texture_size))
    return torch.cat(attrs, -1)


def compute_channel_maps(vertices, faces, params, hp, render_size, row_start=0,
                         num_rows=None, face_group=None):
    """Resolve and build the maps at ``render_size`` over the image rows
    ``row_start .. row_start + num_rows`` (the whole image by default; rows
    past the image bottom resolve to whatever continues there, for the
    caller to crop).  Returns (images [bs, C, rows, S]: RGB, silhouette and
    depth as requested, before the background blend, the hook and the flip;
    coordinate_map [bs, 2, rows, S]; foreground [bs, 1, rows, S]).

    ``face_group``: a process group over which the faces are sharded
    (``parallel.faces``).  Each of its ranks resolves its range of the
    faces, the winners fold across the group in face order, and the
    winners' coordinates and attributes are then gathered from the whole
    face set in one kernel K9 launch (K3 backward); every rank of the
    group returns the same maps."""
    from ..parallel.collectives import run

    return run(channel_map_steps(vertices, faces, params, hp, render_size, row_start, num_rows,
                                 face_group))


def channel_map_steps(vertices, faces, params, hp, render_size, row_start=0, num_rows=None,
                      face_group=None):
    """:func:`compute_channel_maps` as a generator that yields the face
    fold's all-gathers (``parallel.faces.face_sharded_steps``; none without
    ``face_group``)."""
    face_vertices = gather_face_vertices(vertices, faces)       # [bs, 3, 3, nf]
    attrs = (face_attributes(vertices, faces, face_vertices, params)
             if hp.draw_rgb else None)
    if face_group is None:
        # silhouette-only renders never read the winner's z: latch XY only
        latch_z = hp.draw_rgb or hp.draw_depth
        face_index_map, fvm_planar, attr_planes = resolve_and_gather(
            face_vertices, render_size, hp.near, hp.far, hp.draw_backside, attrs, latch_z,
            row_start, num_rows,
        )
    else:
        from ..parallel.faces import face_sharded_steps

        # [bs, nf, 3 (vertex), 3 (coord)]: column 3 * vertex + coord below
        fv = face_vertices.permute(0, 3, 2, 1)
        face_index_map = yield from face_sharded_steps(
            fv.detach(), render_size, hp.near, hp.far, hp.draw_backside,
            row_start=row_start, num_rows=num_rows, group=face_group,
        )
        per_face = fv.reshape(fv.shape[0], fv.shape[1], 9)
        if attrs is not None:
            per_face = torch.cat([per_face, attrs], -1)
        planes = gather_winner_planes(per_face, face_index_map)
        fvm_planar, attr_planes = planes[:, :9], planes[:, 9:]
    with trace.span("planes", fvm_planar):
        images, coordinate_map, foreground = _maps(fvm_planar, attr_planes, face_index_map,
                                                   params, hp, render_size, row_start)
    trace.vjp("planes.vjp", [images, coordinate_map], fvm_planar)
    return images, coordinate_map, foreground


class _CoordinatePlanes(torch.autograd.Function):
    """The coordinate map [bs, 2, rows, S] (the screen XY through which the
    NMR backward reaches the vertices), the weight planes [bs, 3, rows, S]
    when ``weights`` (else None) and the foreground [bs, 1, rows, S] of the
    resolve's winner planes ``fvm_planar`` [bs, 9, rows, S] over the image
    rows ``row_start ..``: kernel K10 (``resolve_cuda.nmr_planes``).  The
    weights and the foreground take no gradient (the reference computes
    the weights in a grad-less kernel).

    The backward is kernel K11 (``resolve_cuda.nmr_planes_vjp``), which
    recomputes the weights from the winner planes and the index map: the
    forward saves those two, which the resolve made, and no weight
    planes."""

    @staticmethod
    def forward(ctx, fvm_planar, face_index_map, image_size, row_start, weights):
        coordinate_map, weight_planes, foreground = nmr_planes(
            fvm_planar, face_index_map, image_size, row_start, weights)
        ctx.save_for_backward(fvm_planar, face_index_map)
        ctx.window = image_size, row_start
        ctx.mark_non_differentiable(foreground, *([] if weight_planes is None
                                                  else [weight_planes]))
        return coordinate_map, weight_planes, foreground

    @staticmethod
    def backward(ctx, grad, _grad_weights, _grad_foreground):
        fvm_planar, face_index_map = ctx.saved_tensors
        return (nmr_planes_vjp(grad, fvm_planar, face_index_map, *ctx.window),
                None, None, None, None)


def _maps(fvm_planar, attr_planes, face_index_map, params, hp, render_size, row_start):
    """The maps of :func:`channel_map_steps` from the resolve's winner
    planes: (images, coordinate_map, foreground).  The weight planes are
    made only for the RGB and depth channels, which read them."""
    coordinate_map, weight_planes, foreground = _CoordinatePlanes.apply(
        fvm_planar, face_index_map, render_size, row_start, hp.draw_rgb or hp.draw_depth)

    channels = []
    if hp.draw_rgb:
        # attribute planes: UV 6, then normals 9, then texels ts*ts*3
        uv_planes = attr_planes[:, :6]
        normal_vertex_planes = attr_planes[:, 6:15] if params.lights is not None else None
        if params.texture_size is not None:
            ts = params.texture_size
            texel_planes = attr_planes[:, 6 if normal_vertex_planes is None else 15:]
            rgb = shading.sample_textures_texel_planes(
                fvm_planar, uv_planes, texel_planes, face_index_map, weight_planes,
                hp.eps, ts, params.textures.shape[3] // ts,
            )
        else:
            rgb = shading.sample_textures_atlas_planes(
                fvm_planar, uv_planes, params.textures, face_index_map, weight_planes,
                hp.eps,
            )
        # an empty lights tuple still multiplies by the (zero) colour weight
        if normal_vertex_planes is not None:
            with trace.span("lights", rgb):
                # a view made inside the span, so that its backward span
                # closes once the normals' gradient is made; the slice
                # itself comes before the sampler, whose backward then runs
                # while that gradient waits (a whole attribute plane's
                # gradient would wait there if the slice came later)
                normals = normal_vertex_planes.view_as(normal_vertex_planes)
                # K15, K16 as its backward
                shaded = shading.shade_planes(rgb, normals, weight_planes, params.lights)
            trace.vjp("lights.vjp", shaded, [rgb, normals])
            rgb = shaded
        channels.append(rgb)
    if hp.draw_silhouettes:
        channels.append(foreground)
    if hp.draw_depth:
        channels.append(shading.depth_plane(fvm_planar, face_index_map, weight_planes))
    if not channels:
        raise ValueError("nothing to draw")
    images = channels[0] if len(channels) == 1 else torch.cat(channels, dim=1)
    return images, coordinate_map, foreground


class _FlipPool(torch.autograd.Function):
    """Flip H and W, then the 2x2 anti-aliasing mean (rasterize.py:315-328);
    the backward is upsample-by-2 of the flipped, quartered gradient."""

    @staticmethod
    def forward(ctx, images):
        pooled = (
            images[:, :, 0::2, 0::2] + images[:, :, 0::2, 1::2]
            + images[:, :, 1::2, 0::2] + images[:, :, 1::2, 1::2]
        ) * 0.25
        return pooled.flip(2, 3)

    @staticmethod
    def backward(ctx, grad):
        g = grad.flip(2, 3) * 0.25
        return g.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _flip_pool(images):
    return _FlipPool.apply(images)


def finalize_images(images, coordinate_map, foreground, backgrounds, hp, hook=differentiation):
    """Background blend -> NMR differentiation hook -> flip -> AA pool.

    The sharded entry runs it on a band of rows (``parallel.render``):
    ``backgrounds`` are then the rows that the flip brings onto the band,
    and ``hook`` the NMR hook on a band, which takes its neighbours' rows in
    the backward."""
    with trace.span("pool", images):
        if backgrounds is not None and hp.draw_rgb:
            rgb = shading.blend_background_planes(foreground, images[:, :3], backgrounds)
            images = torch.cat([rgb, images[:, 3:]], dim=1)
        images = hook(images, coordinate_map)
        out = _flip_pool(images) if hp.anti_aliasing else images.flip(2, 3)
    trace.vjp("pool.vjp", out, images)
    return out


def make_backgrounds(params, batch_size, render_size, device):
    """The background plane [bs, 3, S, S] in float32 (as the JAX package
    reads it, x64 off), or None.  ``background_color`` renders the real
    colour (a deliberate departure from the reference, whose ``zeros *
    color`` always gives black; see the JAX package)."""
    if params.background_color is not None:
        if len(params.background_color) != 3:
            raise ValueError(f"background_color must be 3 values, got "
                             f"{params.background_color!r}")
        color = graphs.constant(params.background_color, device)
        return color[None, :, None, None].expand(batch_size, 3, render_size, render_size)
    if params.backgrounds is not None:
        if tuple(params.backgrounds.shape) != (batch_size, 3, render_size, render_size):
            raise ValueError(
                f"backgrounds must be {(batch_size, 3, render_size, render_size)}, "
                f"got {tuple(params.backgrounds.shape)}"
            )
        return params.backgrounds.to(torch.float32)
    return None


def check_inputs(vertices, faces, params, hp):
    """Raise ValueError on inputs :func:`rasterize_core` cannot render."""
    if vertices.ndim != 3 or vertices.shape[2] != 3:
        raise ValueError(f"vertices must be [bs, nv, 3], got {tuple(vertices.shape)}")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be [nf, 3], got {tuple(faces.shape)}")
    if hp.draw_rgb:
        for name, ndim, last in (("vertices_textures", 3, 2), ("faces_textures", 2, 3)):
            t = getattr(params, name)
            if t is None or t.ndim != ndim or t.shape[-1] != last:
                raise ValueError(f"RGB rendering needs {name} of {ndim} dims, last {last}")
        if params.textures is None or params.textures.ndim != 4 or params.textures.shape[1] != 3:
            raise ValueError("RGB rendering needs textures [bs, 3, th, tw]")


def rasterize_core(vertices, faces, params, hyperparams):
    """Render the requested channels: [bs, C, H, W], flipped in H and W like
    the reference.  ``vertices`` [bs, nv, 3] float32 NDC; ``faces`` [nf, 3]
    int32, on the same device."""
    hp = hyperparams
    check_inputs(vertices, faces, params, hp)
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    backgrounds = make_backgrounds(params, vertices.shape[0], render_size, vertices.device)
    images, coordinate_map, foreground = compute_channel_maps(
        vertices, faces, params, hp, render_size
    )
    return finalize_images(images, coordinate_map, foreground, backgrounds, hp)


def _graph_inputs(vertices, params):
    """The tensors a graph of this render copies in at each call, in order
    (absent ones None): the vertices, texel coordinates, texel faces,
    atlas, backgrounds and each light's tensor fields; and the lights'
    structure (their types and other fields)."""
    tensors = [vertices, params.vertices_textures, params.faces_textures, params.textures,
               params.backgrounds]
    structure = None
    if params.lights is not None:
        structure = []
        for light in params.lights:
            fields = []
            for field in dataclasses.fields(light):
                value = getattr(light, field.name)
                if isinstance(value, torch.Tensor):
                    tensors.append(value)
                    value = torch.Tensor
                fields.append((field.name, value))
            structure.append((type(light), tuple(fields)))
        structure = tuple(structure)
    return tensors, structure


def _with_inputs(params, tensors, background_color):
    """``params`` over the graph's own ``tensors`` (in :func:`_graph_inputs`'
    order)."""
    vertices, vt, ft, textures, backgrounds, *light_tensors = tensors
    lights = None
    if params.lights is not None:
        fields = iter(light_tensors)
        lights = tuple(
            dataclasses.replace(light, **{
                f.name: next(fields) for f in dataclasses.fields(light)
                if isinstance(getattr(light, f.name), torch.Tensor)})
            for light in params.lights)
    return vertices, dataclasses.replace(
        params, vertices_textures=vt, faces_textures=ft, textures=textures,
        backgrounds=backgrounds, background_color=background_color, lights=lights)


def graph_signature(vertices, params, hp):
    """The key of a render's graph over its faces (the counterpart of what
    ``jax.jit`` specialises on): the hyperparameters, the device, the grad
    and inference modes, each tensor input's shape, strides, dtype and
    ``requires_grad``, the ``background_color`` value, ``texture_size``
    and the lights' structure.  Also returns the graph's inputs and the
    background colour as floats."""
    tensors, structure = _graph_inputs(vertices, params)
    color = params.background_color
    if color is not None:
        color = tuple(float(c) for c in color)
    signature = (
        hp, vertices.device, torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
        tuple(None if t is None else (tuple(t.shape), t.stride(), t.dtype, t.requires_grad)
              for t in tensors),
        color, params.texture_size, structure,
    )
    return signature, tensors, color


def _label(vertices, faces, hp):
    return (f"{'rgb ' if hp.draw_rgb else ''}{'silhouettes ' if hp.draw_silhouettes else ''}"
            f"{'depth ' if hp.draw_depth else ''}bs={vertices.shape[0]} nf={faces.shape[0]} "
            f"image {hp.image_size} AA {hp.anti_aliasing}")


def _capture(record, params, hp, tensors, color, label, min_capacity=0):
    def render(*inputs):
        v, static_params = _with_inputs(params, inputs, color)
        return rasterize_core(v, record.faces, static_params, hp)

    return graphs.Graph(render, tensors, torch.is_grad_enabled(), label, record, min_capacity)


def _run(vertices, faces, params, hp):
    params = RasterizeParam() if params is None else params
    how = graphs.route(vertices, faces, hp)
    record = graphs.faces_record(faces)
    graph = None
    if how == "graph":
        signature, tensors, color = graph_signature(vertices, params, hp)
        label = _label(vertices, faces, hp)
        graph = graphs.cached_graph(
            record, signature,
            lambda min_capacity=0: _capture(record, params, hp, tensors, color, label,
                                            min_capacity),
            label)
    if graph is None:
        with graphs.rendering(record):
            return rasterize_core(vertices, record.faces, params, hp)
    return graph(*tensors)


def rasterize_silhouettes(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """Silhouettes [bs, H, W] of NDC ``vertices`` [bs, nv, 3] and int32
    ``faces`` [nf, 3]; differentiable with respect to ``vertices`` through
    the NMR gradient."""
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp)[:, 0]


def rasterize_rgba(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """RGB + silhouette [bs, 4, H, W]; differentiable with respect to the
    vertices, ``textures``, ``vertices_textures`` and the lights."""
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp)


def rasterize_rgb(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """RGB [bs, 3, H, W]."""
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=False, draw_depth=False)
    return _run(vertices, faces, params, hp)


def rasterize_depth(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """Depth [bs, H, W], 0 on background."""
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=False, draw_depth=True)
    return _run(vertices, faces, params, hp)[:, 0]


def rasterize_all(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """RGB + silhouette + depth [bs, 5, H, W] in one pass."""
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=True, draw_depth=True)
    return _run(vertices, faces, params, hp)


rasterize = rasterize_rgba
