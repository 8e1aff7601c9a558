"""Sharded rendering over a (data, tile, face) mesh (counterpart of
``neural_renderer_v2_pytorch_tpu/parallel/render.py``).

Every rank passes the same global inputs and returns the same global
images.  Each rank:

  * renders the row-local stage (``ops.rasterize.compute_channel_maps``:
    resolve, maps, shading) for its batch slice (``data``), its band of
    ``ceil(S / tile)`` rows (``tile``; the last band runs past the image
    bottom and is cropped) and, with ``face`` > 1, its face range with the
    ordered fold (``parallel.faces``);
  * gathers the (data, tile) cells' planes into the full canvas (one
    all-gather over ``Mesh.groups["cells"]``) and runs the global stage
    (``finalize_images``: background blend, the NMR hook, flip, AA pool)
    there.  The JAX package runs that stage on the sharded canvas with
    1-row halo exchanges instead; the gather's backward hands each rank its
    own cell of the cotangent, so nothing is counted twice;
  * sums the gradients of the inputs the row-local stage read (vertices,
    texel coordinates, textures, light tensors) in one all-reduce of one
    buffer per backward over every rank of the mesh, so that every rank
    receives the same bits.  Ranks along ``face`` compute the same
    contribution (the winner gather reads the whole face set) up to the
    order of the scatters' atomics on the card, so only the rank at face
    coordinate 0 contributes its own and the others contribute zeros:
    replicas that each kept their own gradient would take different
    optimiser steps and drift apart.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    check_inputs,
    compute_channel_maps,
    finalize_images,
    make_backgrounds,
)
from .collectives import all_gather, all_reduce_sum


class _SumGradients(torch.autograd.Function):
    """Identity forward on tensors every rank holds alike; the backward sums
    their gradients over ``group`` in one all-reduce of one buffer, to which
    a rank with ``contributes`` false adds zeros."""

    @staticmethod
    def forward(ctx, group, contributes, *tensors):
        ctx.group, ctx.contributes = group, contributes
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        if not ctx.contributes:
            flat = torch.zeros_like(flat)
        flat = all_reduce_sum(flat, ctx.group, "grad_all_reduce")
        return (None, None, *(part.view_as(g) for part, g in
                        zip(flat.split([g.numel() for g in grads]), grads)))


def _light_tensors(light):
    return {f.name: getattr(light, f.name) for f in dataclasses.fields(light)
            if isinstance(getattr(light, f.name), torch.Tensor)}


_PARAM_TENSORS = ("vertices_textures", "textures")


def _local_inputs(vertices, params):
    """The tensors the row-local stage reads: the vertices, the texel
    coordinates, the textures and the lights' tensors."""
    out = [vertices] + [getattr(params, k) for k in _PARAM_TENSORS
                        if getattr(params, k) is not None]
    for light in params.lights or ():
        out += _light_tensors(light).values()
    return out


def _map_local_inputs(vertices, params, fn):
    """(vertices, params) with ``fn`` applied to each of
    :func:`_local_inputs`."""
    lights = None if params.lights is None else tuple(
        dataclasses.replace(light, **{k: fn(t) for k, t in _light_tensors(light).items()})
        for light in params.lights)
    return fn(vertices), dataclasses.replace(
        params, lights=lights,
        **{k: fn(getattr(params, k)) for k in _PARAM_TENSORS if getattr(params, k) is not None})


def _sum_gradients_over(vertices, params, group, contributes):
    """Route the row-local inputs that take gradients through one
    :class:`_SumGradients`."""
    wanted = [t for t in _local_inputs(vertices, params) if t.requires_grad]
    if not wanted:
        return vertices, params
    summed = dict(zip(map(id, wanted), _SumGradients.apply(group, contributes, *wanted)))
    return _map_local_inputs(vertices, params, lambda t: summed.get(id(t), t))


class _GatherCanvas(torch.autograd.Function):
    """The cells' planes [bs / data, K, rows, S] -> the canvas [bs, K, S, S]
    on every rank; the backward returns this rank's cell of the cotangent."""

    @staticmethod
    def forward(ctx, planes, group, n_data, n_tile, coords, size):
        bl, k, rows, _ = planes.shape
        cells = all_gather(planes, group, "canvas_all_gather")      # [data*tile, bl, K, rows, S]
        canvas = cells.reshape(n_data, n_tile, bl, k, rows, size).permute(0, 2, 3, 1, 4, 5)
        ctx.cell = (coords["data"] * bl, coords["tile"] * rows, bl, rows)
        return canvas.reshape(n_data * bl, k, n_tile * rows, size)[:, :, :size].contiguous()

    @staticmethod
    def backward(ctx, grad):
        b0, r0, bl, rows = ctx.cell
        g = grad[b0:b0 + bl, :, r0:r0 + rows]
        # the rows past the image bottom were cropped: no gradient
        g = torch.nn.functional.pad(g, (0, 0, 0, rows - g.shape[2]))
        return g, None, None, None, None, None


def rasterize_core_sharded(vertices, faces, params, hyperparams, mesh):
    """Sharded ``ops.rasterize.rasterize_core`` over ``mesh``
    (``parallel.mesh.make_mesh``): [bs, C, H, W] images, the same on every
    rank.  ``vertices`` [bs, nv, 3] NDC (bs divisible by the data axis),
    ``faces`` [nf, 3] int32 and ``params`` are the global inputs, the same
    on every rank; batch-major parameters (texel coordinates, textures,
    light tensors whose first dimension is bs) are sliced over ``data``."""
    hp = hyperparams
    check_inputs(vertices, faces, params, hp)
    bs = vertices.shape[0]
    n_data, n_tile, n_face = (mesh.shape[a] for a in ("data", "tile", "face"))
    if bs % n_data:
        raise ValueError(f"batch {bs} does not divide over data={n_data}")
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    rows = -(-render_size // n_tile)
    bl = bs // n_data
    mine = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    if n_data * n_tile * n_face > 1:
        vertices, params = _sum_gradients_over(vertices, params, mesh.groups["all"],
                                               mesh.coords["face"] == 0)
    local_vertices, local_params = _map_local_inputs(
        vertices, params, lambda t: t[mine] if t.ndim and t.shape[0] == bs else t)
    images, coordinate_map, foreground = compute_channel_maps(
        local_vertices, faces, local_params, hp, render_size,
        row_start=mesh.coords["tile"] * rows, num_rows=rows,
        face_group=mesh.groups["face"] if n_face > 1 else None,
    )
    if n_data * n_tile > 1:
        c = images.shape[1]
        canvas = _GatherCanvas.apply(torch.cat([images, coordinate_map, foreground], 1),
                                     mesh.groups["cells"],
                                     n_data, n_tile, mesh.coords, render_size)
        images, coordinate_map = canvas[:, :c], canvas[:, c:c + 2]
        foreground = canvas[:, c + 2:].detach()
    backgrounds = make_backgrounds(params, bs, render_size, vertices.device)
    return finalize_images(images, coordinate_map, foreground, backgrounds, hp)


def _run(vertices, faces, params, hp, mesh):
    params = RasterizeParam() if params is None else params
    return rasterize_core_sharded(vertices, faces.to(torch.int32).contiguous(), params, hp,
                                  mesh)


def rasterize_silhouettes_sharded(vertices, faces, params=None,
                                  hyperparams=RasterizeHyperparam(), *, mesh):
    """Sharded ``rasterize_silhouettes``: [bs, H, W] on every rank."""
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)[:, 0]


def rasterize_rgba_sharded(vertices, faces, params=None, hyperparams=RasterizeHyperparam(),
                           *, mesh):
    """Sharded ``rasterize_rgba``: [bs, 4, H, W] on every rank."""
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=True, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)


def rasterize_rgb_sharded(vertices, faces, params=None, hyperparams=RasterizeHyperparam(),
                          *, mesh):
    """Sharded ``rasterize_rgb``: [bs, 3, H, W] on every rank."""
    hp = hyperparams.replace(draw_rgb=True, draw_silhouettes=False, draw_depth=False)
    return _run(vertices, faces, params, hp, mesh)


def rasterize_depth_sharded(vertices, faces, params=None, hyperparams=RasterizeHyperparam(),
                            *, mesh):
    """Sharded ``rasterize_depth``: [bs, H, W] on every rank."""
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=False, draw_depth=True)
    return _run(vertices, faces, params, hp, mesh)[:, 0]
