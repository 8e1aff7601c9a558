"""Sharded rendering over a (data, tile, face) mesh (counterpart of
``neural_renderer_v2_pytorch_tpu/parallel/render.py``).

Every rank passes the same global inputs and returns the same global
images.  Each rank:

  * renders the row-local stage (``ops.rasterize.compute_channel_maps``:
    resolve, maps, shading) for its batch slice (``data``), its band of
    :func:`band_rows` rows (``tile``; bands past the image bottom are
    cropped, and may be empty) and, with ``face`` > 1, its face range with
    the ordered fold (``parallel.faces``);
  * runs the global stage (``finalize_images``: background blend, the NMR
    hook, flip, AA pool) on its band.  The forward needs no collective.
    The NMR backward reads one row on each side of the band: one
    all-gather over ``Mesh.groups["tile"]`` of every band's first and last
    rows of the images and of the incoming gradient (the JAX package's
    1-row halos, which GSPMD inserts there);
  * gathers the finished bands (one all-gather over ``Mesh.groups
    ["cells"]``), each placed at its mirrored rows, so that the H flip
    needs no exchange of its own.  The gather's backward hands each rank
    its band of the cotangent, which every rank holds alike;
  * sums the gradients of the global inputs it read (vertices, texel
    coordinates, textures, backgrounds, light tensors) in one all-reduce
    of one buffer per backward over every rank of the mesh, so that every
    rank receives the same bits.  Ranks along ``face`` compute the same
    contribution (the winner gather reads the whole face set) up to the
    order of the scatters' atomics on the card, so only the rank at face
    coordinate 0 contributes its own and the others contribute zeros:
    replicas that each kept their own gradient would take different
    optimiser steps and drift apart.

Every collective goes through ``parallel.collectives`` (gloo staged
through host memory, or NCCL as it is); a rank whose band is empty still
joins each one, in the same order as the others.

On the card the entry points replay the rank's compiled core (the
counterpart of ``_jitted_sharded``, one program per hyperparameters and
mesh there): a ``graphs.Chain`` per signature, mesh and faces tensor,
whose plan is :class:`RankStep`.  With one rank per card (NCCL) the plan
is the whole step, the images' all-gather and the gradients' all-reduce
included, and the chain captures every collective inline: one forward and
one backward graph.  Where ranks share a card (gloo, through the host)
the collectives cannot be captured: each stretch of the rank's device
work between two of them is a CUDA graph (the forward up to the face
fold's all-gathers and after them, the backward up to the halo exchange
and after it), and the gradients' all-reduce and the images' all-gather
stay around the chain, in :class:`_SumGradients` and
:class:`_GatherImages`.  The first call of a signature, CPU tensors,
``nr.eager()`` and ``plain_versions`` run eagerly, through the same steps
and the same collectives in the same order (``collectives.run``,
:class:`_SumGradients`, :class:`_GatherImages`), so a rank may run
eagerly or capture while the others replay.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import differentiation as nmr
from ..ops import graphs
from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    _graph_inputs,
    _label,
    _with_inputs,
    channel_map_steps,
    check_inputs,
    finalize_images,
    graph_signature,
    make_backgrounds,
)
from . import collectives
from .collectives import all_gather, all_reduce_sum, run


def _gradient_buffer(grads, contributes):
    """``grads`` in one flat buffer, the all-reduce's; zeros where
    ``contributes`` is false."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    return flat if contributes else torch.zeros_like(flat)


def _split_gradients(flat, like):
    """The summed buffer ``flat`` as gradients shaped as ``like``."""
    return tuple(part.view_as(g) for part, g in zip(flat.split([g.numel() for g in like]), like))


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
        flat = all_reduce_sum(_gradient_buffer(grads, ctx.contributes), ctx.group,
                              "grad_all_reduce")
        return (None, None, *_split_gradients(flat, grads))


def _light_tensors(light):
    return {f.name: getattr(light, f.name) for f in dataclasses.fields(light)
            if isinstance(getattr(light, f.name), torch.Tensor)}


_PARAM_TENSORS = ("vertices_textures", "textures", "backgrounds")


def _local_inputs(vertices, params):
    """The global tensors a rank reads: the vertices, the texel
    coordinates, the textures, the backgrounds and the lights' tensors."""
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
    """Route the inputs of :func:`_local_inputs` that take gradients
    through one :class:`_SumGradients`."""
    wanted = [t for t in _local_inputs(vertices, params) if t.requires_grad]
    if not wanted:
        return vertices, params
    summed = dict(zip(map(id, wanted), _SumGradients.apply(group, contributes, *wanted)))
    return _map_local_inputs(vertices, params, lambda t: summed.get(id(t), t))


def band_rows(image_size, anti_aliasing, n_tile):
    """The rows of each tile's band of the render: ``ceil(image_size /
    n_tile)``, doubled with anti-aliasing, so that no 2x2 pool straddles two
    bands.  The bands past the image bottom are cropped (the last ones may
    be empty): the resolve is per pixel, so no output depends on the
    split."""
    return (2 if anti_aliasing else 1) * -(-image_size // n_tile)


def _real_rows(render_size, rows, tile):
    """The rows of band ``tile`` that lie in the image."""
    return max(0, min(rows, render_size - tile * rows))


def _band_backgrounds(backgrounds, render_size, row_start, real):
    """The rows of ``backgrounds`` [bs, 3, S, S] that the blend's flip
    brings onto the band of ``real`` rows from ``row_start``: rows ``S -
    row_start - real .. S - row_start - 1``, which it reverses."""
    first = max(render_size - row_start - real, 0)
    return backgrounds[:, :, first:first + real]


def _band_edges(images, grad):
    """The band's first and last rows of the images and of the gradient
    [bs, C, rows, W] as one tensor [bs, 2C, 2, W] (zeros for an empty
    band), which the halo exchange gathers."""
    bs, c, rows, w = images.shape
    if not rows:
        return images.new_zeros(bs, 2 * c, 2, w)
    # by slices: a list of rows would be copied from the host
    return torch.cat([torch.cat([t[:, :, :1], t[:, :, -1:]], 2) for t in (images, grad)], 1)


def _band_grad(images, grad, halo, tile, rows, render_size):
    """Band ``tile``'s rows of the coordinate gradient [bs, 2, rows', W]
    from its images and gradient [bs, C, rows', W] and ``halo``, every
    band's :func:`_band_edges` [n_tile, bs, 2C, 2, W]: the last row of the
    band above, the first of the band below, none at the image's top row or
    below its last real row."""
    bs, c, real, w = images.shape
    if not real:
        return images.new_zeros(bs, 2, 0, w)
    above = below = None
    if tile > 0:
        edge = halo[tile - 1][:, :, 1:]
        above = edge[:, :c], edge[:, c:]
    if (tile + 1) * rows < render_size:
        edge = halo[tile + 1][:, :, :1]
        below = edge[:, :c], edge[:, c:]
    return nmr.band_coordinate_grad(images, grad, above, below, render_size)


class _BandDifferentiation(torch.autograd.Function):
    """The NMR hook on this rank's band of the render: the identity forward;
    the backward exchanges the band edges over ``group`` (the tile line) in
    one all-gather and returns the band's rows of the whole image's
    coordinate gradient."""

    @staticmethod
    def forward(ctx, images, coordinates, group, tile, rows, render_size):
        ctx.save_for_backward(images)
        ctx.band = group, tile, rows, render_size
        return images.view_as(images)

    @staticmethod
    def backward(ctx, grad):
        (images,) = ctx.saved_tensors
        group, tile, rows, render_size = ctx.band
        halo = all_gather(_band_edges(images, grad), group, "halo_exchange")
        coordinate_grad = _band_grad(images, grad, halo, tile, rows, render_size)
        return grad, coordinate_grad, None, None, None, None


def _assemble(cells, counts):
    """The images [n_data * bl, C, H, W] from every cell's finished band
    ``cells`` [n_data, n_tile, bl, C, rows, W], band t's first ``counts[t]``
    rows real: the flip puts the last band on top."""
    n_data, n_tile, bl, c, _, w = cells.shape
    out = torch.cat([cells[:, t, :, :, :counts[t]] for t in reversed(range(n_tile))], 3)
    return out.reshape(n_data * bl, c, sum(counts), w)


def _band_top(counts, tile):
    """The first row of the images that band ``tile`` lands on."""
    return sum(counts[tile + 1:])


def _padded(band, counts):
    """The finished band [bl, C, n, W] padded to the longest band's rows,
    as the images' all-gather takes it."""
    return F.pad(band, (0, 0, 0, max(counts) - band.shape[2]))


def _cotangent_band(grad, band_shape, counts, coords):
    """This rank's band of the images' cotangent ``grad`` [bs, C, H, W]:
    its batch slice and the rows that its band (``band_shape`` [bl, C, n,
    W]) lands on."""
    bl, _, n, _ = band_shape
    b0, top = coords["data"] * bl, _band_top(counts, coords["tile"])
    return grad[b0:b0 + bl, :, top:top + n]


class _GatherImages(torch.autograd.Function):
    """Every (data, tile) cell's finished band [bl, C, counts[tile], W]
    -> the images [bs, C, H, W] on every rank (:func:`_assemble`); the
    backward returns this rank's band of the cotangent."""

    @staticmethod
    def forward(ctx, band, group, n_data, counts, coords):
        padded = _padded(band, counts)
        cells = all_gather(padded, group, "image_all_gather")    # [data*tile, bl, C, rows, W]
        ctx.cell = band.shape, counts, coords
        return _assemble(cells.reshape(n_data, len(counts), *padded.shape), counts)

    @staticmethod
    def backward(ctx, grad):
        return _cotangent_band(grad, *ctx.cell), None, None, None, None


def _band_hook(mesh, tile, rows, render_size):
    """The NMR hook on this rank's band (:class:`_BandDifferentiation`)."""
    def hook(images, coordinates):
        return _BandDifferentiation.apply(images, coordinates, mesh.groups["tile"], tile, rows,
                                          render_size)
    return hook


def _rank_steps(vertices, faces, params, hp, mesh, hook):
    """A rank's forward from the global inputs to its finished band [bl, C,
    rows', W] (its batch slice, its rows of the image), as a generator
    that yields the face fold's all-gathers (``ops.graphs.drive``): the
    data slice, the band's channel maps (its face range folded across
    ``face``), the background blend, ``hook`` and the flip and pool."""
    bs = vertices.shape[0]
    n_data, n_tile, n_face = (mesh.shape[a] for a in ("data", "tile", "face"))
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    rows = band_rows(hp.image_size, hp.anti_aliasing, n_tile)
    tile = mesh.coords["tile"]
    row_start, real = tile * rows, _real_rows(render_size, rows, tile)
    bl = bs // n_data
    mine = slice(mesh.coords["data"] * bl, (mesh.coords["data"] + 1) * bl)
    local_vertices, local_params = _map_local_inputs(
        vertices, params, lambda t: t[mine] if t.ndim and t.shape[0] == bs else t)
    maps = yield from channel_map_steps(
        local_vertices, faces, local_params, hp, render_size, row_start=row_start,
        num_rows=rows, face_group=mesh.groups["face"] if n_face > 1 else None)
    images, coordinate_map, foreground = (m[:, :, :real] for m in maps)
    backgrounds = make_backgrounds(params, bs, render_size, vertices.device)
    if backgrounds is not None:
        backgrounds = _band_backgrounds(backgrounds[mine], render_size, row_start, real)
    return finalize_images(images, coordinate_map, foreground, backgrounds, hp, hook)


def _check(vertices, faces, params, hp, mesh):
    check_inputs(vertices, faces, params, hp)
    if vertices.shape[0] % mesh.shape["data"]:
        raise ValueError(f"batch {vertices.shape[0]} does not divide over "
                         f"data={mesh.shape['data']}")


def _band_counts(hp, n_tile):
    """The finished rows of each tile's band."""
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    rows = band_rows(hp.image_size, hp.anti_aliasing, n_tile)
    pool = 2 if hp.anti_aliasing else 1
    return [_real_rows(render_size, rows, t) // pool for t in range(n_tile)]


def _core(vertices, faces, params, hp, mesh, chain=None, whole=False):
    """The sharded render of checked inputs.  ``chain``, where given, is a
    :class:`graphs.Chain` of this call's signature; with ``whole`` its plan
    is the whole step, and its replay is the render.  Else the gradients'
    all-reduce around the rank's step, which ``chain`` replays where given,
    else runs eagerly; then the finished bands' all-gather."""
    if whole:
        return chain(*_graph_inputs(vertices, params)[0])
    n_data, n_tile, n_face = (mesh.shape[a] for a in ("data", "tile", "face"))
    if n_data * n_tile * n_face > 1:
        vertices, params = _sum_gradients_over(vertices, params, mesh.groups["all"],
                                               mesh.coords["face"] == 0)
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    rows = band_rows(hp.image_size, hp.anti_aliasing, n_tile)
    if chain is None:
        band = run(_rank_steps(vertices, faces, params, hp, mesh,
                               _band_hook(mesh, mesh.coords["tile"], rows, render_size)))
    else:
        band = chain(*_graph_inputs(vertices, params)[0])
    return _GatherImages.apply(band, mesh.groups["cells"], n_data, _band_counts(hp, n_tile),
                               mesh.coords)


def rasterize_core_sharded(vertices, faces, params, hyperparams, mesh):
    """Sharded ``ops.rasterize.rasterize_core`` over ``mesh``
    (``parallel.mesh.make_mesh``): [bs, C, H, W] images, the same on every
    rank.  ``vertices`` [bs, nv, 3] NDC (bs divisible by the data axis),
    ``faces`` [nf, 3] int32 and ``params`` are the global inputs, the same
    on every rank; batch-major parameters (texel coordinates, textures,
    backgrounds, light tensors whose first dimension is bs) are sliced over
    ``data``.  Runs eagerly (the entry points replay graphs)."""
    _check(vertices, faces, params, hyperparams, mesh)
    return _core(vertices, faces, params, hyperparams, mesh)


class RankStep:
    """A rank's step of the sharded entry as a :class:`graphs.Chain` plan
    (the counterpart of the program ``_jitted_sharded`` compiles for one
    device of the mesh).  ``forward(*inputs)`` (``rasterize._graph_inputs``'
    order) runs :func:`_rank_steps` with the NMR hook cut out: its images
    and coordinate map are kept in the frame, and the flip and pool start
    from a detached copy of the images.  ``backward`` takes the band's
    cotangent through the flip and pool, exchanges the band edges (the
    halo, over ``tile``), and takes the hook's outputs' cotangents, the
    coordinate gradient of :func:`_band_grad` among them, to the inputs.

    With ``whole`` the plan is the whole step: the forward also gathers
    the finished bands into the images (over ``cells``), and the backward
    starts from this rank's band of their cotangent and ends in the
    gradients' one all-reduce (over every rank, zeros from a rank off face
    coordinate 0), as :class:`_GatherImages` and :class:`_SumGradients`
    do around a chain whose plan is not whole.  Between two collectives
    every operation is the rank's own device work."""

    def __init__(self, faces, params, color, hp, mesh, whole=False):
        self.faces, self.params, self.color, self.hp, self.mesh = faces, params, color, hp, mesh
        self.whole = whole
        self.render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
        self.rows = band_rows(hp.image_size, hp.anti_aliasing, mesh.shape["tile"])
        self.counts = _band_counts(hp, mesh.shape["tile"])

    def forward(self, *inputs):
        vertices, params = _with_inputs(self.params, inputs, self.color)
        frame = {}

        def cut(images, coordinates):
            # the hook's output takes gradients where either input does
            # (silhouettes: the coordinates alone)
            wanted = images.requires_grad or coordinates.requires_grad
            frame.update(images=images, coordinates=coordinates,
                         hooked=images.detach().requires_grad_(wanted))
            return frame["hooked"]

        band = yield from _rank_steps(vertices, self.faces, params, self.hp, self.mesh, cut)
        if not self.whole:
            return band, frame
        frame["band"] = band
        padded = _padded(band, self.counts)
        (cells,) = yield [(padded, self.mesh.groups["cells"], "image_all_gather")]
        n_data, n_tile = self.mesh.shape["data"], self.mesh.shape["tile"]
        return _assemble(cells.reshape(n_data, n_tile, *padded.shape), self.counts), frame

    def backward(self, frame, output, grad, wanted):
        if not self.whole:
            return (yield from self._band_backward(frame, output, grad, wanted))
        band = frame["band"]
        grads = yield from self._band_backward(
            frame, band, _cotangent_band(grad, band.shape, self.counts, self.mesh.coords),
            wanted)
        flat = _gradient_buffer([torch.zeros_like(w) if g is None else g
                                 for g, w in zip(grads, wanted)],
                                self.mesh.coords["face"] == 0)
        (flat,) = yield [(flat, self.mesh.groups["all"], "grad_all_reduce")]
        return _split_gradients(flat, wanted)

    def _band_backward(self, frame, band, grad, wanted):
        images, coordinates, hooked = frame["images"], frame["coordinates"], frame["hooked"]
        if not hooked.requires_grad:
            return (None,) * len(wanted)
        (g,) = torch.autograd.grad(band, hooked, grad)
        (halo,) = yield [(_band_edges(images, g), self.mesh.groups["tile"], "halo_exchange")]
        coordinate_grad = _band_grad(images, g, halo, self.mesh.coords["tile"], self.rows,
                                     self.render_size)
        outputs = [(t, c) for t, c in ((images, g), (coordinates, coordinate_grad))
                   if t.requires_grad]
        return torch.autograd.grad([t for t, _ in outputs], wanted, [c for _, c in outputs],
                                   allow_unused=True)


def sharded_signature(vertices, params, hp, mesh):
    """The key of a rank's :class:`graphs.Chain` over its faces (the
    counterpart of ``_jitted_sharded``'s ``lru_cache(hyperparams, mesh)``
    and what its ``jax.jit`` specialises on): the single-device render's
    (``rasterize.graph_signature``), the mesh's shape, this rank's
    coordinates and its process groups.  Also returns the chain's inputs
    and the background colour as floats."""
    signature, tensors, color = graph_signature(vertices, params, hp)
    mesh_key = (tuple(mesh.shape.items()), tuple(mesh.coords.items()),
                tuple(mesh.groups.items()))
    return (signature, mesh_key), tensors, color


def _run(vertices, faces, params, hp, mesh):
    params = RasterizeParam() if params is None else params
    _check(vertices, faces, params, hp, mesh)
    how = graphs.route(vertices, faces, hp)
    # the int32 faces are kept per faces tensor, as the single-device entry
    # keeps them, and the rank's graphs with them
    record = graphs.faces_record(faces)
    chain, whole = None, False
    if how == "eager":
        graphs.note_eager("sharded entry (CPU tensors, eager() or plain_versions)", hp,
                          tuple(mesh.shape.items()))
    elif how == "graph":
        signature, tensors, color = sharded_signature(vertices, params, hp, mesh)
        label = (f"sharded {_label(vertices, faces, hp)} mesh "
                 f"{tuple(mesh.shape.values())} at {tuple(mesh.coords.values())}")
        # the whole step in the chain where a graph can hold every
        # collective of the mesh (NCCL)
        whole = collectives.capturable([(vertices, group, None)
                                        for group in mesh.groups.values()])
        chain = graphs.cached_graph(
            record, signature,
            lambda min_capacity=0: graphs.Chain(
                RankStep(record.faces, params, color, hp, mesh, whole), tensors,
                torch.is_grad_enabled(), label, record, min_capacity),
            label)
    return _core(vertices, record.faces, params, hp, mesh, chain, whole and chain is not None)


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
