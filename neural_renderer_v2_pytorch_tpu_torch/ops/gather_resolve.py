"""The face-vertex gather, the resolve with winner latch and the winner-plane
gather, as autograd Functions (counterpart of ``neural_renderer_v2_pytorch_
tpu/ops/gather_resolve.py``, on its planar path), and the id/depth entry
``compute_face_index_map``.  Both resolves take the route
``resolve_cuda.resolve_route`` picks.

Both keep the JAX package's planar layouts: face vertices are
[bs, 3 (coord), 3 (vertex), nf] and maps are channel-planar [bs, C, H, W].
"""

from __future__ import annotations

import torch

from ..utils import trace
from .graphs import (
    INDEX_MAPS,
    Graph,
    bin_faces,
    cached_graph,
    note_eager,
    route,
)
from .resolve_cuda import (
    gather_faces3,
    gather_rows,
    resolve_binned_depth,
    resolve_binned_latch,
    resolve_binned_xy,
    resolve_depth,
    resolve_latch,
    resolve_route,
    resolve_xy,
    scatter_faces_to_vertices,
    scatter_pixels_to_faces,
)

class _GatherFaceVertices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, faces):
        ctx.save_for_backward(faces)
        ctx.num_vertices = vertices.shape[1]
        return gather_faces3(vertices.detach().contiguous(), faces)

    @staticmethod
    def backward(ctx, grad):
        (faces,) = ctx.saved_tensors
        with trace.span("gather.vjp", grad):
            g = scatter_faces_to_vertices(grad.contiguous(), faces, ctx.num_vertices)
        return g, None


def gather_face_vertices(vertices, faces):
    """``vertices[:, faces]`` in the planar layout: [bs, nv, 3] float32 and
    [nf, 3] int32 -> [bs, 3, 3, nf].  The forward is kernel K5 (the JAX
    package's ``gather_faces3_pallas``), the backward kernel K4."""
    with trace.span("gather", vertices):
        return _GatherFaceVertices.apply(vertices, faces)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, planar):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.planar = table.shape[1], planar
        return gather_rows(table.detach().contiguous(), ids, planar)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        # the gather's transpose is K3's pixel -> face scatter, over the
        # planar cotangent as planes of one row of P pixels
        g = grad if ctx.planar else grad.permute(0, 2, 1)
        per_row = scatter_pixels_to_faces(g.contiguous()[:, :, None], ids[:, None], ctx.num_rows)
        return per_row.permute(0, 2, 1), None, None


def gather_table_rows(table, ids, planar=False):
    """``table[b, ids[b, p], :]``, 0 where ``ids[b, p] < 0``, differentiable
    with respect to ``table`` f32 [bs, n, D]; ids i32 [bs, P], contiguous.
    Returns [bs, D, P] when ``planar``, else [bs, P, D].  Kernel K9
    (``resolve_cuda.gather_rows``) forward, K3 backward."""
    return _GatherRows.apply(table, ids, planar)


def gather_winner_planes(per_face, index):
    """Each pixel's winner's row of ``per_face`` f32 [bs, nf, D] as planes
    [bs, D, rows, S] over an index map i32 [bs, rows, S] (contiguous), 0 on
    background (id < 0): the face-sharded path's attribute gather after
    the face combine (the JAX package's ``to_map`` + transpose,
    ``rasterize.py:265-267``), in one K9 launch (planar form)."""
    bs, _, D = per_face.shape
    planes = gather_table_rows(per_face, index.reshape(bs, -1), planar=True)
    return planes.reshape(bs, D, *index.shape[1:])


def _binned_inputs(fvp, draw_backside, image_size, row_start, num_rows, mode):
    """K7's bins where the route of this resolve is binned (decided from
    the shapes), else None: exact, or inside a capture capped
    (``graphs.bin_faces``).  No route launches K1: K7 and both routes'
    resolve forms compute the face constants themselves."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    rows = image_size if num_rows is None else num_rows
    if resolve_route(bs, rows, image_size, nf, mode) != "binned":
        return None
    return bin_faces(fvp, draw_backside, image_size, row_start, num_rows)


class _ResolveAndGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_vertices, face_attrs, image_size, near, far,
                draw_backside, latch_z, row_start, num_rows, mode):
        if face_attrs is not None and not latch_z:
            raise ValueError("attribute planes need latch_z=True")
        fvp = face_vertices.detach().contiguous()
        bs, nf = fvp.shape[0], fvp.shape[-1]
        args = (image_size, near, far, row_start, num_rows)
        bins = _binned_inputs(fvp, draw_backside, image_size, row_start, num_rows, mode)
        if latch_z:
            attrs = (fvp.new_empty((bs, nf, 0)) if face_attrs is None
                     else face_attrs.detach().contiguous())
            if bins is not None:
                index, _, fvm, attr_planes = resolve_binned_latch(fvp, attrs, draw_backside,
                                                                  bins, *args)
            else:
                index, _, fvm, attr_planes = resolve_latch(fvp, attrs, draw_backside, *args)
        else:
            if bins is not None:
                index, _, coords = resolve_binned_xy(fvp, draw_backside, bins, *args)
            else:
                index, _, coords = resolve_xy(fvp, draw_backside, *args)
            # 9-plane layout with zero z planes: silhouettes never read z
            z = torch.zeros_like(coords[:, :1])
            fvm = torch.cat(
                [coords[:, 0:2], z, coords[:, 2:4], z, coords[:, 4:6], z], dim=1
            )
            attr_planes = fvm.new_empty((bs, 0) + fvm.shape[2:])
        ctx.mark_non_differentiable(index)
        ctx.save_for_backward(index)
        ctx.num_faces = nf
        ctx.latch_z = latch_z
        ctx.has_attrs = face_attrs is not None
        return index, fvm, attr_planes

    @staticmethod
    def backward(ctx, _grad_index, grad_fvm, grad_attrs):
        (index,) = ctx.saved_tensors
        nf = ctx.num_faces
        bs = index.shape[0]
        with trace.span("resolve.vjp", grad_fvm):
            if not ctx.latch_z:
                # the z planes are constant zeros in the forward: drop their
                # cotangents, scatter the six XY planes, and pad z back
                # the XY planes of the 9-plane map (plane = 3 * vertex + coord),
                # by slices: an index tuple would be copied from the host
                g6 = torch.cat([grad_fvm[:, 0:2], grad_fvm[:, 3:5], grad_fvm[:, 6:8]], 1)
                per_face = scatter_pixels_to_faces(g6, index, nf)     # [bs, 6, nf]
                gk = torch.nn.functional.pad(
                    per_face.reshape(bs, 3, 2, nf), (0, 0, 0, 1)
                )                                                     # [bs, k, coord, nf]
                return (gk.permute(0, 2, 1, 3),) + (None,) * 9
            # one scatter over coordinates and attributes: D = 9 + A
            g_all = torch.cat([grad_fvm, grad_attrs], 1) if ctx.has_attrs else grad_fvm
            per_face = scatter_pixels_to_faces(g_all.contiguous(), index, nf)
            g_faces = per_face[:, :9].reshape(bs, 3, 3, nf).permute(0, 2, 1, 3)
            g_attrs = per_face[:, 9:].permute(0, 2, 1) if ctx.has_attrs else None
            return (g_faces, g_attrs) + (None,) * 8


def resolve_and_gather(face_vertices, image_size, near, far, draw_backside,
                       face_attrs=None, latch_z=False, row_start=0, num_rows=None,
                       mode="auto"):
    """Z-buffer resolve of planar NDC face vertices [bs, 3, 3, nf] with the
    winner's data latched, over the image rows ``row_start .. row_start +
    num_rows`` (all S by default).

    ``latch_z=False`` latches the winner's XY coordinates only (the
    silhouette path); ``latch_z=True`` its nine coordinates and the
    per-face attributes ``face_attrs`` [bs, nf, A] (the RGB and depth
    paths).  The route ``resolve_cuda.resolve_route`` picks (``mode``
    "auto", or forced "tiled" / "binned"; both give the same bits): K2 or
    K2L, or K7 and K8's ``resolve_binned_xy`` or ``resolve_binned_latch``
    (over 8x8 tiles, ``resolve_cuda.BIN_TILE``); each computes the face
    constants itself (no K1).

    Returns (face_index_map i32 [bs, rows, S], -1 on background and not
    differentiable; fvm_planar f32 [bs, 9, rows, S], the winner's vertex
    coordinates, plane 3 * vertex + coord, with zero z planes unless
    ``latch_z``; attr_planes f32 [bs, A, rows, S] or None), 0 on
    background.  The gradients of ``fvm_planar`` and ``attr_planes`` flow
    back into the face vertices and ``face_attrs`` through one kernel K3
    call.
    """
    with trace.span("resolve", face_vertices):
        index, fvm, attr_planes = _ResolveAndGather.apply(
            face_vertices, face_attrs, image_size, near, far, draw_backside, latch_z,
            row_start, num_rows, mode,
        )
    return index, fvm, (attr_planes if face_attrs is not None else None)


def compute_face_index_map(faces, image_size, near=0.1, far=100.0, draw_backside=True, *,
                           row_start=0, num_rows=None, return_depth=False, mode="auto"):
    """Per-pixel z-buffered visible-face id for [bs, nf, 3, 3] NDC faces over
    the image rows ``row_start .. row_start + num_rows`` (the whole image by
    default): int32 [bs, num_rows, S], -1 on background; ``(index, depth)``
    when ``return_depth``, depth ``far`` on background.  Non-differentiable
    (integer output).

    The id/depth form of the route ``resolve_route`` picks (``mode`` as in
    :func:`resolve_and_gather`): K2D, or K7 and K8's
    ``resolve_binned_depth``.  The JAX signature's ``face_chunk`` tuning
    knob has no counterpart, so the arguments after ``draw_backside`` are
    keyword-only.

    On the card it replays a forward graph per :func:`index_map_signature`
    (``jax.jit`` with these arguments static, in the JAX package),
    captured at the signature's second call as a render's is
    (``ops/graphs.py``); on the binned route its K7 is capped at twice the
    pair total of the signature's last eager call.  Inside a capture, or a
    graph's warm-up (the sharded entry's face fold), it runs inline: a
    binned one there takes its capacity from the last eager call of the
    same binning (kept on the render's faces record, or on
    ``graphs.INDEX_MAPS`` outside a render)."""
    static = index_map_static(faces, image_size, near, far, draw_backside, row_start, num_rows,
                              mode)
    how = route(faces, None, None)
    label = (f"compute_face_index_map bs={faces.shape[0]} nf={faces.shape[1]} "
             f"image {image_size} rows {row_start}+{num_rows}")
    graph = None
    if how == "eager":
        note_eager("compute_face_index_map (CPU tensors, eager() or plain_versions)", label)
    elif how == "graph":
        graph = cached_graph(
            INDEX_MAPS, index_map_signature(faces, static),
            lambda min_capacity=0: Graph(lambda f: _index_map(f, *static), [faces], False,
                                         label, INDEX_MAPS, min_capacity),
            label)
    index, depth = _index_map(faces, *static) if graph is None else graph(faces)
    return (index, depth) if return_depth else index


def index_map_static(faces, image_size, near, far, draw_backside, row_start, num_rows, mode):
    """:func:`compute_face_index_map`'s arguments as the graph holds them:
    (image size, near, far, draw_backside, row_start, num_rows, route),
    the route the one ``resolve_route`` picks for ``mode`` and the shapes
    (a forced route among them)."""
    rows = image_size if num_rows is None else num_rows
    return (int(image_size), float(near), float(far), bool(draw_backside), int(row_start),
            None if num_rows is None else int(num_rows),
            resolve_route(faces.shape[0], rows, image_size, faces.shape[1], mode))


def index_map_signature(faces, static):
    """The key of a :func:`compute_face_index_map` graph: the input's
    shape, strides, dtype and device and :func:`index_map_static`'s
    arguments."""
    return ("compute_face_index_map", tuple(faces.shape), faces.stride(), faces.dtype,
            faces.device, static)


def _index_map(faces, image_size, near, far, draw_backside, row_start, num_rows, mode):
    """(index, depth) of [bs, nf, 3, 3] face vertices on the route ``mode``."""
    fvp = faces.detach().permute(0, 3, 2, 1).contiguous()
    args = (image_size, near, far, row_start, num_rows)
    bins = _binned_inputs(fvp, draw_backside, image_size, row_start, num_rows, mode)
    if bins is not None:
        return resolve_binned_depth(fvp, draw_backside, bins, *args)
    return resolve_depth(fvp, draw_backside, *args)
