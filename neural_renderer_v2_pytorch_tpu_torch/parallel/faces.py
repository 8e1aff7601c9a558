"""Face-sharded z-resolve (counterpart of ``neural_renderer_v2_pytorch_tpu/
parallel/faces.py``): each rank of a process group resolves a contiguous
range of the faces, and the per-pixel (depth, id) winners fold across the
group in face order.

The reference's accept rule, ``z <= depth_min - 1e-4`` in face order, is
not associative, but any sequential winner lies within ``[z_min, z_min +
1e-4)``, so folding the ranks' winners in ascending face order with the
same rule gives the sequential result exactly, unless two faces of
different ranks fall within 1e-4 of each other at one pixel; even then the
depth is within 1e-4 of the sequential one.

Cost: two all-gathers (depth f32, id i32) of the rank's pixel band over the
group, then an n-step elementwise fold; the resolve of nf / n faces
dominates.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.gather_resolve import compute_face_index_map
from ..ops.resolve import DEPTH_MIN_DELTA
from .collectives import run


def ordered_z_combine(depth_index_pairs):
    """Fold per-rank (depth, index) maps in rank order with the reference's
    tolerance rule.  ``depth_index_pairs`` is (depths [n, ...] float32,
    indices [n, ...] int32), rank-major in ascending face order.  Returns
    (depth, index)."""
    depths, indices = depth_index_pairs
    d, i = depths[0], indices[0]
    for d2, i2 in zip(depths[1:], indices[1:]):
        accept = d2 <= d - DEPTH_MIN_DELTA
        d = torch.where(accept, d2, d)
        i = torch.where(accept, i2, i)
    return d, i


def face_sharded_steps(face_vertices, image_size, near=0.1, far=100.0, draw_backside=True, *,
                       row_start=0, num_rows=None, group=None, return_depth=False):
    """:func:`compute_face_index_map_face_sharded` as a generator that
    yields its two all-gathers (``parallel.collectives.run``): the rank's
    resolve before them, the fold after, so that a compiled core captures
    each side in a graph of its own."""
    per = -(-face_vertices.shape[1] // dist.get_world_size(group))
    start = dist.get_rank(group) * per
    local = face_vertices.detach()[:, start:start + per]
    if local.shape[1] < per:
        local = torch.nn.functional.pad(local, (0, 0, 0, 0, 0, per - local.shape[1]))
    index, depth = compute_face_index_map(local, image_size, near, far, draw_backside,
                                          row_start=row_start, num_rows=num_rows,
                                          return_depth=True)
    index = torch.where(index >= 0, index + start, -1)
    depths, indices = yield [(depth, group, "face_all_gather"), (index, group, "face_all_gather")]
    depth, index = ordered_z_combine((depths, indices))
    return (index, depth) if return_depth else index


def compute_face_index_map_face_sharded(face_vertices, image_size, near=0.1, far=100.0,
                                        draw_backside=True, *, row_start=0, num_rows=None,
                                        group=None, return_depth=False):
    """Per-pixel z-buffered visible-face id over the image rows ``row_start
    .. row_start + num_rows`` (all by default), its face loop sharded over
    the ranks of ``group`` (the default process group when None).

    Every rank passes the same full face set [bs, nf, 3, 3] (NDC) and
    resolves its contiguous range of ``ceil(nf / n)`` faces, the last range
    padded with zero faces (degenerate, so the kill rule drops them) as the
    JAX package pads, through :func:`compute_face_index_map` (K2D, or K7
    and K8's id/depth form; a graph of its own on the card).  The ranks'
    maps are all-gathered and folded with :func:`ordered_z_combine`.
    Returns the combined int32 map [bs, num_rows, S] of global face ids,
    the same on every rank, and with ``return_depth`` its depth too.
    Non-differentiable."""
    return run(face_sharded_steps(face_vertices, image_size, near, far, draw_backside,
                                  row_start=row_start, num_rows=num_rows, group=group,
                                  return_depth=return_depth))
