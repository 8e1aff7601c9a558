"""The face-vertex gather and the resolve with winner latch, as autograd
Functions (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
gather_resolve.py``, on its planar, XY-latch path).

Both keep the JAX package's planar layouts: face vertices are
[bs, 3 (coord), 3 (vertex), nf] and maps are channel-planar [bs, C, H, W].
"""

from __future__ import annotations

import torch

from .resolve_cuda import (
    face_setup,
    resolve_xy,
    scatter_faces_to_vertices,
    scatter_pixels_to_faces,
)

# the XY planes of the 9-plane latched map (plane = 3 * vertex + coord)
_XY_PLANES = (0, 1, 3, 4, 6, 7)


class _GatherFaceVertices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vertices, faces):
        ctx.save_for_backward(faces)
        ctx.num_vertices = vertices.shape[1]
        # [bs, nf, vertex, coord] -> [bs, coord, vertex, nf]
        return vertices[:, faces.long()].permute(0, 3, 2, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        (faces,) = ctx.saved_tensors
        g = scatter_faces_to_vertices(grad.contiguous(), faces, ctx.num_vertices)
        return g, None


def gather_face_vertices(vertices, faces):
    """``vertices[:, faces]`` in the planar layout: [bs, nv, 3] float32 and
    [nf, 3] int32 -> [bs, 3, 3, nf].  The forward is plain indexing (the
    JAX package's ``jnp.take``); the backward is kernel K4."""
    return _GatherFaceVertices.apply(vertices, faces)


class _ResolveAndGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_vertices, image_size, near, far, draw_backside):
        fvp = face_vertices.detach().contiguous()
        consts = face_setup(fvp, draw_backside)
        index, _, coords = resolve_xy(consts, fvp, image_size, near, far)
        # 9-plane layout with zero z planes: silhouettes never read z
        z = torch.zeros_like(coords[:, :1])
        fvm = torch.cat(
            [coords[:, 0:2], z, coords[:, 2:4], z, coords[:, 4:6], z], dim=1
        )
        ctx.mark_non_differentiable(index)
        ctx.save_for_backward(index)
        ctx.num_faces = face_vertices.shape[-1]
        return index, fvm

    @staticmethod
    def backward(ctx, _grad_index, grad_fvm):
        (index,) = ctx.saved_tensors
        nf = ctx.num_faces
        bs = index.shape[0]
        # the z planes are constant zeros in the forward: drop their
        # cotangents, scatter the six XY planes, and pad z back
        g6 = grad_fvm[:, _XY_PLANES].contiguous()
        per_face = scatter_pixels_to_faces(g6, index, nf)         # [bs, 6, nf]
        gk = torch.nn.functional.pad(
            per_face.reshape(bs, 3, 2, nf), (0, 0, 0, 1)
        )                                                         # [bs, k, coord, nf]
        return gk.permute(0, 2, 1, 3), None, None, None, None


def resolve_and_gather(face_vertices, image_size, near, far, draw_backside):
    """Z-buffer resolve of planar NDC face vertices [bs, 3, 3, nf] with the
    winner's XY coordinates latched.

    Returns (face_index_map i32 [bs, S, S], -1 on background and not
    differentiable; fvm_planar f32 [bs, 9, S, S], the winner's vertex
    coordinates with zero z planes, 0 on background).  The forward is
    kernels K1 + K2; the gradient of ``fvm_planar`` flows back into the
    face vertices' x and y through kernel K3.
    """
    return _ResolveAndGather.apply(
        face_vertices, image_size, near, far, draw_backside
    )
