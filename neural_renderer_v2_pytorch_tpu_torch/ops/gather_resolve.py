"""The face-vertex gather and the resolve with winner latch, as autograd
Functions (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
gather_resolve.py``, on its planar path).

Both keep the JAX package's planar layouts: face vertices are
[bs, 3 (coord), 3 (vertex), nf] and maps are channel-planar [bs, C, H, W].
"""

from __future__ import annotations

import torch

from .resolve_cuda import (
    face_setup,
    gather_faces3,
    resolve_latch,
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
        return gather_faces3(vertices.detach().contiguous(), faces)

    @staticmethod
    def backward(ctx, grad):
        (faces,) = ctx.saved_tensors
        g = scatter_faces_to_vertices(grad.contiguous(), faces, ctx.num_vertices)
        return g, None


def gather_face_vertices(vertices, faces):
    """``vertices[:, faces]`` in the planar layout: [bs, nv, 3] float32 and
    [nf, 3] int32 -> [bs, 3, 3, nf].  The forward is kernel K5 (the JAX
    package's ``gather_faces3_pallas``), the backward kernel K4."""
    return _GatherFaceVertices.apply(vertices, faces)


class _ResolveAndGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_vertices, face_attrs, image_size, near, far,
                draw_backside, latch_z):
        fvp = face_vertices.detach().contiguous()
        bs, nf = fvp.shape[0], fvp.shape[-1]
        consts = face_setup(fvp, draw_backside)
        if latch_z:
            attrs = (fvp.new_empty((bs, nf, 0)) if face_attrs is None
                     else face_attrs.detach().contiguous())
            index, _, fvm, attr_planes = resolve_latch(
                consts, fvp, attrs, image_size, near, far
            )
        else:
            if face_attrs is not None:
                raise ValueError("attribute planes need latch_z=True")
            index, _, coords = resolve_xy(consts, fvp, image_size, near, far)
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
        if not ctx.latch_z:
            # the z planes are constant zeros in the forward: drop their
            # cotangents, scatter the six XY planes, and pad z back
            g6 = grad_fvm[:, _XY_PLANES].contiguous()
            per_face = scatter_pixels_to_faces(g6, index, nf)     # [bs, 6, nf]
            gk = torch.nn.functional.pad(
                per_face.reshape(bs, 3, 2, nf), (0, 0, 0, 1)
            )                                                     # [bs, k, coord, nf]
            return gk.permute(0, 2, 1, 3), None, None, None, None, None, None
        # one scatter over coordinates and attributes: D = 9 + A
        g_all = torch.cat([grad_fvm, grad_attrs], 1) if ctx.has_attrs else grad_fvm
        per_face = scatter_pixels_to_faces(g_all.contiguous(), index, nf)
        g_faces = per_face[:, :9].reshape(bs, 3, 3, nf).permute(0, 2, 1, 3)
        g_attrs = per_face[:, 9:].permute(0, 2, 1) if ctx.has_attrs else None
        return g_faces, g_attrs, None, None, None, None, None


def resolve_and_gather(face_vertices, image_size, near, far, draw_backside,
                       face_attrs=None, latch_z=False):
    """Z-buffer resolve of planar NDC face vertices [bs, 3, 3, nf] with the
    winner's data latched.

    ``latch_z=False`` latches the winner's XY coordinates only (kernels
    K1 + K2; the silhouette path); ``latch_z=True`` its nine coordinates
    and the per-face attributes ``face_attrs`` [bs, nf, A] (kernels
    K1 + K2L; the RGB and depth paths).

    Returns (face_index_map i32 [bs, S, S], -1 on background and not
    differentiable; fvm_planar f32 [bs, 9, S, S], the winner's vertex
    coordinates, plane 3 * vertex + coord, with zero z planes unless
    ``latch_z``; attr_planes f32 [bs, A, S, S] or None), 0 on background.
    The gradients of ``fvm_planar`` and ``attr_planes`` flow back into the
    face vertices and ``face_attrs`` through one kernel K3 call.
    """
    index, fvm, attr_planes = _ResolveAndGather.apply(
        face_vertices, face_attrs, image_size, near, far, draw_backside, latch_z
    )
    return index, fvm, (attr_planes if face_attrs is not None else None)
