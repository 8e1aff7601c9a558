"""The NMR approximate-gradient op (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/differentiation.py``).

Forward is the identity on images.  Backward turns incoming pixel gradients
into gradients of the per-pixel screen coordinates from neighbouring-pixel
intensity differences; this is what carries image losses back to vertex
positions.  With step = 2/H and the sum over channels:

  grad_r[y] = -sum_c (I[y] - I[y+1]) * g[y+1] / step
  grad_l[y] = -sum_c (I[y+1] - I[y]) * g[y] / step
  grad = maximum(pad_right(grad_r) + pad_left(grad_r),
                 pad_left(grad_l) + pad_right(grad_l))

and the same along x.  The tie-break of :func:`maximum` and the pad
arithmetic are the reference's exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maximum(data_right, data_left, eps=1e-4):
    """0 where max(r, l) <= 0 or |r - l| < eps, else -r if r > l, else l."""
    zero = (torch.maximum(data_right, data_left) <= 0) | (
        torch.abs(data_right - data_left) < eps
    )
    picked = torch.where(data_right > data_left, -data_right, data_left)
    return torch.where(zero, 0.0, picked)


def _pad_shift(g, dim, side):
    """Pad one zero slice on ``side`` of ``dim`` (dim 1 or 2 of [bs, H, W])."""
    left, right = (1, 0) if side == "left" else (0, 1)
    pad = (left, right) if dim == 2 else (0, 0, left, right)
    return F.pad(g, pad)


def _coordinate_grad(images, grad_output):
    """Gradient of the coordinate map: images and grad [bs, C, H, W] ->
    [bs, 2, H, W] (x on channel 0, y on channel 1)."""
    # a tensor divisor: on CUDA, dividing by a Python scalar multiplies by
    # its reciprocal, which is inexact unless the image size is a power of 2
    step = torch.tensor(2.0 / images.shape[2], dtype=images.dtype, device=images.device)
    I, G = images, grad_output

    # y (rows; dim 2)
    gyr = -torch.sum((I[:, :, :-1] - I[:, :, 1:]) * G[:, :, 1:], dim=1) / step
    grad_y_r = _pad_shift(gyr, 1, "right") + _pad_shift(gyr, 1, "left")
    gyl = -torch.sum((I[:, :, 1:] - I[:, :, :-1]) * G[:, :, :-1], dim=1) / step
    grad_y_l = _pad_shift(gyl, 1, "left") + _pad_shift(gyl, 1, "right")
    grad_y = maximum(grad_y_r, grad_y_l)

    # x (columns; dim 3)
    gxr = -torch.sum((I[:, :, :, :-1] - I[:, :, :, 1:]) * G[:, :, :, 1:], dim=1) / step
    grad_x_r = _pad_shift(gxr, 2, "right") + _pad_shift(gxr, 2, "left")
    gxl = -torch.sum((I[:, :, :, 1:] - I[:, :, :, :-1]) * G[:, :, :, :-1], dim=1) / step
    grad_x_l = _pad_shift(gxl, 2, "left") + _pad_shift(gxl, 2, "right")
    grad_x = maximum(grad_x_r, grad_x_l)

    return torch.stack((grad_x, grad_y), dim=1)


class _Differentiation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, coordinates):
        ctx.save_for_backward(images)
        return images.view_as(images)

    @staticmethod
    def backward(ctx, grad):
        (images,) = ctx.saved_tensors
        return grad, _coordinate_grad(images, grad)


def differentiation(images, coordinates):
    """Identity on ``images`` [bs, C, H, W]; on the backward pass routes the
    approximate gradients into ``coordinates`` [bs, 2, H, W]."""
    return _Differentiation.apply(images, coordinates)
