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
arithmetic are the reference's exactly.  On the card the backward's
coordinate gradient is one kernel, K12 (``resolve_cuda.
nmr_coordinate_grad``); the operations here are its plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from .resolve_cuda import nmr_coordinate_grad


def maximum(data_right, data_left, eps=1e-4):
    """0 where max(r, l) <= 0 or |r - l| < eps, else -r if r > l, else l."""
    zero = (torch.maximum(data_right, data_left) <= 0) | (
        torch.abs(data_right - data_left) < eps
    )
    picked = torch.where(data_right > data_left, -data_right, data_left)
    return torch.where(zero, 0.0, picked)


def _pair_terms(I, G, dim, step):
    """(grad_r, grad_l) of each pair of neighbours along ``dim`` (2: rows,
    3: columns) of images ``I`` and grad ``G`` [bs, C, H, W], summed over
    the channels: one entry fewer than ``I`` along ``dim``."""
    n = I.shape[dim] - 1
    I0, I1 = I.narrow(dim, 0, n), I.narrow(dim, 1, n)
    G0, G1 = G.narrow(dim, 0, n), G.narrow(dim, 1, n)
    return (-torch.sum((I0 - I1) * G1, dim=1) / step,
            -torch.sum((I1 - I0) * G0, dim=1) / step)


def band_coordinate_grad(images, grad_output, above, below, render_size):
    """Rows ``r0 .. r0 + rows - 1`` of the coordinate-map gradient of a
    ``render_size``-row image, from those rows of the images and of the
    incoming gradient [bs, C, rows, W] (rows > 0) and the rows just outside
    them: ``above`` and ``below`` are (images, grad) rows [bs, C, 1, W], or
    None at the image's top or bottom edge, where the whole image's pair
    terms pad with zeros.  Returns [bs, 2, rows, W] (x on channel 0, y on
    channel 1): the same bits as those rows of the whole image's.  On the
    card one kernel K12 launch (``resolve_cuda.nmr_coordinate_grad``), else
    :func:`band_coordinate_grad_plain`."""
    with trace.span("nmr.grad", images):
        return nmr_coordinate_grad(images, grad_output, above, below, render_size)


def band_coordinate_grad_plain(images, grad_output, above, below, render_size):
    """:func:`band_coordinate_grad` in PyTorch's operations, its y and x
    passes each in a span of its own (``nmr.grad.y``, ``nmr.grad.x``)."""
    # a tensor divisor: on CUDA, dividing by a Python scalar multiplies
    # by its reciprocal, which is inexact unless the image size is a
    # power of 2.  Filled on the device (a captured step copies nothing
    # from the host), the same double rounded to the same float32 as
    # torch.tensor
    step = torch.full((), 2.0 / render_size, dtype=images.dtype, device=images.device)
    with trace.span("nmr.grad.y", images):
        I, G = images, grad_output
        if above is not None:
            I, G = torch.cat([above[0], I], 2), torch.cat([above[1], G], 2)
        if below is not None:
            I, G = torch.cat([I, below[0]], 2), torch.cat([G, below[1]], 2)

        # y (rows): entry k of the padded pair terms joins band rows k - 1
        # and k; a pair past the image edge is the zero pad
        gyr, gyl = (F.pad(g, (0, 0, int(above is None), int(below is None)))
                    for g in _pair_terms(I, G, 2, step))
        grad_y = maximum(gyr[:, 1:] + gyr[:, :-1], gyl[:, :-1] + gyl[:, 1:])

    # x (columns): row-local
    with trace.span("nmr.grad.x", images):
        gxr, gxl = _pair_terms(images, grad_output, 3, step)
        grad_x = maximum(F.pad(gxr, (0, 1)) + F.pad(gxr, (1, 0)),
                         F.pad(gxl, (1, 0)) + F.pad(gxl, (0, 1)))

    return torch.stack((grad_x, grad_y), dim=1)


def _coordinate_grad(images, grad_output):
    """Gradient of the coordinate map: images and grad [bs, C, H, W] ->
    [bs, 2, H, W] (x on channel 0, y on channel 1)."""
    return band_coordinate_grad(images, grad_output, None, None, images.shape[2])


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
