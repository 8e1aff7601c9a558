"""Per-pixel gather of per-face data, the foreground mask and the cross
product (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/maps.py``)."""

from __future__ import annotations

import torch

from .gather_resolve import gather_table_rows


def to_map(data_in, indices):
    """Gather per-face data [bs, n, ...] onto an index map [bs, H, W]
    (negative = background).  Returns [bs, H, W, ...], 0 on background;
    differentiable with respect to ``data_in``.  Kernel K9
    (``resolve_cuda.gather_rows``, row layout) forward and K3 backward on
    CUDA tensors (float32 only); their plain versions on CPU ones."""
    bs, n = data_in.shape[:2]
    ids = indices.reshape(bs, -1).to(torch.int32).contiguous()
    out = gather_table_rows(data_in.reshape(bs, n, -1), ids)
    return out.reshape(indices.shape + data_in.shape[2:])


def mask_foreground(data, face_index_map):
    """Zero ``data`` [bs, H, W, ...] on background pixels (face index < 0);
    the gradient passes on the foreground and is 0 on the background."""
    mask = face_index_map >= 0
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    return torch.where(mask, data, 0.0)


def cross(a, b, dim=-1):
    """Cross product of 3-vectors along ``dim``, with ``jnp.cross``'s
    expressions (so the rounding is the JAX package's)."""
    a0, a1, a2 = a.unbind(dim)
    b0, b1, b2 = b.unbind(dim)
    return torch.stack((a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim)
