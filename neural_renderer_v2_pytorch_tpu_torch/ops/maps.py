"""Per-pixel gather of per-face data (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/maps.py:24``)."""

from __future__ import annotations

import torch


def to_map(data_in, indices):
    """Gather per-face data [bs, n, ...] onto an index map [bs, H, W]
    (negative = background).  Returns [bs, H, W, ...], 0 on background;
    differentiable with respect to ``data_in``."""
    bs, n = data_in.shape[:2]
    flat = data_in.reshape(bs, n, -1)
    safe = torch.clamp(indices, min=0).long().reshape(bs, -1, 1)
    gathered = torch.gather(flat, 1, safe.expand(-1, -1, flat.shape[2]))
    gathered = gathered.reshape(indices.shape + data_in.shape[2:])
    mask = (indices >= 0).reshape(indices.shape + (1,) * (data_in.ndim - 2))
    return torch.where(mask, gathered, 0.0)
