"""Channel-planar shading maps (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/shading.py``; the silhouette path needs
only the coordinate map)."""

from __future__ import annotations

import torch


def coordinate_planes(fvm_planar, weight_planes):
    """Barycentric screen-XY map [bs, 2, H, W] from latched winner
    coordinates [bs, 9, H, W] and weights [bs, 3, H, W].  The NMR backward
    reaches the vertices only through this map (the weights are a stopped
    constant)."""
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    cx = fvm_planar[:, 0] * w0 + fvm_planar[:, 3] * w1 + fvm_planar[:, 6] * w2
    cy = fvm_planar[:, 1] * w0 + fvm_planar[:, 4] * w1 + fvm_planar[:, 7] * w2
    return torch.stack((cx, cy), dim=1)
