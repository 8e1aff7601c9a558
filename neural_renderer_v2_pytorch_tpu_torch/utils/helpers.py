"""Spherical camera placement (counterpart of
``neural_renderer_v2_pytorch_tpu/utils/helpers.py:102-133``)."""

from __future__ import annotations

import numpy as np
import torch


def get_points_from_angles(distance, elevation, azimuth, degrees=True):
    """Spherical -> cartesian camera position.

    Python-scalar inputs return a plain float tuple; tensor inputs return a
    differentiable [..., 3] float32 tensor on the device of the first tensor
    argument.  The tensor branch keeps the reference's low-precision
    degree/radian constant (3.14159265359/180).
    """
    args = (distance, elevation, azimuth)
    if all(isinstance(a, (float, int)) for a in args):
        if degrees:
            elevation = np.radians(elevation)
            azimuth = np.radians(azimuth)
        return (
            distance * np.cos(elevation) * np.sin(azimuth),
            distance * np.sin(elevation),
            -distance * np.cos(elevation) * np.cos(azimuth),
        )
    devices = [a.device for a in args if isinstance(a, torch.Tensor)]
    if not devices:
        raise TypeError("pass python numbers, or at least one tensor to fix the device")
    device = devices[0]
    distance, elevation, azimuth = (
        torch.as_tensor(a, dtype=torch.float32, device=device) for a in args
    )
    if degrees:
        elevation = elevation / 180.0 * 3.14159265359
        azimuth = azimuth / 180.0 * 3.14159265359
    return torch.stack(
        [
            distance * torch.cos(elevation) * torch.sin(azimuth),
            distance * torch.sin(elevation),
            -distance * torch.cos(elevation) * torch.cos(azimuth),
        ],
        dim=-1,
    )
