"""Camera transforms (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/camera.py``).

``look_at``, ``look`` and ``perspective`` follow the reference conventions
exactly:
``perspective`` divides x, y by ``z * tan(angle)`` and keeps z, and converts
degrees with the reference's literal 3.1416.  All math is elementwise
float32 (no matmul, so no TF32 path can touch it).
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import graphs


def _normalize(x, eps=1e-12):
    """L2-normalize along the last dim (same semantics as F.normalize)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _on_device(v, device):
    """``v`` (a tensor, or host numbers) as float32 on ``device``; host
    numbers through ``graphs.constant``, so that a step captured in a CUDA
    graph can hold its camera."""
    if isinstance(v, torch.Tensor):
        return v.to(device, torch.float32)
    return graphs.constant(v, device)


def _as_batched(v, batch_size, device):
    v = _on_device(v, device)
    if v.ndim == 1:
        v = v[None, :].expand(batch_size, v.shape[0])
    return v


def _rotate(vertices, r):
    """``vertices @ r^T`` as elementwise f32 multiply-adds ([bs, nv, 3] x
    [bs, 3, 3])."""
    x, y, z = vertices[..., 0], vertices[..., 1], vertices[..., 2]
    r = r[:, :, None, :]                                      # [bs, 3, 1, 3]
    out = [
        x * r[:, i, :, 0] + y * r[:, i, :, 1] + z * r[:, i, :, 2]
        for i in range(3)
    ]
    return torch.stack(out, dim=-1)


def look_at(vertices, viewpoints, at=None, up=None):
    """'Look at' transformation of [bs, nv, 3] vertices.

    ``viewpoints``, ``at`` and ``up`` are [3] or [bs, 3] (sequences or
    tensors); they are placed on the vertices' device.  Returns [bs, nv, 3]
    camera-space vertices ``(v - eye) @ R^T`` with R's rows the camera axes.
    """
    if vertices.ndim != 3:
        raise ValueError(f"vertices must be [bs, nv, 3], got {tuple(vertices.shape)}")
    batch_size, device = vertices.shape[0], vertices.device
    if at is None:
        at = (0.0, 0.0, 0.0)
    if up is None:
        up = (0.0, 1.0, 0.0)

    with trace.span("camera", vertices):
        viewpoints = _as_batched(viewpoints, batch_size, device)
        at = _as_batched(at, batch_size, device)
        up = _as_batched(up, batch_size, device)

        z_axis = _normalize(at - viewpoints)                    # [bs, 3]
        x_axis = _normalize(torch.cross(up, z_axis, dim=-1))
        y_axis = _normalize(torch.cross(z_axis, x_axis, dim=-1))
        r = torch.stack((x_axis, y_axis, z_axis), dim=1)        # [bs, 3, 3]
        out = _rotate(vertices - viewpoints[:, None, :], r)
    trace.vjp("camera.vjp", out, [vertices, viewpoints, at, up])
    return out


def look(vertices, viewpoints, direction=None, up=None):
    """'Look' transformation of [bs, nv, 3] vertices: the camera at
    ``viewpoints`` gazes along ``direction`` (default +z) instead of at a
    point.  ``viewpoints``, ``direction`` and ``up`` (default +y) are [3] or
    [bs, 3], placed on the vertices' device.  The intended semantics of the
    reference's look.py:5-41, as the JAX package implements them (the
    reference transposes batched inputs by mistake; PARITY.md row 14)."""
    if vertices.ndim != 3:
        raise ValueError(f"vertices must be [bs, nv, 3], got {tuple(vertices.shape)}")
    batch_size, device = vertices.shape[0], vertices.device
    if direction is None:
        direction = (0.0, 0.0, 1.0)
    if up is None:
        up = (0.0, 1.0, 0.0)

    with trace.span("camera", vertices):
        viewpoints = _as_batched(viewpoints, batch_size, device)
        direction = _as_batched(direction, batch_size, device)
        up = _as_batched(up, batch_size, device)

        z_axis = _normalize(direction)
        x_axis = _normalize(torch.cross(up, z_axis, dim=-1))
        y_axis = _normalize(torch.cross(z_axis, x_axis, dim=-1))
        r = torch.stack((x_axis, y_axis, z_axis), dim=1)        # [bs, 3, 3]
        out = _rotate(vertices - viewpoints[:, None, :], r)
    trace.vjp("camera.vjp", out, [vertices, viewpoints, direction, up])
    return out


def perspective(vertices, angle=30.0):
    """Perspective divide ``x, y <- x / (z tan(angle)), y / (z tan(angle))``
    keeping z; ``angle`` in degrees, a python scalar or a [bs] tensor."""
    if vertices.ndim != 3:
        raise ValueError(f"vertices must be [bs, nv, 3], got {tuple(vertices.shape)}")
    with trace.span("camera", vertices):
        angle = _on_device(angle, vertices.device)
        # the reference's literal 3.1416 (not pi): golden renders depend on it
        width = torch.tan(angle / 180.0 * 3.1416)
        width = torch.atleast_1d(width)[:, None].expand(vertices.shape[:2])
        z = vertices[:, :, 2]
        x = vertices[:, :, 0] / z / width
        y = vertices[:, :, 1] / z / width
        out = torch.stack((x, y, z), dim=2)
    trace.vjp("camera.vjp", out, [vertices, angle])
    return out
