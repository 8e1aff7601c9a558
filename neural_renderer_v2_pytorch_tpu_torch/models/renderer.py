"""``Renderer``: camera + rendering state over the functional pipeline
(counterpart of ``neural_renderer_v2_pytorch_tpu/models/renderer.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.camera import look, look_at, perspective
from ..ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize_depth,
    rasterize_rgb,
    rasterize_rgba,
    rasterize_silhouettes,
)


class Renderer(nn.Module):
    """Holds the reference renderer's attributes and renders on ``device``:
    the current card by default, as ``Renderer()`` is called in the JAX
    package; pass ``"cpu"`` for the plain versions of the kernels.

    Inputs must already lie on ``device``; ``faces`` may be any integer
    array-like and is moved there (:meth:`faces_on_device`).
    ``viewpoints`` (and, with ``camera_mode="look"``, ``camera_direction``)
    may be a tensor, e.g. one that requires grad, to optimise the camera."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        # rendering
        self.image_size = 256
        self.anti_aliasing = True
        self.draw_backside = True
        self.background_color = None
        # camera
        self.perspective = True
        self.viewing_angle = 30
        self.viewpoints = [0, 0, -(1.0 / math.tan(math.radians(self.viewing_angle)) + 1)]
        self.camera_mode = "look_at"
        self.camera_direction = [0, 0, 1]
        self.near = 0.1
        self.far = 100
        # the create_textures texel size, for its per-face patch sampling;
        # None for any other (loaded) atlas
        self.texture_size = None
        # (the ids of the last array-like faces, their tensor on device)
        self._kept_faces = None

    def faces_on_device(self, faces):
        """``faces`` [nf, 3] as an int32 tensor on ``device``.

        The gradient's vertex sum (kernel K4) keeps one vertex -> slot table
        per faces tensor, so a fit should hand it the same tensor every
        step.  An int32 tensor on ``device`` is that tensor.  An array-like
        (a numpy array, as the JAX package's ``Renderer`` is called, or
        lists) is copied to ``device`` once, and the copy is kept while the
        same ids come back (compared on the host: an in-place edit of the
        array makes a new copy).  A tensor of another dtype or device is
        converted at every call, and each conversion builds its table."""
        if isinstance(faces, torch.Tensor):
            return faces.to(self.device, torch.int32)
        ids = np.asarray(faces, dtype=np.int32)
        if self._kept_faces is None or not np.array_equal(self._kept_faces[0], ids):
            self._kept_faces = (ids.copy(), torch.tensor(ids, device=self.device))
        return self._kept_faces[1]

    def _check_device(self, t):
        # "cuda" names whichever card is current, so it accepts any index
        if t.device.type != self.device.type or (
            self.device.index is not None and t.device.index != self.device.index
        ):
            raise ValueError(f"input on {t.device}, renderer on {self.device}")

    def transform_vertices(self, vertices):
        """Viewpoint + perspective transform (reference renderer.py:24-35)."""
        self._check_device(vertices)
        if self.camera_mode == "look_at":
            vertices = look_at(vertices, self.viewpoints)
        elif self.camera_mode == "look":
            vertices = look(vertices, self.viewpoints, self.camera_direction)
        else:
            raise ValueError(f"unknown camera_mode {self.camera_mode!r}")
        if self.perspective:
            vertices = perspective(vertices, angle=self.viewing_angle)
        return vertices

    def _hyperparams(self):
        return RasterizeHyperparam(
            image_size=self.image_size,
            near=self.near,
            far=self.far,
            anti_aliasing=self.anti_aliasing,
            draw_backside=self.draw_backside,
        )

    def render_silhouettes(self, vertices, faces, backgrounds=None):
        """Silhouettes [bs, H, W] of world-space ``vertices`` [bs, nv, 3]."""
        vertices = self.transform_vertices(vertices)
        faces = self.faces_on_device(faces)
        params = RasterizeParam(
            background_color=self.background_color, backgrounds=backgrounds
        )
        return rasterize_silhouettes(vertices, faces, params, self._hyperparams())

    def _textured_params(self, vertices_t, faces_t, textures, backgrounds, lights):
        return RasterizeParam(
            vertices_textures=vertices_t,
            faces_textures=torch.as_tensor(faces_t, dtype=torch.int32, device=self.device),
            textures=textures,
            background_color=self.background_color,
            texture_size=self.texture_size,
            backgrounds=backgrounds,
            lights=tuple(lights) if lights is not None else None,
        )

    def render(self, vertices, faces, vertices_t, faces_t, textures, backgrounds=None,
               lights=None):
        """RGBA [bs, 4, H, W] of world-space ``vertices`` [bs, nv, 3], with
        texel coordinates ``vertices_t`` [bs, nvt, 2], ``faces_t`` [nf, 3],
        atlas ``textures`` [bs, 3, th, tw] and optional ``lights``."""
        vertices = self.transform_vertices(vertices)
        faces = self.faces_on_device(faces)
        params = self._textured_params(vertices_t, faces_t, textures, backgrounds, lights)
        return rasterize_rgba(vertices, faces, params, self._hyperparams())

    def render_rgb(self, vertices, faces, vertices_t, faces_t, textures, backgrounds=None,
                   lights=None):
        """RGB [bs, 3, H, W]; arguments as :meth:`render`."""
        vertices = self.transform_vertices(vertices)
        faces = self.faces_on_device(faces)
        params = self._textured_params(vertices_t, faces_t, textures, backgrounds, lights)
        return rasterize_rgb(vertices, faces, params, self._hyperparams())

    def render_depth(self, vertices, faces, backgrounds=None):
        """Depth [bs, H, W] of world-space ``vertices``, 0 on background."""
        vertices = self.transform_vertices(vertices)
        faces = self.faces_on_device(faces)
        params = RasterizeParam(
            background_color=self.background_color, backgrounds=backgrounds
        )
        return rasterize_depth(vertices, faces, params, self._hyperparams())
