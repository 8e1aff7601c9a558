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

    Inputs must already lie on ``device``; ``faces`` and ``faces_t`` may be
    any integer array-like and are moved there (:meth:`faces_on_device`).
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
        # role ("faces", "faces_t") -> (the last host ids, their tensor on
        # device)
        self._kept = {}

    def faces_on_device(self, faces):
        """``faces`` [nf, 3] as an integer tensor on ``device``.

        The rasterizer keeps one int32 copy, and so K4 one vertex -> slot
        table, per faces tensor, and the compiled core its graphs per faces
        content (``ops/graphs.py``), so a fit should hand the renderer the
        same faces every step.  A tensor on ``device`` is that tensor, of
        any integer dtype (the rasterizer converts it to int32 once).  Host
        faces (a numpy array, as the JAX package's ``Renderer`` is called,
        lists, or a tensor on another device) are copied to ``device`` as
        int32 once, and the copy is kept while the same ids come back
        (compared on the host: an in-place edit of the array makes a new
        copy)."""
        return self._kept_on_device("faces", faces)

    def _kept_on_device(self, role, ids):
        """The faces (or texel faces, by ``role``) ``ids`` on ``device``; see
        :meth:`faces_on_device`."""
        if isinstance(ids, torch.Tensor) and self._on_device(ids):
            return ids
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu()
        ids = np.asarray(ids, dtype=np.int32)
        kept = self._kept.get(role)
        if kept is None or not np.array_equal(kept[0], ids):
            kept = self._kept[role] = (ids.copy(), torch.tensor(ids, device=self.device))
        return kept[1]

    def _on_device(self, t):
        # "cuda" names whichever card is current, so it accepts any index
        return t.device.type == self.device.type and (
            self.device.index is None or t.device.index == self.device.index)

    def _check_device(self, t):
        if not self._on_device(t):
            raise ValueError(f"input on {t.device}, renderer on {self.device}")

    def transform_vertices(self, vertices, lights=None):
        """Viewpoint + perspective transform (reference renderer.py:24-35).
        Any ``camera_mode`` but ``"look_at"`` and ``"look"`` applies no
        viewpoint transform (camera-space vertices), and ``lights`` is not
        read, as in the JAX package."""
        self._check_device(vertices)
        if self.camera_mode == "look_at":
            vertices = look_at(vertices, self.viewpoints)
        elif self.camera_mode == "look":
            vertices = look(vertices, self.viewpoints, self.camera_direction)
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
            faces_textures=self._kept_on_device("faces_t", faces_t),
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
        vertices = self.transform_vertices(vertices, lights)
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
