"""Rasterization pipeline, silhouette path (counterpart of
``neural_renderer_v2_pytorch_tpu/ops/rasterize.py``).

  1. supersample 2x when anti-aliasing
  2. planar face vertices = vertices[:, faces]      (gather; K4 backward)
  3. z-buffer resolve with XY latch                 (K1 + K2; K3 backward)
  4. stopped barycentric weights, coordinate map
  5. silhouette = foreground mask
  6. NMR differentiation hook
  7. flip H and W, then the 2x2 anti-aliasing pool

All maps are channel-planar (NCHW).  RGB and depth rendering are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .differentiation import differentiation
from .gather_resolve import gather_face_vertices, resolve_and_gather
from .resolve import weight_planes_from_gathered
from .shading import coordinate_planes

DEFAULT_NEAR = 0.1
DEFAULT_FAR = 100.0
DEFAULT_IMAGE_SIZE = 256
DEFAULT_ANTI_ALIASING = True
DEFAULT_DRAW_BACKSIDE = True
DEFAULT_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class RasterizeHyperparam:
    """Static rendering configuration (reference rasterize_param.py:13-33)."""

    image_size: int = DEFAULT_IMAGE_SIZE
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    eps: float = DEFAULT_EPS
    anti_aliasing: bool = DEFAULT_ANTI_ALIASING
    draw_backside: bool = DEFAULT_DRAW_BACKSIDE
    draw_rgb: bool = True
    draw_silhouettes: bool = True
    draw_depth: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RasterizeParam:
    """Tensor inputs of the rasterizer (reference rasterize_param.py:36-50);
    the silhouette path reads only the background fields."""

    background_color: Optional[Any] = None
    backgrounds: Optional[torch.Tensor] = None          # [bs, 3, H, W]


def compute_channel_maps(vertices, faces, params, hp, render_size):
    """Resolve and build the maps at ``render_size``.  Returns (images
    [bs, 1, S, S] silhouette before the hook and flip, coordinate_map
    [bs, 2, S, S], foreground [bs, 1, S, S])."""
    if hp.draw_rgb or hp.draw_depth:
        raise NotImplementedError("only silhouette rendering is ported")
    if not hp.draw_silhouettes:
        raise ValueError("nothing to draw")
    face_vertices = gather_face_vertices(vertices, faces)       # [bs, 3, 3, nf]
    face_index_map, fvm_planar = resolve_and_gather(
        face_vertices, render_size, hp.near, hp.far, hp.draw_backside
    )
    weight_planes = weight_planes_from_gathered(fvm_planar, face_index_map, render_size)
    coordinate_map = coordinate_planes(fvm_planar, weight_planes)
    foreground = (face_index_map >= 0).to(torch.float32)[:, None]
    return foreground, coordinate_map, foreground


class _FlipPool(torch.autograd.Function):
    """Flip H and W, then the 2x2 anti-aliasing mean (rasterize.py:315-328);
    the backward is upsample-by-2 of the flipped, quartered gradient."""

    @staticmethod
    def forward(ctx, images):
        pooled = (
            images[:, :, 0::2, 0::2] + images[:, :, 0::2, 1::2]
            + images[:, :, 1::2, 0::2] + images[:, :, 1::2, 1::2]
        ) * 0.25
        return pooled.flip(2, 3)

    @staticmethod
    def backward(ctx, grad):
        g = grad.flip(2, 3) * 0.25
        return g.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _flip_pool(images):
    return _FlipPool.apply(images)


def finalize_images(images, coordinate_map, foreground, backgrounds, hp):
    """Background blend -> NMR differentiation hook -> flip -> AA pool."""
    if backgrounds is not None and hp.draw_rgb:
        # backgrounds are pre-flipped because the merged image is flipped below
        bg = backgrounds.flip(2, 3)
        rgb = foreground * images[:, :3] + (1.0 - foreground) * bg
        images = torch.cat([rgb, images[:, 3:]], dim=1)
    images = differentiation(images, coordinate_map)
    if hp.anti_aliasing:
        return _flip_pool(images)
    return images.flip(2, 3)


def make_backgrounds(params, batch_size, render_size, device):
    """The background plane [bs, 3, S, S], or None.  ``background_color``
    renders the real colour (a deliberate departure from the reference,
    whose ``zeros * color`` always gives black; see the JAX package)."""
    if params.background_color is not None:
        color = torch.as_tensor(params.background_color, dtype=torch.float32,
                                device=device)
        return color[None, :, None, None].expand(batch_size, 3, render_size, render_size)
    if params.backgrounds is not None:
        if tuple(params.backgrounds.shape) != (batch_size, 3, render_size, render_size):
            raise ValueError(
                f"backgrounds must be {(batch_size, 3, render_size, render_size)}, "
                f"got {tuple(params.backgrounds.shape)}"
            )
        return params.backgrounds
    return None


def rasterize_core(vertices, faces, params, hyperparams):
    """Render the requested channels: [bs, C, H, W], flipped in H and W like
    the reference.  ``vertices`` [bs, nv, 3] float32 NDC; ``faces`` [nf, 3]
    int32, on the same device."""
    if vertices.ndim != 3 or vertices.shape[2] != 3:
        raise ValueError(f"vertices must be [bs, nv, 3], got {tuple(vertices.shape)}")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be [nf, 3], got {tuple(faces.shape)}")
    hp = hyperparams
    render_size = hp.image_size * 2 if hp.anti_aliasing else hp.image_size
    backgrounds = make_backgrounds(params, vertices.shape[0], render_size, vertices.device)
    images, coordinate_map, foreground = compute_channel_maps(
        vertices, faces, params, hp, render_size
    )
    return finalize_images(images, coordinate_map, foreground, backgrounds, hp)


def rasterize_silhouettes(vertices, faces, params=None, hyperparams=RasterizeHyperparam()):
    """Silhouettes [bs, H, W] of NDC ``vertices`` [bs, nv, 3] and int32
    ``faces`` [nf, 3]; differentiable with respect to ``vertices`` through
    the NMR gradient."""
    hp = hyperparams.replace(draw_rgb=False, draw_silhouettes=True, draw_depth=False)
    if params is None:
        params = RasterizeParam()
    return rasterize_core(vertices, faces.to(torch.int32).contiguous(), params, hp)[:, 0]
