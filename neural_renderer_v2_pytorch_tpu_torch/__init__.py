"""PyTorch + CUDA port of the neural mesh renderer
(``neural_renderer_v2_pytorch_tpu``): differentiable silhouette, textured,
lit and depth rendering with the NMR gradient, with its resolve, gathers
and gradient scatters as hand-written Hopper kernels (``csrc/``).  Imports
no JAX."""

from .models.lights import AmbientLight, DirectionalLight, Light, SpecularLight
from .models.renderer import Renderer
from .ops.camera import look_at, perspective
from .ops.differentiation import differentiation
from .ops.gather_resolve import compute_face_index_map
from .ops.maps import cross, mask_foreground, to_map
from .ops.rasterize import (
    RasterizeHyperparam,
    RasterizeParam,
    rasterize,
    rasterize_all,
    rasterize_depth,
    rasterize_rgb,
    rasterize_rgba,
    rasterize_silhouettes,
)
from .utils.helpers import create_textures, get_points_from_angles

__version__ = "2.0.2"

__all__ = [
    "AmbientLight",
    "DirectionalLight",
    "Light",
    "Renderer",
    "RasterizeHyperparam",
    "RasterizeParam",
    "SpecularLight",
    "compute_face_index_map",
    "create_textures",
    "cross",
    "differentiation",
    "get_points_from_angles",
    "look_at",
    "mask_foreground",
    "perspective",
    "rasterize",
    "rasterize_all",
    "rasterize_depth",
    "rasterize_rgb",
    "rasterize_rgba",
    "rasterize_silhouettes",
    "to_map",
    "__version__",
]
