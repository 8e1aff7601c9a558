"""PyTorch + CUDA port of the neural mesh renderer
(``neural_renderer_v2_pytorch_tpu``), first slice: differentiable silhouette
rendering with the NMR gradient, with its resolve and gradient scatters as
hand-written Hopper kernels (``csrc/``).  Imports no JAX."""

from .models.renderer import Renderer
from .ops.camera import look_at, perspective
from .ops.differentiation import differentiation
from .ops.rasterize import RasterizeHyperparam, RasterizeParam, rasterize_silhouettes
from .utils.helpers import get_points_from_angles

__version__ = "2.0.2"

__all__ = [
    "Renderer",
    "RasterizeHyperparam",
    "RasterizeParam",
    "differentiation",
    "get_points_from_angles",
    "look_at",
    "perspective",
    "rasterize_silhouettes",
    "__version__",
]
