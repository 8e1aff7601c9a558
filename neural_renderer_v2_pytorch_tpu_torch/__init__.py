"""PyTorch + CUDA port of the neural mesh renderer
(``neural_renderer_v2_pytorch_tpu``): differentiable silhouette, textured,
lit and depth rendering with the NMR gradient, with its resolve, gathers
and gradient scatters as hand-written Hopper kernels (``csrc/``), OBJ/MTL
I/O, a trainable ``Mesh``, the reference's per-parameter ``Adam`` and the
examples (``examples/``).  The public names are the JAX package's, and
``eager``, the counterpart of ``jax.disable_jit``: on the card each
``rasterize_*`` call replays a CUDA graph captured once per signature
(``ops/graphs.py``).  Imports no JAX."""

from .models.lights import AmbientLight, DirectionalLight, Light, SpecularLight
from .models.mesh import Mesh
from .models.renderer import Renderer
from .ops.camera import look, look_at, perspective
from .ops.differentiation import differentiation
from .ops.gather_resolve import compute_face_index_map
from .ops.graphs import eager
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
from .ops.resolve import compute_weight_map
from .utils.helpers import (
    create_textures,
    get_points_from_angles,
    imread,
    imsave,
    make_gif,
    to_device,
    to_gpu,
)
from .utils.obj_io import load_mtl, load_obj, save_obj
from .utils.optim import Adam, adam

__version__ = "2.0.2"

__all__ = [
    "Adam",
    "AmbientLight",
    "DirectionalLight",
    "Light",
    "Mesh",
    "Renderer",
    "RasterizeHyperparam",
    "RasterizeParam",
    "SpecularLight",
    "adam",
    "compute_face_index_map",
    "compute_weight_map",
    "create_textures",
    "cross",
    "differentiation",
    "eager",
    "get_points_from_angles",
    "imread",
    "imsave",
    "load_mtl",
    "load_obj",
    "look",
    "look_at",
    "make_gif",
    "mask_foreground",
    "perspective",
    "rasterize",
    "rasterize_all",
    "rasterize_depth",
    "rasterize_rgb",
    "rasterize_rgba",
    "rasterize_silhouettes",
    "save_obj",
    "to_device",
    "to_gpu",
    "to_map",
    "__version__",
]
