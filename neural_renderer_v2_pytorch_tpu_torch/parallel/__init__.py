"""Sharded rendering on ``torch.distributed`` over a (data, tile, face) mesh
(counterpart of ``neural_renderer_v2_pytorch_tpu/parallel``)."""

from . import distributed
from .collectives import COLLECTIVES, COLLECTIVE_SECONDS, reset_collectives
from .faces import compute_face_index_map_face_sharded, ordered_z_combine
from .launch import run_ranks
from .mesh import Mesh, auto_mesh, make_mesh
from .render import (
    band_rows,
    rasterize_core_sharded,
    rasterize_depth_sharded,
    rasterize_rgb_sharded,
    rasterize_rgba_sharded,
    rasterize_silhouettes_sharded,
)
