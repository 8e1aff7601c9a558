"""Light sources (counterpart of ``neural_renderer_v2_pytorch_tpu/models/
lights.py``).  Colours, directions and specular exponents are tensors, so
they can take gradients; ``backside`` is a plain bool.  The shading math is
``ops/shading.py:apply_lights_planar``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class Light:
    """Base class of the light sources (reference lights.py:4-8)."""


@dataclasses.dataclass
class AmbientLight(Light):
    """Flat per-batch colour added to the colour-weight map."""

    color: torch.Tensor                     # [bs, 3]


@dataclasses.dataclass
class DirectionalLight(Light):
    """Lambertian light: intensity = relu(-direction . normal), or its
    absolute value when ``backside``."""

    color: torch.Tensor                     # [bs, 3]
    direction: torch.Tensor                 # [bs, 3]
    backside: bool = False


@dataclasses.dataclass
class SpecularLight(Light):
    """View-aligned specular: intensity = ((0, 0, 1) . -normal) ** alpha."""

    color: torch.Tensor                     # [bs, 3]
    alpha: Optional[torch.Tensor] = None    # [bs]; None means ones
    backside: bool = False
