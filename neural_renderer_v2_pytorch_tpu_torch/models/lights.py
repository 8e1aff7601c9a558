"""Light sources (counterpart of ``neural_renderer_v2_pytorch_tpu/models/
lights.py``).  Colours, directions and specular exponents are tensors, so
they can take gradients; ``backside`` is a plain bool.  The shading math is
``ops/shading.py:apply_lights_planar`` (``color_weight_planes`` over the
fields' ``light_table``); a render shades through kernel K15 with K16 as
its backward (``ops/shading.py:shade_planes``, ``csrc/lights_shade.cu``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class Light:
    """Base class of the light sources (reference lights.py:4-8)."""


class _Replace:
    def replace(self, **kw):
        """A copy with the fields ``kw`` replaced, as ``flax.struct``'s."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AmbientLight(Light, _Replace):
    """Flat per-batch colour added to the colour-weight map."""

    color: torch.Tensor                     # [bs, 3]


@dataclasses.dataclass
class DirectionalLight(Light, _Replace):
    """Lambertian light: intensity = relu(-direction . normal), or its
    absolute value when ``backside``."""

    color: torch.Tensor                     # [bs, 3]
    direction: torch.Tensor                 # [bs, 3]
    backside: bool = False


@dataclasses.dataclass
class SpecularLight(Light, _Replace):
    """View-aligned specular: intensity = ((0, 0, 1) . -normal) ** alpha."""

    color: torch.Tensor                     # [bs, 3]
    alpha: Optional[torch.Tensor] = None    # [bs]; None means ones
    backside: bool = False
