"""Carry the JAX package's inputs, as numpy arrays and plain fields, over
to the port, so that both compute from the same values."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import lights as light_lib
from ..ops.rasterize import RasterizeHyperparam, RasterizeParam

# TPU scheduling knobs of the JAX RasterizeHyperparam with no meaning here
_TPU_KNOBS = frozenset(("backend", "face_chunk", "batch_chunk", "planar_hot_path"))
# the JAX RasterizeParam's host-side occupancy lists of its TPU gather and
# scatter; the port's kernels need none
_TPU_PARAMS = frozenset(("slot_occupancy",))
_LIGHTS = {cls.__name__: cls for cls in (
    light_lib.AmbientLight, light_lib.DirectionalLight, light_lib.SpecularLight
)}


def scene_from_numpy(vertices, faces, viewpoints, device):
    """(vertices f32 [.., nv, 3], faces i32 [nf, 3], eye f32) tensors on
    ``device`` from array-likes."""
    return (
        torch.as_tensor(np.asarray(vertices, np.float32), device=device),
        torch.as_tensor(np.asarray(faces, np.int32), device=device),
        torch.as_tensor(np.asarray(viewpoints, np.float32), device=device),
    )


def hyperparams_from_jax(fields):
    """A :class:`RasterizeHyperparam` from ``dataclasses.asdict`` of the JAX
    package's.  Drops its TPU knobs by name; raises on any other key the
    port does not know."""
    known = {f.name for f in dataclasses.fields(RasterizeHyperparam)}
    kept = {k: v for k, v in fields.items() if k not in _TPU_KNOBS}
    unknown = sorted(set(kept) - known)
    if unknown:
        raise ValueError(f"unknown hyperparameter fields: {unknown}")
    return RasterizeHyperparam(**kept)


def lights_from_jax(lights, device):
    """The port's lights from the JAX package's (``AmbientLight``,
    ``DirectionalLight``, ``SpecularLight``; arrays as anything numpy can
    read), as a tuple of float32 tensors on ``device``."""
    out = []
    for light in lights:
        cls = _LIGHTS.get(type(light).__name__)
        if cls is None:
            raise TypeError(f"unknown light type: {light!r}")
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(light, f.name)
            if f.name != "backside" and v is not None:
                v = torch.as_tensor(np.asarray(v, np.float32), device=device)
            kw[f.name] = v
        out.append(cls(**kw))
    return tuple(out)


def params_from_jax(fields, device):
    """A :class:`RasterizeParam` on ``device`` from the JAX package's: the
    object itself, or a mapping of its fields (arrays as anything numpy can
    read).  Drops its TPU occupancy lists by name; raises on any other
    field the port does not know."""
    if dataclasses.is_dataclass(fields):
        fields = {f.name: getattr(fields, f.name) for f in dataclasses.fields(fields)}
    known = {f.name for f in dataclasses.fields(RasterizeParam)}
    kept = {k: v for k, v in fields.items() if k not in _TPU_PARAMS}
    unknown = sorted(set(kept) - known)
    if unknown:
        raise ValueError(f"unknown parameter fields: {unknown}")
    out = {}
    for name, v in kept.items():
        if v is None or name in ("background_color", "texture_size"):
            out[name] = v
        elif name == "lights":
            out[name] = lights_from_jax(v, device)
        else:
            dtype = np.int32 if name == "faces_textures" else np.float32
            out[name] = torch.as_tensor(np.asarray(v, dtype), device=device)
    return RasterizeParam(**out)


def mesh_shape_from_jax(mesh):
    """The {"data", "tile", "face"} sizes of the JAX package's ``Mesh`` (face 1
    where it has no face axis), for ``parallel.make_mesh(**sizes)``."""
    shape = dict(mesh.shape)
    return {"data": shape["data"], "tile": shape["tile"], "face": shape.get("face", 1)}
