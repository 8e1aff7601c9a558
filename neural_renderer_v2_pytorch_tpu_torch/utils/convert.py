"""Carry the JAX package's inputs, as numpy arrays and plain fields, over
to the port, so that both compute from the same values."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.rasterize import RasterizeHyperparam

# TPU scheduling knobs of the JAX RasterizeHyperparam with no meaning here
_TPU_KNOBS = frozenset(("backend", "face_chunk", "batch_chunk", "planar_hot_path"))


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
