"""What every task's inputs share, made by the benchmark from a
configuration and ``--seed`` and handed alike to the program and to the
reference: the template meshes (with the checks of the vertex and face
counts a configuration states), the cameras, the types and controls a
configuration may name, and :func:`make_inputs`, which checks those and
hands the rest to the configuration's task (``tasks/<reference>.py``).

Every seed gives the same sizes: the same mesh, batch, image size and
number of views; only what each task draws from the seed changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spec

SEED_MODULUS = 2 ** 63
# what a configuration may name, and what the benchmark makes of it
DTYPES = {"float32": torch.float32}
# the control's type: the nearest precision below the configuration's
# (no matrix product in the step, so not TF32)
CONTROLS = {"float32": torch.bfloat16}
OPTIMIZERS = ("adam",)


def icosphere(level, radius=0.5):
    """Icosahedron subdivided ``level`` times at edge midpoints, projected
    on the sphere: (vertices f32 [nv, 3], faces i32 [20 * 4**level, 3])."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    vertices = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                         [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1],
                         [-t, 0, 1]], np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                      [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(level):
        edges = np.concatenate((faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]))
        edges.sort(axis=1)
        unique, inverse = np.unique(edges, axis=0, return_inverse=True)
        m01, m12, m20 = len(vertices) + inverse.reshape(3, -1)
        vertices = np.concatenate((vertices, vertices[unique].mean(axis=1)))
        a, b, c = faces.T
        faces = np.concatenate((np.stack((a, m01, m20), -1), np.stack((m01, b, m12), -1),
                                np.stack((m20, m12, c), -1), np.stack((m01, m12, m20), -1)))
    vertices = radius * vertices / np.linalg.norm(vertices, axis=1, keepdims=True)
    return vertices.astype(np.float32), faces.astype(np.int32)


def torus(n_major, n_minor, major_radius=0.6, minor_radius=0.25):
    """Torus around the y axis with shared vertices: (vertices f32
    [n_major * n_minor, 3], faces i32 [2 * n_major * n_minor, 3])."""
    u = 2.0 * np.pi * np.arange(n_major) / n_major
    v = 2.0 * np.pi * np.arange(n_minor) / n_minor
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major_radius + minor_radius * np.cos(vv)
    vertices = np.stack((ring * np.cos(uu), minor_radius * np.sin(vv), ring * np.sin(uu)),
                        axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    i1, j1 = (i + 1) % n_major, (j + 1) % n_minor
    a, b = i * n_minor + j, i1 * n_minor + j
    c, d = i1 * n_minor + j1, i * n_minor + j1
    faces = np.concatenate((np.stack((a, c, b), -1).reshape(-1, 3),
                            np.stack((a, d, c), -1).reshape(-1, 3)))
    return vertices.astype(np.float32), faces.astype(np.int32)


MESHES = {"icosphere": icosphere, "torus": torus}


def mesh(spec):
    """The template mesh a configuration's ``mesh`` entry names."""
    args = {k: v for k, v in spec.items() if k != "kind"}
    return MESHES[spec["kind"]](**args)


def template(cfg):
    """The configuration's template mesh (vertices f32 [nv, 3], faces i32
    [nf, 3]).  Raises ValueError where it has other counts than the
    configuration states."""
    v, f = mesh(cfg["mesh"])
    if "vertices" in cfg and (len(v), len(f)) != (cfg["vertices"], cfg["faces"]):
        raise ValueError(f"the mesh has {len(v)} vertices and {len(f)} faces, "
                         f"the configuration states {cfg['vertices']} and {cfg['faces']}")
    return v, f


def eyes_from_angles(distance, elevation, azimuths):
    """Camera positions [len(azimuths), 3] float32 for angles in degrees
    (y up; azimuth 0 looks along +z from -z)."""
    el = math.radians(elevation)
    out = [(distance * math.cos(el) * math.sin(math.radians(a)), distance * math.sin(el),
            -distance * math.cos(el) * math.cos(math.radians(a))) for a in azimuths]
    return np.array(out, np.float32)


def view_azimuths(cfg, rng):
    """Each image's azimuth in degrees: ``views_per_object`` of the
    ``azimuths`` evenly spaced ones for each object, all of them in order
    where the two counts agree, else a seeded draw without repeats."""
    n, per = cfg["azimuths"], cfg["views_per_object"]
    if per == n:
        picks = np.tile(np.arange(n), (cfg["objects"], 1))
    else:
        picks = np.stack([rng.choice(n, per, replace=False) for _ in range(cfg["objects"])])
    return (picks.reshape(-1) * (360.0 / n)).astype(np.float64)


def cameras(cfg, rng):
    """Each image's camera position [B, 3] float32: ``views_per_object``
    of the evenly spaced azimuths for each object (:func:`view_azimuths`)
    at the configuration's elevation and distance."""
    return eyes_from_angles(cfg["distance"], cfg["elevation"], view_azimuths(cfg, rng))


def setting(cfg, key, allowed):
    """Raise ValueError where ``cfg[key]`` is not one of ``allowed``."""
    if cfg[key] not in allowed:
        raise ValueError(f"{key} {cfg[key]!r}: the benchmark makes only {sorted(allowed)}")


def make_inputs(cfg, seed, device, task=None):
    """The run's inputs on ``device``: the ``make_inputs`` of ``task`` (the
    cell's task module, ``spec.cell``; by default the one ``cfg`` names,
    see ``tasks/``) from ``seed`` reduced modulo 2**63.  Raises ValueError
    where the configuration names a type or an optimiser the benchmark
    does not make, or a task it does not have (``spec.task``)."""
    setting(cfg, "dtype", DTYPES)
    setting(cfg["optimizer"], "name", OPTIMIZERS)
    task = task if task is not None else spec.task(cfg)
    return task.make_inputs(cfg, int(seed) % SEED_MODULUS, device)
