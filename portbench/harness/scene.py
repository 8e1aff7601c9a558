"""The inputs of one run, made by the benchmark from a configuration and
``--seed`` and handed alike to the program and to the reference: the
mesh, the starting vertices (a seeded perturbation of the template, made
on the device by a ``torch.Generator``), the cameras, and the target
silhouettes (drawn in NumPy).

Every seed gives the same sizes: the same mesh, batch, image size and
number of views; only the perturbation, the choice of azimuths and the
targets change.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MODULUS = 2 ** 63
# what a configuration may name, and what the benchmark makes of it
DTYPES = {"float32": torch.float32}
# the control's type: the nearest precision below the configuration's
# (no matrix product in the step, so not TF32)
CONTROLS = {"float32": torch.bfloat16}
LOSSES = ("iou",)
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


def targets(cfg, rng, batch):
    """Target silhouettes [batch, S, S] float32 in {0, 1}: an ellipse per
    image, its radii ``target_radius`` times U(0.7, 1.3), turned by a
    uniform angle, its centre U(-0.1, 0.1) from the middle (NDC units)."""
    size = cfg["image_size"]
    r0 = cfg["target_radius"]
    radii = r0 * rng.uniform(0.7, 1.3, (batch, 2))
    theta = rng.uniform(0.0, np.pi, batch)
    centre = rng.uniform(-0.1, 0.1, (batch, 2))
    g = ((2.0 * np.arange(size) + 1.0 - size) / size).astype(np.float32)
    x, y = g[None, None, :], g[None, :, None]
    dx, dy = x - centre[:, 0, None, None], y - centre[:, 1, None, None]
    c, s = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
    u, v = c * dx + s * dy, -s * dx + c * dy
    inside = (u / radii[:, 0, None, None]) ** 2 + (v / radii[:, 1, None, None]) ** 2 <= 1.0
    return inside.astype(np.float32)


def _setting(cfg, key, allowed):
    if cfg[key] not in allowed:
        raise ValueError(f"{key} {cfg[key]!r}: the benchmark makes only {sorted(allowed)}")


def make_inputs(cfg, seed, device):
    """The run's inputs on ``device``: dict(params [O, nv, 3] float32,
    faces [nf, 3] int32, eyes [B, 3], targets [B, S, S], views,
    viewing_angle, image_size, anti_aliasing, lr, beta1, beta2, eps,
    batch).  Raises ValueError where the configuration names a type, a
    loss or an optimiser the benchmark does not make, or where its mesh
    has other counts than it states."""
    _setting(cfg, "dtype", DTYPES)
    _setting(cfg, "loss", LOSSES)
    _setting(cfg["optimizer"], "name", OPTIMIZERS)
    seed = int(seed) % SEED_MODULUS
    rng = np.random.default_rng(seed)
    v, f = mesh(cfg["mesh"])
    if "vertices" in cfg and (len(v), len(f)) != (cfg["vertices"], cfg["faces"]):
        raise ValueError(f"the mesh has {len(v)} vertices and {len(f)} faces, "
                         f"the configuration states {cfg['vertices']} and {cfg['faces']}")
    objects, per = cfg["objects"], cfg["views_per_object"]
    batch = objects * per
    azimuths = view_azimuths(cfg, rng)
    eyes = eyes_from_angles(cfg["distance"], cfg["elevation"], azimuths)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.tensor(v, dtype=DTYPES[cfg["dtype"]], device=device)
    jitter = torch.rand((objects, v.shape[0], 1), generator=gen, device=device)
    params = base[None] * (1.0 + cfg["perturbation"] * (2.0 * jitter - 1.0))
    return dict(params=params, faces=torch.tensor(f, device=device),
                eyes=torch.tensor(eyes, device=device),
                targets=torch.tensor(targets(cfg, rng, batch), device=device),
                views=per, viewing_angle=cfg["viewing_angle"], image_size=cfg["image_size"],
                anti_aliasing=cfg["anti_aliasing"], batch=batch,
                **{k: cfg["optimizer"][k] for k in ("lr", "beta1", "beta2", "eps")})
