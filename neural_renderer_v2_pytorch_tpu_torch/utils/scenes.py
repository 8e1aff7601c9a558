"""Deterministic procedural meshes (numpy only) shared by the tests and
``chip_smoke.py``: the repository ships no mesh assets.

``torus(40, 32)`` (1,280 vertices, 2,560 faces) stands in for the
reference teapot (1,292 / 2,464); it occludes itself, so the z-buffer does
real work.  ``icosphere(level)`` has 20 * 4**level faces: 1,280 at level 3,
81,920 at level 6.
"""

from __future__ import annotations

import numpy as np


def torus(n_major, n_minor, major_radius=0.6, minor_radius=0.25):
    """Torus around the y axis: (vertices f32 [n_major*n_minor, 3],
    faces i32 [2*n_major*n_minor, 3])."""
    u = 2.0 * np.pi * np.arange(n_major) / n_major
    v = 2.0 * np.pi * np.arange(n_minor) / n_minor
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major_radius + minor_radius * np.cos(vv)
    vertices = np.stack(
        (ring * np.cos(uu), minor_radius * np.sin(vv), ring * np.sin(uu)), axis=-1
    ).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    i1, j1 = (i + 1) % n_major, (j + 1) % n_minor
    a, b = i * n_minor + j, i1 * n_minor + j
    c, d = i1 * n_minor + j1, i * n_minor + j1
    faces = np.concatenate(
        (np.stack((a, c, b), -1).reshape(-1, 3), np.stack((a, d, c), -1).reshape(-1, 3))
    )
    return vertices.astype(np.float32), faces.astype(np.int32)


def icosphere(level, radius=0.5):
    """Sphere from an icosahedron subdivided ``level`` times at edge
    midpoints: (vertices f32 [nv, 3], faces i32 [20 * 4**level, 3])."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    vertices = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(level):
        edges = np.concatenate((faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]))
        edges.sort(axis=1)
        unique, inverse = np.unique(edges, axis=0, return_inverse=True)
        mid = len(vertices) + inverse.reshape(3, -1)      # midpoint ids of 01, 12, 20
        vertices = np.concatenate((vertices, vertices[unique].mean(axis=1)))
        a, b, c = faces.T
        m01, m12, m20 = mid
        faces = np.concatenate(
            (
                np.stack((a, m01, m20), -1), np.stack((m01, b, m12), -1),
                np.stack((m20, m12, c), -1), np.stack((m01, m12, m20), -1),
            )
        )
    vertices = radius * vertices / np.linalg.norm(vertices, axis=1, keepdims=True)
    return vertices.astype(np.float32), faces.astype(np.int32)
