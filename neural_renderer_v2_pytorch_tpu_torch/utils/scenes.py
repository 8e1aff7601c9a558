"""Deterministic procedural meshes (numpy) shared by the tests and
``chip_smoke.py``: the repository ships no mesh assets.

``torus(40, 32)`` (1,280 vertices, 2,560 faces) stands in for the
reference teapot (1,292 / 2,464); it occludes itself, so the z-buffer does
real work.  ``icosphere(level)`` has 20 * 4**level faces: 1,280 at level 3,
81,920 at level 6.

The textured scenes: ``atlas_scene`` unwraps a torus over a seeded random
atlas (by default at the size of the loaded atlas of the JAX package's
perf matrix, ``ATLAS_HW``), ``texel_scene`` gives it a ``create_textures``
atlas of seeded random texels, and ``lit_light_arrays`` are that perf
matrix's three lights.

``write_example_data`` writes what the examples (``examples/``) read in
place of the reference's teapot and target images, and ``square`` is the
two-triangle square of the silhouette convergence fit.  ``subdivide`` is
the JAX package's perf-matrix face-count sweep's midpoint subdivision
(``benchmarks/scaling.py``), which the port's ``benchmarks.scaling``
applies to ``torus(40, 32)``.  ``edge_scenes`` are the JAX package's
pipeline edge cases (an empty image, every face clipped, a batch mixing an
empty slot with a full one, random soups of duplicate and degenerate
faces).
"""

from __future__ import annotations

import os

import numpy as np

# the loaded texture atlas of the JAX package's perf matrix
# (benchmarks/scaling.py:179-217), which the repository does not ship
ATLAS_HW = (1190, 1920)


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


def torus_quads(n_major, n_minor):
    """``torus(n_major, n_minor)``'s faces as quads i32 [n_major*n_minor, 4]
    (a, d, c, b): fan-triangulated, quad q gives the faces (a, d, c) and
    (a, c, b), which are ``torus``'s faces n_major*n_minor + q and q."""
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    i1, j1 = (i + 1) % n_major, (j + 1) % n_minor
    a, b = i * n_minor + j, i1 * n_minor + j
    c, d = i1 * n_minor + j1, i * n_minor + j1
    return np.stack((a, d, c, b), -1).reshape(-1, 4).astype(np.int32)


def fan_triangles(polygons):
    """Fan triangulation of equal-sized polygons [n, k]: the faces
    [n * (k - 2), 3], each polygon's in turn, as an OBJ loader makes them."""
    polygons = np.asarray(polygons)
    k = polygons.shape[1]
    fans = [polygons[:, [0, i + 1, i + 2]] for i in range(k - 2)]
    return np.stack(fans, 1).reshape(-1, 3)


def torus_uv(n_major, n_minor, height, width):
    """Per-face texel-coordinate triangles that unwrap ``torus(n_major,
    n_minor)``'s (major, minor) grid over a ``height`` x ``width`` atlas:
    (vertices_t f32 [nf*3, 2], faces_t i32 [nf, 3]).  Each face has its own
    three corners, so faces across the seam are unwrapped too, and every
    coordinate lies in [0, width-1] x [0, height-1], as the atlas sampler
    requires."""
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    corner = {"a": (i, j), "b": (i + 1, j), "c": (i + 1, j + 1), "d": (i, j + 1)}

    def uv(name):
        ci, cj = corner[name]
        return np.stack((ci / n_major * (width - 1), cj / n_minor * (height - 1)), -1)

    # torus()'s faces: all (a, c, b), then all (a, d, c)
    tris = [np.stack([uv(k) for k in order], -2).reshape(-1, 3, 2) for order in ("acb", "adc")]
    vertices_t = np.concatenate(tris).reshape(-1, 2)
    faces_t = np.arange(len(vertices_t)).reshape(-1, 3)
    return vertices_t.astype(np.float32), faces_t.astype(np.int32)


def random_atlas(seed, height=ATLAS_HW[0], width=ATLAS_HW[1]):
    """A uniform random RGB atlas f32 [3, height, width] from ``seed``."""
    return np.random.RandomState(seed).rand(3, height, width).astype(np.float32)


def atlas_scene(n_major, n_minor, height=ATLAS_HW[0], width=ATLAS_HW[1], seed=1):
    """``torus(n_major, n_minor)`` unwrapped over a random atlas: (vertices,
    faces, vertices_t [1, nf*3, 2], faces_t [nf, 3], textures
    [1, 3, height, width])."""
    v, f = torus(n_major, n_minor)
    vt, ft = torus_uv(n_major, n_minor, height, width)
    return v, f, vt[None], ft, random_atlas(seed, height, width)[None]


def texel_scene(n_major, n_minor, texture_size, seed=2):
    """``torus(n_major, n_minor)`` with ``create_textures`` texel
    coordinates and an atlas of random texels: (vertices, faces,
    vertices_t [1, nf*3, 2], faces_t [nf, 3], textures [1, 3, th, tw])."""
    from .helpers import create_textures

    v, f = torus(n_major, n_minor)
    vt, ft, tex = (t.numpy() for t in create_textures(len(f), texture_size, device="cpu"))
    tex = np.random.RandomState(seed).rand(*tex.shape).astype(np.float32)
    return v, f, vt[None], ft, tex[None]


def lit_light_arrays():
    """The three lights of the JAX package's perf matrix (benchmarks/
    scaling.py:161-166) as (kind, {field: f32 [1, ...]}): directional
    (1, 1, 1) at 0.6, ambient 0.3, specular 0.2 (exponent 1)."""
    ones = np.ones((1, 3), np.float32)
    return (
        ("directional", {"color": 0.6 * ones, "direction": ones.copy()}),
        ("ambient", {"color": 0.3 * ones}),
        ("specular", {"color": 0.2 * ones}),
    )


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


def subdivide(vertices, faces):
    """Midpoint 1:4 subdivision of each triangle, with no vertex shared
    between faces (the geometry unchanged): (vertices f32 [6 nf, 3], faces
    i32 [4 nf, 3]).  Each parent's four children (its three corners, then
    its centre) lie next to each other, and the vertices are numbered in
    first use, as a mesh pipeline would emit them."""
    v0, v1, v2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    new = np.concatenate([v0, v1, v2, (v0 + v1) / 2, (v1 + v2) / 2, (v2 + v0) / 2], 0)
    n = faces.shape[0]
    i = np.arange(n)
    a, b, c, ab, bc, ca = i, i + n, i + 2 * n, i + 3 * n, i + 4 * n, i + 5 * n
    children = np.stack([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                         np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)], 1).reshape(-1, 3)
    flat = children.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    order = flat[np.sort(first)]
    remap = np.empty(new.shape[0], np.int64)
    remap[order] = np.arange(order.shape[0])
    return new[order].astype(np.float32), remap[flat].reshape(-1, 3).astype(np.int32)


def square(half, centre=(0.0, 0.0), z=1.0):
    """A square of side ``2 * half`` around ``centre`` at depth ``z``, as NDC
    vertices f32 [4, 3] and two faces i32 [2, 3]; at ``half`` 0.1 around the
    origin, the start of the JAX package's convergence test
    (tests/test_rasterize.py:165-204)."""
    cx, cy = centre
    vertices = np.array([[cx + half, cy + half, z], [cx - half, cy + half, z],
                         [cx - half, cy - half, z], [cx + half, cy - half, z]], np.float32)
    return vertices, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


# the convergence fit's target, a larger square moved off the centre: its
# silhouette stands in for the reference's gradient.png, which the
# repository does not ship (the fit starts at square(0.1))
CONVERGENCE_TARGET = dict(half=0.3, centre=(0.2, -0.15))

# the pipeline edge cases of the JAX package's tests/test_pipeline_edge.py:
# their image size (anti-aliasing off but in "mixed-aa"), the fuzz test's
# seed and trials, and the texel size of its textured soups
EDGE_SIZE = 32
EDGE_SEED = 77
EDGE_SOUP_TRIALS = 3
EDGE_TEXTURE_SIZE = 2


def edge_scenes():
    """The JAX package's pipeline edge cases (tests/test_pipeline_edge.py:
    39-126) as NDC scenes, name -> dict(vertices f32 [bs, nv, 3], faces i32
    [nf, 3], anti_aliasing), the soups also with (vertices_t f32 [1, nf*3,
    2], faces_t i32 [nf, 3], textures f32 [1, 3, th, tw]): a
    ``create_textures(nf, EDGE_TEXTURE_SIZE)`` atlas of random texels.

    - ``empty``: one face wholly off screen;
    - ``near``: one face in front of the near plane (z = 0.01 < 0.1);
    - ``single``: one visible face;
    - ``mixed``: a batch of that face moved off screen (slot 0) and the
      face (slot 1); ``mixed-aa`` the same with anti-aliasing;
    - ``soup0``-``soup2``: the fuzz test's random soups, drawn in its order
      from ``RandomState(EDGE_SEED)``: 5 or 33 faces of vertices of their
      own, face 1 a duplicate of face 0 and vertex 7 of vertex 6 (a
      degenerate edge)."""
    from .helpers import create_textures

    one = np.array([[0, 1, 2]], np.int32)
    tri = np.array([[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], np.float32)
    mixed = np.stack([tri * 0 + 9.0, tri])
    out = {
        "empty": dict(vertices=np.array([[[5.0, 5.0, 1.0], [5.2, 5.0, 1.0], [5.0, 5.2, 1.0]]],
                                        np.float32), faces=one, anti_aliasing=False),
        "near": dict(vertices=np.array([[[-0.5, -0.5, 0.01], [0.5, -0.5, 0.01],
                                         [0.0, 0.5, 0.01]]], np.float32),
                     faces=one, anti_aliasing=False),
        "single": dict(vertices=tri[None], faces=one, anti_aliasing=False),
        "mixed": dict(vertices=mixed, faces=one, anti_aliasing=False),
        "mixed-aa": dict(vertices=mixed, faces=one, anti_aliasing=True),
    }
    rng = np.random.RandomState(EDGE_SEED)
    for trial in range(EDGE_SOUP_TRIALS):
        nf = int(rng.choice([5, 33]))
        fv = rng.uniform(-1.2, 1.2, (1, nf * 3, 3)).astype(np.float32)
        fv[..., 2] = np.abs(fv[..., 2]) + rng.uniform(0.05, 0.5)
        if nf > 4:
            fv[0, 3:6] = fv[0, 0:3]          # duplicate face
            fv[0, 7] = fv[0, 6]              # degenerate edge
        vt, ft, tex = (t.numpy() for t in create_textures(nf, EDGE_TEXTURE_SIZE, device="cpu"))
        out[f"soup{trial}"] = dict(
            vertices=fv, faces=np.arange(nf * 3, dtype=np.int32).reshape(nf, 3),
            anti_aliasing=False, vertices_t=vt[None], faces_t=ft,
            textures=rng.rand(*tex.shape).astype(np.float32)[None])
    return out


# the examples' cameras, here alone: distance, elevation and azimuth of
# example 2's view, example 3's evaluation view (both examples import them)
# and the view example 4's camera fit should find
EXAMPLE2_VIEW = (2.732, 0, 90)
EXAMPLE3_VIEW = (2.732, 0, 0)
EXAMPLE4_VIEW = (2.732, 30, 30)


def _write_gray(path, image):
    from .helpers import imsave

    imsave(path, np.repeat(np.asarray(image)[..., None], 3, axis=-1))


def write_torus_obj(path, n_major, n_minor):
    """``torus(n_major, n_minor)`` as an OBJ file of quads."""
    v, _ = torus(n_major, n_minor)
    with open(path, "w") as f:
        f.write(f"# torus({n_major}, {n_minor}) as quads\n\n")
        f.writelines("v %.8f %.8f %.8f\n" % tuple(p) for p in v)
        f.write("\n")
        f.writelines("f %d %d %d %d\n" % tuple(q + 1) for q in torus_quads(n_major, n_minor))


def write_example_data(directory, size, device="cuda"):
    """Write the examples' inputs into ``directory`` and return their paths
    by name:

    - ``torus.obj``: ``torus(40, 32)`` (2,560 faces, the stand-in for the
      reference teapot's 2,464) written as quads, so that loading it
      fan-triangulates;
    - ``example2_ref.png``: the silhouette of that torus, scaled and moved,
      from example 2's view;
    - ``example3_ref.png``: the orthographic RGB render of the torus with a
      ``create_textures`` atlas (texture size 4) of seeded random texels,
      from example 3's evaluation view;
    - ``example4_ref.png``: the silhouette from (2.732, 30, 30), the camera
      example 4 should find from its start at (6, 10, -14).

    The images are ``size`` x ``size`` RGB, rendered with anti-aliasing on
    ``device`` from the torus as ``load_obj`` gives it."""
    import torch

    from ..models.renderer import Renderer
    from .helpers import create_textures, get_points_from_angles, imsave
    from .obj_io import load_obj

    os.makedirs(directory, exist_ok=True)
    paths = {name: os.path.join(directory, name) for name in (
        "torus.obj", "example2_ref.png", "example3_ref.png", "example4_ref.png")}
    write_torus_obj(paths["torus.obj"], 40, 32)

    vertices, faces = load_obj(paths["torus.obj"], device=device)
    r = Renderer(device)
    r.image_size = size
    with torch.no_grad():
        r.viewpoints = get_points_from_angles(*EXAMPLE2_VIEW)
        scale = vertices.new_tensor([1.1, 1.3, 1.1])
        moved = vertices * scale + vertices.new_tensor([0.0, 0.1, 0.0])
        _write_gray(paths["example2_ref.png"], r.render_silhouettes(moved[None], faces)[0].cpu())

        r.viewpoints = get_points_from_angles(*EXAMPLE4_VIEW)
        _write_gray(paths["example4_ref.png"], r.render_silhouettes(vertices[None], faces)[0].cpu())

        r.viewpoints = get_points_from_angles(*EXAMPLE3_VIEW)
        r.perspective = False
        r.texture_size = 4
        vt, ft, tex = create_textures(faces.shape[0], texture_size=4, device=device)
        texels = np.random.RandomState(3).rand(*tex.shape).astype(np.float32)
        rgb = r.render_rgb(vertices[None], faces, vt[None], ft,
                           vertices.new_tensor(texels)[None])[0]
        imsave(paths["example3_ref.png"], rgb.permute(1, 2, 0).cpu())
    return paths
