"""The textured, lit fit: each object's vertices and atlas seen by its
cameras, ``Renderer.render_rgb`` under the configuration's lights (camera,
render, atlas sampler, NMR backward), the sum of squared differences to
the reference's renders of the unperturbed template under a seeded atlas.

Two leaves, fitted together: ``vertices`` [O, nv, 3], the template's,
each vertex scaled by 1 + ``perturbation`` U(-1, 1); and ``textures`` [O,
3, th, tw], the atlas before its tanh, every texel at ``texture_start``.
The true atlas is uniform [0, 1).  Both are drawn on the device by a
``torch.Generator`` from the seed.  The texel coordinates unwrap the
torus grid over the atlas, each face with its own three corners; they
and the lights are fixed inputs.  Runs whole only."""

from __future__ import annotations

import numpy as np
import torch

from ..harness import scene
from ..reference import rgb_fit as ref
from ..yardstick import sampler

FORMS = ("whole",)
LOSSES = ("l2",)
LIGHT_FIELDS = {"ambient": ("color",), "directional": ("color", "direction"),
                "specular": ("color", "alpha")}


def torus_uv(n_major, n_minor, height, width):
    """Per-face texel-coordinate triangles unwrapping ``scene.torus(n_major,
    n_minor)``'s (major, minor) grid over a ``height`` x ``width`` atlas:
    (vertices_t f32 [nf * 3, 2], faces_t i32 [nf, 3]), every coordinate in
    [0, width - 1] x [0, height - 1]."""
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    corner = {"a": (i, j), "b": (i + 1, j), "c": (i + 1, j + 1), "d": (i, j + 1)}

    def uv(name):
        ci, cj = corner[name]
        return np.stack((ci / n_major * (width - 1), cj / n_minor * (height - 1)), -1)

    # scene.torus's faces: all (a, c, b), then all (a, d, c)
    tris = [np.stack([uv(k) for k in order], -2).reshape(-1, 3, 2) for order in ("acb", "adc")]
    vertices_t = np.concatenate(tris).reshape(-1, 2)
    faces_t = np.arange(len(vertices_t)).reshape(-1, 3)
    return vertices_t.astype(np.float32), faces_t.astype(np.int32)


def make_lights(cfg, batch, device):
    """The configuration's lights in its order: dicts of ``kind`` and each
    field a [batch, ...] float32 tensor (colours and directions [batch, 3],
    exponents [batch])."""
    out = []
    for light in cfg["lights"]:
        kind = light["kind"]
        if kind not in LIGHT_FIELDS:
            raise ValueError(f"lights: the benchmark makes only {sorted(LIGHT_FIELDS)}, "
                             f"not {kind!r}")
        made = {"kind": kind}
        for field in LIGHT_FIELDS[kind]:
            value = torch.tensor(light[field], dtype=torch.float32, device=device)
            value = value.expand(3) if field == "color" else value
            made[field] = value.expand(batch, *value.shape).contiguous()
        out.append(made)
    return out


def make_inputs(cfg, seed, device):
    """dict(leaves={"vertices": [O, nv, 3], "textures": [O, 3, th, tw]},
    faces [nf, 3] int32, eyes [B, 3], vertices_t [nf * 3, 2], faces_t [nf,
    3] int32, lights, targets [B, 3, S, S], views, viewing_angle,
    image_size, anti_aliasing, batch).  The lights are the same for every
    seed, so ``Fit.reset`` need not copy them."""
    scene.setting(cfg, "loss", LOSSES)
    rng = np.random.default_rng(seed)
    v, f = scene.template(cfg)
    mesh, atlas = cfg["mesh"], cfg["atlas"]
    if mesh["kind"] != "torus":
        raise ValueError(f"mesh {mesh['kind']!r}: the texel coordinates unwrap a torus only")
    objects, per = cfg["objects"], cfg["views_per_object"]
    batch = objects * per
    th, tw = atlas["height"], atlas["width"]
    vt, ft = torus_uv(mesh["n_major"], mesh["n_minor"], th, tw)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.tensor(v, dtype=scene.DTYPES[cfg["dtype"]], device=device)
    jitter = torch.rand((objects, v.shape[0], 1), generator=gen, device=device)
    vertices = base[None] * (1.0 + cfg["perturbation"] * (2.0 * jitter - 1.0))
    true_atlas = torch.rand((objects, 3, th, tw), generator=gen, device=device)
    inputs = dict(faces=torch.tensor(f, device=device),
                  eyes=torch.tensor(scene.cameras(cfg, rng), device=device),
                  vertices_t=torch.tensor(vt, device=device),
                  faces_t=torch.tensor(ft, device=device),
                  lights=make_lights(cfg, batch, device), views=per,
                  viewing_angle=cfg["viewing_angle"], image_size=cfg["image_size"],
                  anti_aliasing=cfg["anti_aliasing"], batch=batch)
    with torch.no_grad():
        inputs["targets"] = ref.render(base[None].expand(objects, -1, -1), true_atlas, inputs)
    del true_atlas
    inputs["leaves"] = {"vertices": vertices,
                        "textures": torch.full((objects, 3, th, tw), cfg["texture_start"],
                                               dtype=torch.float32, device=device)}
    return inputs


def views(leaves, inputs):
    """Each image's vertices [O * per, nv, 3], atlas [O * per, 3, th, tw]
    (the tanh of its object's leaf, a view of it) and texel coordinates
    [O * per, nf * 3, 2]: object o's ``per`` times."""
    per = inputs["views"]
    vertices, atlas = leaves["vertices"], torch.tanh(leaves["textures"])
    o = vertices.shape[0]
    vertices = vertices[:, None].expand(o, per, *vertices.shape[1:]).reshape(
        o * per, *vertices.shape[1:])
    atlas = atlas[:, None].expand(o, per, *atlas.shape[1:]).reshape(o * per, *atlas.shape[1:])
    vt = inputs["vertices_t"]
    return vertices, atlas, vt[None].expand(o * per, *vt.shape)


def lights(fit):
    """The port's light objects over the inputs' tensors."""
    kinds = {"ambient": fit.nr.AmbientLight, "directional": fit.nr.DirectionalLight,
             "specular": fit.nr.SpecularLight}
    return [kinds[light["kind"]](**{k: t for k, t in light.items() if k != "kind"})
            for light in fit.inputs["lights"]]


def images(fit, leaves):
    """The RGB images [B, 3, S, S] through the facade."""
    vertices, atlas, vt = views(leaves, fit.inputs)
    return fit.renderer.render_rgb(vertices, fit.faces, vt, fit.inputs["faces_t"], atlas,
                                   lights=lights(fit))


def loss(images, targets):
    """The sum of squared differences over the batch."""
    return torch.sum((images - targets) ** 2)


def step_work(cfg, inputs, leaves0):
    """The frozen counts of the sampler at the seed's vertices
    (``sampler.sample_work``): its covered pixels from the reference's
    z-buffer."""
    with torch.no_grad():
        ndc = ref.sil.views_ndc(leaves0["vertices"].to(inputs["faces"].device), inputs)
        fv = ndc[:, inputs["faces"].long()]
        size = inputs["image_size"] * (2 if inputs["anti_aliasing"] else 1)
        covered = int((ref.sil.zbuffer(fv, size) >= 0).sum())
    textures = leaves0["textures"]
    return {"sample": sampler.sample_work(covered, textures.shape[0],
                                          textures.shape[2] * textures.shape[3])}
