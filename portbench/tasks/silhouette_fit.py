"""The silhouette fit: each object's vertices seen by its cameras,
``Renderer.render_silhouettes`` (camera, render, NMR backward), 1 - IoU
against seeded ellipses.  One leaf, ``vertices`` [O, nv, 3]: the
template's, each vertex scaled by 1 + ``perturbation`` U(-1, 1), drawn on
the device by a ``torch.Generator``.  Runs whole and sharded."""

from __future__ import annotations

import numpy as np
import torch

from ..harness import scene
from ..reference import silhouette_fit as ref
from ..yardstick import roofline

FORMS = ("whole", "sharded")
LOSSES = ("iou",)
IOU_EPS = 1e-6


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


def make_inputs(cfg, seed, device):
    """dict(leaves={"vertices": [O, nv, 3] float32}, faces [nf, 3] int32,
    eyes [B, 3], targets [B, S, S], views, viewing_angle, image_size,
    anti_aliasing, batch)."""
    scene.setting(cfg, "loss", LOSSES)
    rng = np.random.default_rng(seed)
    v, f = scene.template(cfg)
    objects, per = cfg["objects"], cfg["views_per_object"]
    batch = objects * per
    eyes = scene.cameras(cfg, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = torch.tensor(v, dtype=scene.DTYPES[cfg["dtype"]], device=device)
    jitter = torch.rand((objects, v.shape[0], 1), generator=gen, device=device)
    vertices = base[None] * (1.0 + cfg["perturbation"] * (2.0 * jitter - 1.0))
    return dict(leaves={"vertices": vertices}, faces=torch.tensor(f, device=device),
                eyes=torch.tensor(eyes, device=device),
                targets=torch.tensor(targets(cfg, rng, batch), device=device),
                views=per, viewing_angle=cfg["viewing_angle"], image_size=cfg["image_size"],
                anti_aliasing=cfg["anti_aliasing"], batch=batch)


def views(vertices, per):
    """Each image's vertices [O * per, nv, 3]: object o's ``per`` times."""
    o, nv = vertices.shape[:2]
    return vertices[:, None].expand(o, per, nv, 3).reshape(o * per, nv, 3)


def images(fit, leaves):
    """The silhouettes [B, S, S] through the facade (the sharded entry
    behind the facade's camera on a mesh)."""
    vertices = views(leaves["vertices"], fit.inputs["views"])
    if fit.mesh is None:
        return fit.renderer.render_silhouettes(vertices, fit.faces)
    ndc = fit.renderer.transform_vertices(vertices)
    return fit.nr.parallel.rasterize_silhouettes_sharded(ndc, fit.faces, None, fit.hp,
                                                         mesh=fit.mesh)


def loss(images, targets):
    """1 - IoU: mean over images of 1 - sum(s t) / (sum(s + t - s t) +
    eps)."""
    inter = torch.sum(images * targets, dim=(1, 2))
    union = torch.sum(images + targets - images * targets, dim=(1, 2))
    return torch.mean(1.0 - inter / (union + IOU_EPS))



def step_work(cfg, inputs, leaves0):
    """The frozen counts of the silhouette step's functions at the seed's
    vertices (``roofline.step_work``)."""
    with torch.no_grad():
        ndc = ref.views_ndc(leaves0["vertices"].to(inputs["faces"].device), inputs)
    size = inputs["image_size"] * (2 if inputs["anti_aliasing"] else 1)
    return roofline.step_work(ndc, inputs["faces"], size)
