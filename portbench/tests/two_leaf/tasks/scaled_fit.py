"""The program's side of the tests' two-leaf fit: each object's vertices
[O, nv, 3] and its scale along the three axes [O, 3], the scaled vertices'
silhouettes through the facade, the mean squared error against seeded
ellipses.  Whole form only."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import scene
from portbench.tasks import silhouette_fit

FORMS = ("whole",)


def make_inputs(cfg, seed, device):
    scene.setting(cfg, "loss", ("mse",))
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
    scale = 1.0 + cfg["scale_perturbation"] * (
        2.0 * torch.rand((objects, 3), generator=gen, device=device) - 1.0)
    return dict(leaves={"vertices": vertices, "scale": scale},
                faces=torch.tensor(f, device=device), eyes=torch.tensor(eyes, device=device),
                targets=torch.tensor(silhouette_fit.targets(cfg, rng, batch), device=device),
                views=per, viewing_angle=cfg["viewing_angle"], image_size=cfg["image_size"],
                anti_aliasing=cfg["anti_aliasing"], batch=batch)


def images(fit, leaves):
    scaled = leaves["vertices"] * leaves["scale"][:, None, :]
    return fit.renderer.render_silhouettes(silhouette_fit.views(scaled, fit.inputs["views"]),
                                           fit.faces)


def loss(images, targets):
    return torch.mean((images - targets) ** 2)


def step_work(cfg, inputs, leaves0):
    return None
