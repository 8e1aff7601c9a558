"""Plain reference of the tests' two-leaf fit (``tasks/scaled_fit.py``):
the silhouette fit's plain reference on the scaled vertices, the mean
squared error, one plain Adam a leaf."""

from __future__ import annotations

import torch

from portbench.reference import silhouette_fit as plain


def run(inputs, steps=3, dtype=torch.float32, fault=None):
    params = {n: t.to(dtype) for n, t in inputs["leaves"].items()}
    inputs = dict(inputs, faces=inputs["faces"].long())
    eyes, targets = inputs["eyes"].to(dtype), inputs["targets"].to(dtype)
    opt = inputs["optimizer"]
    adams = {n: plain.Adam(opt["lr"], opt["beta1"], opt["beta2"], opt["eps"]) for n in params}
    losses, grad1 = [], None
    for _ in range(steps):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        scaled = leaves["vertices"] * leaves["scale"][:, None, :]
        images = plain.forward_images(scaled, dict(inputs, eyes=eyes))
        t = targets
        if fault == "half_batch":
            half = images.shape[0] // 2
            images, t = images[:half], targets[:half]
        elif fault == "altered":
            images = torch.cat([1.0 - images[:1], images[1:]])
        loss = torch.mean((images - t) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach().float()))
        if grad1 is None:
            grad1 = {n: g.detach().float() for n, g in grads.items()}
        if fault != "frozen":
            params = {n: adams[n].step(leaves[n].detach(), grads[n].detach()) for n in leaves}
    return dict(losses=losses, grad1=grad1,
                params={n: p.detach().float() for n, p in params.items()})
