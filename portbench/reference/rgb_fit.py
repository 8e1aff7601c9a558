"""Plain reference of the textured, lit fit: camera, z-buffer, the
winner's planes, the atlas sampler, smoothed normals and lights, the NMR
approximate gradient over the RGB channels, flip/pool, the sum of squared
differences and Adam, in plain PyTorch.

It imports nothing of the program.  The camera, the exact z-buffer, the
winner's clamped weights, the NMR hook and Adam are the silhouette
reference's (``reference/silhouette_fit.py``), so the index maps are the
renderer's bits; the rest is written out here in the order the renderer
documents (Kato, Ushiku & Harada, "Neural 3D Mesh Renderer", CVPR 2018,
and the reference chainer/CUDA code it follows):

- per face: its screen x, y, its vertex depths z, its texel-coordinate
  triangle (u, v) and the smoothed normals of its vertices (face normals
  ``(v1 - v0) x (v2 - v1)`` of the NDC vertices, summed per vertex,
  normalised), each gathered at the winner of each pixel;
- the texel coordinates: perspective-correct, ``sum(w c / (z + 1e-10)) /
  sum(w / (z + 1e-10) + 1e-10)``, clamped into the face's uv bounding box
  less ``UV_EPS`` (the upper end), 0 on background;
- the bilinear sampler on the flattened atlas [3, th * tw]: anchor texel
  ``floor(y) tw + floor(x)``, clamped to [0, th tw - tw - 2] as a unit,
  its taps at +0, +1, +tw, +tw + 1 weighed (1 - fy)(1 - fx), (1 - fy) fx,
  fy (1 - fx), fy fx; the RGB 0 on background;
- the per-pixel normal ``sum(w n)`` (not renormalised) and the lights'
  colour weight: ambient ``c``, directional ``relu(-d . n) c``, specular
  ``relu(-n_z) ** alpha c``, summed in the configuration's order, times
  the RGB;
- the NMR hook on the RGB planes (the coordinate gradient sums the three
  channels), then the flip of H and W and the 2x2 mean.

The weights take no gradient (the renderer computes them in a grad-less
kernel), so the vertices take theirs through the NMR coordinate map, the
depths of the texel coordinates and the normals; the atlas through the
taps.  ``dtype`` runs every step in another floating type (the control).
"""

from __future__ import annotations

import torch

from portbench.reference import silhouette_fit as sil

# the renderer's eps (its default hyperparameter): the upper end of the
# texel-coordinate clamp
UV_EPS = 1e-5
DEPTH_EPS = 1e-10
# the per-face planes gathered at the winner: x, y of each vertex (6), z
# (3), u, v (6), normals (9)
XY, Z, UV, NORMALS = slice(0, 6), slice(6, 9), slice(9, 15), slice(15, 24)


def vertex_normals(ndc, faces):
    """Smoothed per-vertex normals [B, nv, 3] of NDC vertices ``ndc`` [B,
    nv, 3] and ``faces`` [nf, 3] (int64)."""
    fv = ndc[:, faces]
    n = torch.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 1], dim=-1)
    vn = torch.zeros_like(ndc).index_add(1, faces.reshape(-1), n.repeat_interleave(3, dim=1))
    norm = torch.sqrt(torch.sum(vn * vn, dim=2, keepdim=True))
    return vn / torch.clamp(norm, min=1e-12)


def uv_coords(z, u, v, w, fg, eps=UV_EPS):
    """Perspective-correct texel coordinates (x, y) [B, H, W] from the
    winner's triples of planes ``z``, ``u``, ``v`` and its weights ``w``;
    clamped into the face's uv bounding box less ``eps``, 0 on
    background."""
    zs = [zi + DEPTH_EPS for zi in z]
    depth = 1.0 / (w[0] / zs[0] + DEPTH_EPS + w[1] / zs[1] + DEPTH_EPS
                   + w[2] / zs[2] + DEPTH_EPS)

    def interp(c):
        val = (w[0] * c[0] / zs[0] + w[1] * c[1] / zs[1] + w[2] * c[2] / zs[2]) * depth
        lo = torch.minimum(torch.minimum(c[0], c[1]), c[2])
        hi = torch.maximum(torch.maximum(c[0], c[1]), c[2]) - eps
        return torch.where(fg, torch.minimum(hi, torch.maximum(lo, val)), 0.0)

    return interp(u), interp(v)


def sample(atlas, views, x, y, fg):
    """Bilinear RGB [B, 3, H, W] of ``atlas`` [O, 3, th, tw] at texel
    coordinates ``x``, ``y`` [B, H, W] (image b reads object b //
    ``views``'s atlas); 0 on background."""
    o, _, th, tw = atlas.shape
    bs = x.shape[0]
    texels = th * tw
    x0, y0 = torch.floor(x), torch.floor(y)
    wx0, wx1 = x0 + 1 - x, x - x0
    wy0, wy1 = y0 + 1 - y, y - y0
    anchor = torch.clamp(y0.long() * tw + x0.long(), 0, texels - tw - 2)
    base = (torch.arange(bs, device=x.device) // views * texels)[:, None, None]
    flat = atlas.reshape(o, 3, texels).transpose(0, 1).reshape(3, o * texels)
    rgb = 0.0
    for off, weight in ((0, wy0 * wx0), (1, wy0 * wx1), (tw, wy1 * wx0), (tw + 1, wy1 * wx1)):
        rgb = rgb + weight[:, None] * flat[:, base + anchor + off].transpose(0, 1)
    return torch.where(fg[:, None], rgb, 0.0)


def shade(rgb, normal, lights):
    """``rgb`` [B, 3, H, W] times the colour weight that ``lights`` (the
    task's: dicts of kind and [B, ...] tensors) give the per-pixel normals
    ``normal`` [B, 3, H, W]."""
    weight = torch.zeros_like(normal)
    for light in lights:
        color = light["color"].to(normal.dtype)[:, :, None, None]
        if light["kind"] == "ambient":
            weight = weight + color
            continue
        if light["kind"] == "directional":
            t = -light["direction"].to(normal.dtype)[:, :, None, None] * normal
            intensity = torch.relu(t[:, 0] + t[:, 1] + t[:, 2])
        else:
            intensity = torch.relu(-normal[:, 2]) ** light["alpha"].to(normal.dtype)[:, None, None]
        weight = weight + intensity[:, None] * color
    return rgb * weight


def render(vertices, atlas, inputs):
    """The fit's RGB images [B, 3, S, S] of ``vertices`` [O, nv, 3] and
    ``atlas`` [O, 3, th, tw] (as the renderer reads it: after the tanh)
    under ``inputs`` (see :func:`run`), differentiable through the NMR
    gradient."""
    faces = inputs["faces"].long()
    size = inputs["image_size"] * (2 if inputs["anti_aliasing"] else 1)
    views = inputs["views"]
    ndc = sil.views_ndc(vertices, inputs)                # [B, nv, 3]
    bs, nf = ndc.shape[0], faces.shape[0]
    fv = ndc[:, faces]                                   # [B, nf, 3, 3]
    index = sil.zbuffer(fv.detach(), size)               # [B, S, S]
    fg = index >= 0
    uv = inputs["vertices_t"].to(ndc.dtype)[inputs["faces_t"].long()]   # [nf, 3, 2]
    per_face = torch.cat((fv[..., :2].reshape(bs, nf, 6), fv[..., 2],
                          uv.reshape(1, nf, 6).expand(bs, nf, 6),
                          vertex_normals(ndc, faces)[:, faces].reshape(bs, nf, 9)), dim=2)
    safe = index.clamp(min=0).reshape(bs, -1, 1)
    g = torch.gather(per_face, 1, safe.expand(-1, -1, per_face.shape[2]))
    g = g.reshape(bs, size, size, -1).permute(0, 3, 1, 2)
    centres = sil.pixel_centres(size, ndc.dtype, ndc.device)
    xy = g[:, XY]
    w = sil.clamped_weights(tuple(xy.detach()[:, j] for j in range(6)), centres[None, :],
                            centres[:, None])
    w = torch.where(fg[:, None], w, torch.zeros_like(w))
    w = tuple(w[:, j] for j in range(3))
    cx = xy[:, 0] * w[0] + xy[:, 2] * w[1] + xy[:, 4] * w[2]
    cy = xy[:, 1] * w[0] + xy[:, 3] * w[1] + xy[:, 5] * w[2]
    z, uvp, n = g[:, Z], g[:, UV], g[:, NORMALS]
    x, y = uv_coords(tuple(z[:, j] for j in range(3)), (uvp[:, 0], uvp[:, 2], uvp[:, 4]),
                     (uvp[:, 1], uvp[:, 3], uvp[:, 5]), w, fg)
    rgb = sample(atlas, views, x, y, fg)
    normal = n[:, 0:3] * w[0][:, None] + n[:, 3:6] * w[1][:, None] + n[:, 6:9] * w[2][:, None]
    images = sil._Hook.apply(shade(rgb, normal, inputs["lights"]), torch.stack((cx, cy), dim=1))
    if inputs["anti_aliasing"]:
        images = (images[:, :, 0::2, 0::2] + images[:, :, 0::2, 1::2]
                  + images[:, :, 1::2, 0::2] + images[:, :, 1::2, 1::2]) * 0.25
    return images.flip(2, 3)


def l2_loss(images, targets):
    """The sum of squared differences over the batch."""
    return torch.sum((images - targets) ** 2)


def run(inputs, steps=3, dtype=torch.float32, fault=None):
    """``steps`` steps of the fit from ``inputs``: dict(leaves {"vertices":
    [O, nv, 3], "textures": [O, 3, th, tw] (the atlas before its tanh)},
    faces [nf, 3], eyes [B, 3], vertices_t [nvt, 2], faces_t [nf, 3],
    lights, targets [B, 3, S, S], views, viewing_angle, image_size,
    anti_aliasing, optimizer (lr, beta1, beta2, eps)).  Returns
    dict(losses [steps], grad1 and params, each {leaf: float32 tensor}).

    ``fault`` plants one of the faults the correctness check must catch:
    "half_batch" (the loss over the first half of the images only),
    "altered" (the first image inverted, 1 - x, where it is produced),
    "frozen" (the parameters never change)."""
    names = list(inputs["leaves"])
    params = {n: inputs["leaves"][n].to(dtype) for n in names}
    lights = [{k: (v.to(dtype) if torch.is_tensor(v) else v) for k, v in light.items()}
              for light in inputs["lights"]]
    inputs = dict(inputs, eyes=inputs["eyes"].to(dtype), lights=lights)
    targets = inputs["targets"].to(dtype)
    opt = inputs["optimizer"]
    adams = {n: sil.Adam(opt["lr"], opt["beta1"], opt["beta2"], opt["eps"]) for n in names}
    losses, grad1 = [], None
    for _ in range(steps):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        images = render(leaves["vertices"], torch.tanh(leaves["textures"]), inputs)
        t = targets
        if fault == "half_batch":
            half = images.shape[0] // 2
            images, t = images[:half], targets[:half]
        elif fault == "altered":
            images = torch.cat([1.0 - images[:1], images[1:]])
        loss = l2_loss(images, t)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        losses.append(float(loss.detach().float()))
        if grad1 is None:
            grad1 = {n: g.detach().float() for n, g in grads.items()}
        if fault != "frozen":
            params = {n: adams[n].step(leaves[n].detach(), grads[n].detach()) for n in names}
        del images, loss, grads, leaves
    return dict(losses=losses, grad1=grad1,
                params={n: p.detach().float() for n, p in params.items()})
