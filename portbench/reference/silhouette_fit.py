"""Plain reference of the silhouette fit: camera, z-buffer, NMR
approximate gradient, 1 - IoU loss and Adam, in plain PyTorch.

It imports nothing of the program.  Each expression is written out here,
in the order the renderer documents (Kato, Ushiku & Harada, "Neural 3D
Mesh Renderer", CVPR 2018, and the reference chainer/CUDA code it
follows), so that on the same float32 inputs the index maps are the
same bits as the renderer's:

- camera: ``look_at`` (rows of R are the camera axes, ``(v - eye) R^T``
  as elementwise multiply-adds) then the perspective divide by ``z *
  tan(angle)`` with the reference's literal 3.1416;
- z-buffer: faces in id order, a face wins a pixel when ``zp <= depth -
  1e-4`` against the running depth (not an argmin); a face with ``|det| <
  1e-8`` (or NaN) never wins; the pixel centres are ``(2 i + 1 - S) / S``;
- the winner's clamped, renormalised barycentric weights (gradient
  stopped) times its screen x, y give the coordinate map, the only path
  of the gradient to the vertices;
- the NMR hook: identity forward; backward from neighbouring-pixel
  intensity differences, with the reference's ``maximum`` tie-break;
- flip of H and W, then the 2x2 mean with anti-aliasing.

Candidate (pixel, face) pairs are enumerated from each face's bounding
box, and the sequential rule is then run over each pixel's candidates in
face order, one rank of candidates at a time, so the fold is exact at any
mesh size.

``dtype`` runs every arithmetic step in another floating type (the
lower-precision control); comparisons against pixel centres are made on
the values as that type holds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DEPTH_MIN_DELTA = 1e-4
DEGENERATE_EPS = 1e-8
NEAR, FAR = 0.1, 100.0
IOU_EPS = 1e-6
# candidate pairs handled at once by the z-buffer
PAIR_BLOCK = 1 << 24


def _normalize(x):
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)


def camera(vertices, eyes, viewing_angle):
    """World vertices [B, nv, 3] seen from ``eyes`` [B, 3] -> NDC [B, nv, 3]."""
    dtype, device = vertices.dtype, vertices.device
    bs = vertices.shape[0]
    at = torch.zeros((bs, 3), dtype=dtype, device=device)
    up = torch.tensor((0.0, 1.0, 0.0), dtype=dtype, device=device)[None].expand(bs, 3)
    z_axis = _normalize(at - eyes)
    x_axis = _normalize(torch.cross(up, z_axis, dim=-1))
    y_axis = _normalize(torch.cross(z_axis, x_axis, dim=-1))
    r = torch.stack((x_axis, y_axis, z_axis), dim=1)[:, :, None, :]   # [B, 3, 1, 3]
    v = vertices - eyes[:, None, :]
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    v = torch.stack([x * r[:, i, :, 0] + y * r[:, i, :, 1] + z * r[:, i, :, 2]
                     for i in range(3)], dim=-1)
    angle = torch.tensor(float(viewing_angle), dtype=dtype).to(device)
    width = torch.tan(angle / 180.0 * 3.1416)
    z = v[:, :, 2]
    return torch.stack((v[:, :, 0] / z / width, v[:, :, 1] / z / width, z), dim=2)


def pixel_centres(size, dtype, device):
    """NDC centres of pixels 0 .. size - 1, divided on the CPU (exact)."""
    i = torch.arange(size, dtype=torch.float32)
    return ((2.0 * i + 1.0 - size) / size).to(dtype).to(device)


def face_constants(fv):
    """fv [B, nf, 3 (vertex), 3 (coord)] -> (coef [9, B, nf], iz [3, B, nf],
    det [B, nf], bbox [4, B, nf] (xmin, xmax, ymin, ymax))."""
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]
    c0 = x1 * y2 - x2 * y1
    c1 = x2 * y0 - x0 * y2
    c2 = x0 * y1 - x1 * y0
    coef = torch.stack((x2 - x1, y1 - y2, c0, x0 - x2, y2 - y0, c1, x1 - x0, y0 - y1, c2))
    iz = torch.stack((1.0 / z0, 1.0 / z1, 1.0 / z2))
    det = c0 + c1 + c2
    bbox = torch.stack((torch.minimum(torch.minimum(x0, x1), x2),
                        torch.maximum(torch.maximum(x0, x1), x2),
                        torch.minimum(torch.minimum(y0, y1), y2),
                        torch.maximum(torch.maximum(y0, y1), y2)))
    return coef, iz, det, bbox


def bbox_spans(bbox, valid, centres):
    """For each face, the first pixel and the count of pixels whose centre
    lies in [lo, hi] along one axis: (start [B, nf], count [B, nf]); 0 for
    a face that never wins."""
    c = centres.float()
    lo, hi = bbox[0].float().contiguous(), bbox[1].float().contiguous()
    start = torch.searchsorted(c, lo)
    count = (torch.searchsorted(c, hi, right=True) - start).clamp(min=0)
    count = torch.where(valid, count, torch.zeros_like(count))
    return start, count


def zbuffer(fv, size, near=NEAR, far=FAR):
    """Face index map [B, size, size] int64 (-1 on background) of NDC face
    vertices ``fv`` [B, nf, 3, 3], rows bottom-up as NDC y (the image is
    flipped later), under the sequential accept rule."""
    dtype, device = fv.dtype, fv.device
    bs, nf = fv.shape[:2]
    with torch.no_grad():
        coef, iz, det, bbox = face_constants(fv)
        centres = pixel_centres(size, dtype, device)
        valid = torch.abs(det) >= DEGENERATE_EPS
        x0, nx = bbox_spans(bbox[0:2], valid, centres)
        y0, ny = bbox_spans(bbox[2:4], valid, centres)
        n = (nx * ny).reshape(-1)
        depth = torch.full((bs * size * size,), far, dtype=dtype, device=device)
        index = torch.full((bs * size * size,), -1, dtype=torch.int64, device=device)
        # the (image, face) pairs in blocks whose candidates fit PAIR_BLOCK,
        # in order: each image's faces follow in id order across the blocks
        ends = torch.cumsum(n, 0)
        total = int(ends[-1]) if n.numel() else 0
        face_start = 0
        while face_start < bs * nf and total:
            base = int(ends[face_start - 1]) if face_start else 0
            face_end = int(torch.searchsorted(ends, base + PAIR_BLOCK, right=True))
            face_end = max(face_end, face_start + 1)
            _fold_block(face_start, face_end, n, nx, x0, y0, coef, iz, det, centres, size, nf,
                        near, far, depth, index)
            face_start = face_end
        return index.reshape(bs, size, size)


def _fold_block(f0, f1, n, nx, x0, y0, coef, iz, det, centres, size, nf, near, far, depth,
                index):
    device = n.device
    counts = n[f0:f1]
    flat = torch.arange(f0, f1, device=device)
    pair_face = torch.repeat_interleave(flat, counts)
    if not pair_face.numel():
        return
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(pair_face.numel(), device=device) - torch.repeat_interleave(first, counts)
    w = nx.reshape(-1)[pair_face]
    px = x0.reshape(-1)[pair_face] + k % w
    py = y0.reshape(-1)[pair_face] + k // w
    b, f = pair_face // nf, pair_face % nf
    xp, yp = centres[px], centres[py]
    c = [t.reshape(-1)[pair_face] for t in coef]
    z = [t.reshape(-1)[pair_face] for t in iz]
    a0, b0, c0, a1, b1, c1, a2, b2, c2 = c
    w0 = yp * a0 + xp * b0 + c0
    w1 = yp * a1 + xp * b1 + c1
    w2 = yp * a2 + xp * b2 + c2
    out = (w2 * w0 < 0) | (w0 * w1 < 0)
    zp = det.reshape(-1)[pair_face] / (w0 * z[0] + w1 * z[1] + w2 * z[2])
    out = out | ~((near < zp) & (zp < far))
    keep = ~out
    pixel = (b * size + py) * size + px
    pixel, f, zp = pixel[keep], f[keep], zp[keep]
    if not pixel.numel():
        return
    order = torch.argsort(pixel * nf + f)
    pixel, f, zp = pixel[order], f[order], zp[order]
    # rank of each candidate among its pixel's, in face order
    new = torch.ones_like(pixel, dtype=torch.bool)
    new[1:] = pixel[1:] != pixel[:-1]
    starts = torch.nonzero(new)[:, 0]
    run = torch.cumsum(new.long(), 0) - 1
    rank = torch.arange(pixel.numel(), device=device) - starts[run]
    for r in range(int(rank.max()) + 1):
        at = rank == r
        p, zr, fr = pixel[at], zp[at], f[at]
        accept = zr <= depth[p] - DEPTH_MIN_DELTA
        depth[p[accept]] = zr[accept]
        index[p[accept]] = fr[accept]


def clamped_weights(xy, xp, yp):
    """The winner's three weights [B, 3, H, W] from its screen x, y
    (x0, y0, x1, y1, x2, y2): sign flipped when they sum below 0, clamped
    at 0, renormalised, clamped to [0, 1]."""
    x0, y0, x1, y1, x2, y2 = xy
    w0 = yp * (x2 - x1) + xp * (y1 - y2) + (x1 * y2 - x2 * y1)
    w1 = yp * (x0 - x2) + xp * (y2 - y0) + (x2 * y0 - x0 * y2)
    w2 = yp * (x1 - x0) + xp * (y0 - y1) + (x0 * y1 - x1 * y0)
    w = torch.stack((w0, w1, w2), dim=1)

    def total(w):
        return w[:, 0:1] + w[:, 1:2] + w[:, 2:3]

    w = torch.where(total(w) < 0, -w, w)
    w = torch.clamp(w, min=0.0)
    return torch.clamp(w / total(w), 0.0, 1.0)


def nmr_maximum(right, left, eps=1e-4):
    zero = (torch.maximum(right, left) <= 0) | (torch.abs(right - left) < eps)
    picked = torch.where(right > left, -right, left)
    return torch.where(zero, torch.zeros_like(right), picked)


def coordinate_grad(images, grad):
    """The NMR gradient of the coordinate map [B, 2, H, W] (x, y) from the
    images and their incoming gradient [B, C, H, W]."""
    step = torch.full((), 2.0 / images.shape[2], dtype=images.dtype, device=images.device)

    def pair(dim):
        n = images.shape[dim] - 1
        i0, i1 = images.narrow(dim, 0, n), images.narrow(dim, 1, n)
        g0, g1 = grad.narrow(dim, 0, n), grad.narrow(dim, 1, n)
        return -torch.sum((i0 - i1) * g1, dim=1) / step, -torch.sum((i1 - i0) * g0, dim=1) / step

    yr, yl = (F.pad(g, (0, 0, 1, 1)) for g in pair(2))
    grad_y = nmr_maximum(yr[:, 1:] + yr[:, :-1], yl[:, :-1] + yl[:, 1:])
    xr, xl = pair(3)
    grad_x = nmr_maximum(F.pad(xr, (0, 1)) + F.pad(xr, (1, 0)),
                         F.pad(xl, (1, 0)) + F.pad(xl, (0, 1)))
    return torch.stack((grad_x, grad_y), dim=1)


class _Hook(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, coordinates):
        ctx.save_for_backward(images)
        return images.clone()

    @staticmethod
    def backward(ctx, grad):
        (images,) = ctx.saved_tensors
        return grad, coordinate_grad(images, grad)


def silhouettes(ndc, faces, image_size, anti_aliasing):
    """Silhouettes [B, image_size, image_size] of NDC vertices [B, nv, 3],
    differentiable through the NMR gradient."""
    size = image_size * 2 if anti_aliasing else image_size
    bs = ndc.shape[0]
    fv = ndc[:, faces]                                   # [B, nf, 3, 3]
    index = zbuffer(fv.detach(), size)                   # [B, S, S]
    fg = index >= 0
    safe = index.clamp(min=0).reshape(bs, -1, 1)
    flat = fv[..., :2].reshape(bs, -1, 6)
    g = torch.gather(flat, 1, safe.expand(-1, -1, 6)).reshape(bs, size, size, 6)
    g = g.permute(0, 3, 1, 2)                            # x0 y0 x1 y1 x2 y2 planes
    centres = pixel_centres(size, ndc.dtype, ndc.device)
    xp, yp = centres[None, :], centres[:, None]
    gd = g.detach()
    w = clamped_weights(tuple(gd[:, j] for j in range(6)), xp, yp)
    w = torch.where(fg[:, None], w, torch.zeros_like(w))
    cx = g[:, 0] * w[:, 0] + g[:, 2] * w[:, 1] + g[:, 4] * w[:, 2]
    cy = g[:, 1] * w[:, 0] + g[:, 3] * w[:, 1] + g[:, 5] * w[:, 2]
    images = _Hook.apply(fg[:, None].to(ndc.dtype), torch.stack((cx, cy), dim=1))
    if anti_aliasing:
        images = (images[:, :, 0::2, 0::2] + images[:, :, 0::2, 1::2]
                  + images[:, :, 1::2, 0::2] + images[:, :, 1::2, 1::2]) * 0.25
    return images.flip(2, 3)[:, 0]


def iou_loss(images, targets):
    """mean over images of 1 - sum(s t) / (sum(s + t - s t) + eps)."""
    inter = torch.sum(images * targets, dim=(1, 2))
    union = torch.sum(images + targets - images * targets, dim=(1, 2))
    return torch.mean(1.0 - inter / (union + IOU_EPS))


class Adam:
    """Adam on one tensor, float arithmetic in the tensor's type:
    m = b1 m + (1 - b1) g; v = max(b2 v + (1 - b2) g g, 0);
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, lr, beta1=0.9, beta2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m = self.v = None
        self.t = 0

    def step(self, p, g):
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        t = torch.tensor(float(self.t), dtype=p.dtype, device=p.device)
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = torch.clamp(self.b2 * self.v + (1 - self.b2) * g * g, min=0.0)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=p.dtype, device=p.device), t)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=p.dtype, device=p.device), t)
        return p - self.lr * (self.m / bc1) / (torch.sqrt(self.v / bc2) + self.eps)


def views_ndc(params, inputs):
    """NDC vertices [B, nv, 3] of each image: object o of ``params`` [O, nv,
    3] seen from its ``views`` cameras in turn."""
    o, nv = params.shape[:2]
    views = inputs["views"]
    x = params[:, None].expand(o, views, nv, 3).reshape(o * views, nv, 3)
    return camera(x, inputs["eyes"], inputs["viewing_angle"])


def forward_images(params, inputs):
    """The fit's silhouettes [B, S, S] of ``params`` [O, nv, 3] under
    ``inputs`` (see :func:`run`)."""
    return silhouettes(views_ndc(params, inputs), inputs["faces"], inputs["image_size"],
                       inputs["anti_aliasing"])


def run(inputs, steps=3, dtype=torch.float32, fault=None):
    """``steps`` steps of the fit from ``inputs``: dict(leaves
    {"vertices": [O, nv, 3] float32}, faces [nf, 3], eyes [B, 3], targets
    [B, S, S], views, viewing_angle, image_size, anti_aliasing, optimizer
    (lr, beta1, beta2, eps)).  Returns dict(losses
    [steps], grad1 {"vertices": the first step's gradient}, params
    {"vertices": after the last step}), float32.

    ``fault`` plants one of the faults the correctness check must catch:
    "half_batch" (the loss over the first half of the images only),
    "altered" (the first image's silhouette inverted, 1 - s, where it is
    produced), "frozen" (the parameters never change)."""
    p = inputs["leaves"]["vertices"].to(dtype)
    inputs = dict(inputs, faces=inputs["faces"].long())
    eyes, targets = inputs["eyes"].to(dtype), inputs["targets"].to(dtype)
    opt = inputs["optimizer"]
    adam = Adam(opt["lr"], opt["beta1"], opt["beta2"], opt["eps"])
    losses, grad1 = [], None
    for _ in range(steps):
        leaf = p.detach().requires_grad_(True)
        images = forward_images(leaf, dict(inputs, eyes=eyes))
        t = targets
        if fault == "half_batch":
            half = images.shape[0] // 2
            images, t = images[:half], targets[:half]
        elif fault == "altered":
            images = torch.cat([1.0 - images[:1], images[1:]])
        loss = iou_loss(images, t)
        (g,) = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach().float()))
        if grad1 is None:
            grad1 = g.detach().float()
        if fault != "frozen":
            p = adam.step(leaf.detach(), g.detach())
    return dict(losses=losses, grad1={"vertices": grad1}, params={"vertices": p.detach().float()})
