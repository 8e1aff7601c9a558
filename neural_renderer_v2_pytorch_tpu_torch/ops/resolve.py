"""Face-index (z-buffer) resolve and barycentric weight planes: the plain
PyTorch versions (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
resolve.py``).

The z-buffer rule is the reference's sequential one: faces are taken in id
order and a face wins a pixel when ``zp <= depth - 1e-4`` against the
running depth, so two faces within 1e-4 resolve to whichever came first.
That is not an argmin; the fold below keeps it exact by accepting face by
face.  Every expression is the JAX package's, in the same order, so on the
same float32 inputs the index maps are bit-identical.  The hand-written
kernels in ``resolve_cuda.py`` evaluate the same expressions per pixel.
"""

from __future__ import annotations

import functools

import torch

DEPTH_MIN_DELTA = 1e-4
DEGENERATE_EPS = 1e-8
# bbox written over a face that can never win: no pixel centre lies in
# (-1, 1) beyond these, so the strict bbox test rejects it everywhere
KILLED_BBOX = (4.0, -4.0, 4.0, -4.0)


def pixel_centres(indices, image_size):
    """Pixel-centre NDC coordinates ``(2*i + 1 - S) / S`` of integer pixel
    indices, float32 on the CPU.

    Computed on the CPU and moved by the callers: on CUDA, PyTorch divides by
    a Python scalar as a multiply by its reciprocal, which is not the
    correctly rounded quotient when S is not a power of two."""
    return (2.0 * indices.to(torch.float32) + 1.0 - image_size) / image_size


def _pixel_grid(image_size, device, row_start=0, num_rows=None):
    """Pixel centres: xp [1, S] over the columns, yp [num_rows, 1] over the
    rows ``row_start ..`` of a row window (the whole image by default).
    Shared by every caller, so read only."""
    if num_rows is None:
        num_rows = image_size
    return _pixel_grid_on(int(image_size), torch.device(device), int(row_start), int(num_rows))


# a step's grids are copied to the card once and kept (a captured step
# copies nothing from the host); a few grids per image size and row band
@functools.lru_cache(maxsize=64)
def _pixel_grid_on(image_size, device, row_start, num_rows):
    xp = pixel_centres(torch.arange(image_size), image_size).to(device)
    yp = pixel_centres(torch.arange(row_start, row_start + num_rows), image_size).to(device)
    return xp[None, :], yp[:, None]


def face_constants_planar(fvp):
    """Per-face constants [bs, 17, nf] from planar face vertices
    ``fvp`` [bs, 3 (coord x/y/z), 3 (vertex), nf]:
    (A0,B0,C0, A1,B1,C1, A2,B2,C2, 1/z0,1/z1,1/z2, det, xmin,xmax,ymin,ymax).
    Each pixel's scaled barycentric is ``w_i = yp*A_i + xp*B_i + C_i``."""
    x0, y0, z0 = fvp[:, 0, 0], fvp[:, 1, 0], fvp[:, 2, 0]
    x1, y1, z1 = fvp[:, 0, 1], fvp[:, 1, 1], fvp[:, 2, 1]
    x2, y2, z2 = fvp[:, 0, 2], fvp[:, 1, 2], fvp[:, 2, 2]
    C0 = x1 * y2 - x2 * y1
    C1 = x2 * y0 - x0 * y2
    C2 = x0 * y1 - x1 * y0
    return torch.stack(
        (
            x2 - x1, y1 - y2, C0,
            x0 - x2, y2 - y0, C1,
            x1 - x0, y0 - y1, C2,
            1.0 / z0, 1.0 / z1, 1.0 / z2,
            C0 + C1 + C2,
            torch.minimum(torch.minimum(x0, x1), x2),
            torch.maximum(torch.maximum(x0, x1), x2),
            torch.minimum(torch.minimum(y0, y1), y2),
            torch.maximum(torch.maximum(y0, y1), y2),
        ),
        dim=1,
    )


def face_backside(coef):
    """Backface predicate ``B1*A2 < B2*A1``, i.e.
    ``(y2-y0)*(x1-x0) < (y1-y0)*(x2-x0)``.  The sign follows the reference's
    golden images, not its kernel source (see the JAX package's note)."""
    A1, B1 = coef[3], coef[4]
    A2, B2 = coef[6], coef[7]
    return B1 * A2 < B2 * A1


def face_candidate(xp, yp, coef, iz, det, bbox, near, far):
    """Per-pixel accept math for one face: ``(out, zp)`` where ``out`` marks
    pixels the face does not cover (strict bbox reject, inside test on the
    signs of the scaled barycentrics, strict near/far clip that a NaN ``zp``
    fails) and ``zp`` is the perspective-correct candidate depth."""
    A0, B0, C0, A1, B1, C1, A2, B2, C2 = coef
    xmin, xmax, ymin, ymax = bbox
    out = (xp < xmin) | (xmax < xp) | (yp < ymin) | (ymax < yp)
    w0 = yp * A0 + xp * B0 + C0
    w1 = yp * A1 + xp * B1 + C1
    w2 = yp * A2 + xp * B2 + C2
    out = out | (w2 * w0 < 0)
    out = out | (w0 * w1 < 0)
    zp = det / (w0 * iz[0] + w1 * iz[1] + w2 * iz[2])
    out = out | ~((near < zp) & (zp < far))
    return out, zp


def kill_invalid(consts, draw_backside):
    """Write :data:`KILLED_BBOX` over degenerate (``|det| < 1e-8`` or NaN)
    faces, and over backfacing ones unless ``draw_backside``, so that the
    per-pixel bbox test rejects them with no per-face predicate."""
    coef = tuple(consts[:, j] for j in range(9))
    valid = torch.abs(consts[:, 12]) >= DEGENERATE_EPS
    if not draw_backside:
        valid = valid & ~face_backside(coef)
    bbox = [
        torch.where(valid, consts[:, 13 + j], v) for j, v in enumerate(KILLED_BBOX)
    ]
    return torch.cat([consts[:, :13], torch.stack(bbox, dim=1)], dim=1)


def resolve_constants(consts, image_size, near, far, face_chunk=16, row_start=0,
                      num_rows=None):
    """Sequential z-buffer fold over killed per-face constants [bs, 17, nf]
    (see :func:`kill_invalid`), over the image rows ``row_start ..
    row_start + num_rows`` (the whole image by default).  Returns (index
    [bs, num_rows, S] int32 with -1 on background, depth [bs, num_rows, S]
    float32 with ``far`` on background).

    Candidate depths are computed ``face_chunk`` faces at a time; the accept
    rule then runs face by face, in id order."""
    bs, _, nf = consts.shape
    if num_rows is None:
        num_rows = image_size
    xp, yp = _pixel_grid(image_size, consts.device, row_start, num_rows)
    depth = torch.full((bs, num_rows, image_size), far, dtype=torch.float32,
                       device=consts.device)
    index = torch.full((bs, num_rows, image_size), -1, dtype=torch.int32,
                       device=consts.device)
    for start in range(0, nf, face_chunk):
        cs = consts[:, :, start:start + face_chunk].permute(2, 0, 1)[..., None, None]
        c = tuple(cs[:, :, j] for j in range(17))         # each [K, bs, 1, 1]
        out, zp = face_candidate(xp, yp, c[:9], c[9:12], c[12], c[13:17], near, far)
        zcand = torch.where(out, torch.inf, zp)
        for k in range(zcand.shape[0]):
            accept = zcand[k] <= depth - DEPTH_MIN_DELTA
            depth = torch.where(accept, zcand[k], depth)
            index = torch.where(accept, start + k, index)
    return index, depth


def _clamped_weights(xy, xp, yp, dim):
    """The reference weight kernel's math (rasterize_cuda_kernel.cu:286-306)
    on the winner's screen coordinates ``xy`` = (x0, y0, x1, y1, x2, y2):
    flip the sign when the weights sum below 0, clamp each to >= 0,
    renormalize, clamp to [0, 1]; the three weights stacked along ``dim``."""
    x0, y0, x1, y1, x2, y2 = xy
    w0 = yp * (x2 - x1) + xp * (y1 - y2) + (x1 * y2 - x2 * y1)
    w1 = yp * (x0 - x2) + xp * (y2 - y0) + (x2 * y0 - x0 * y2)
    w2 = yp * (x1 - x0) + xp * (y0 - y1) + (x0 * y1 - x1 * y0)
    w = torch.stack((w0, w1, w2), dim=dim)

    def total(w):
        return w.narrow(dim, 0, 1) + w.narrow(dim, 1, 1) + w.narrow(dim, 2, 1)

    w = torch.where(total(w) < 0, -w, w)
    w = torch.clamp(w, min=0.0)
    return torch.clamp(w / total(w), 0.0, 1.0)


def weight_planes_from_gathered(fvm_planar, face_index_map, image_size=None, row_start=0):
    """Clamped, renormalized barycentric weights [bs, 3, H, W] from planar
    latched winner coordinates [bs, 9, H, W] of the image rows ``row_start
    .. row_start + H``; 0 on background and gradient-stopped (the reference
    computes them in a grad-less kernel)."""
    H, W = fvm_planar.shape[2:]
    if image_size is None:
        image_size = W
    xp, yp = _pixel_grid(image_size, fvm_planar.device, row_start, H)
    g = fvm_planar.detach()
    w = _clamped_weights((g[:, 0], g[:, 1], g[:, 3], g[:, 4], g[:, 6], g[:, 7]), xp, yp, 1)
    return torch.where((face_index_map >= 0)[:, None], w, 0.0)


def coordinate_planes(fvm_planar, weight_planes):
    """Barycentric screen-XY map [bs, 2, H, W] from latched winner
    coordinates [bs, 9, H, W] and weights [bs, 3, H, W].  The NMR backward
    reaches the vertices only through this map (the weights are a stopped
    constant)."""
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    cx = fvm_planar[:, 0] * w0 + fvm_planar[:, 3] * w1 + fvm_planar[:, 6] * w2
    cy = fvm_planar[:, 1] * w0 + fvm_planar[:, 4] * w1 + fvm_planar[:, 7] * w2
    return torch.stack((cx, cy), dim=1)


def weight_map_from_gathered(face_vertex_map, face_index_map, image_size=None, row_start=0):
    """The weights [bs, H, W, 3] of :func:`weight_planes_from_gathered` from
    the winner's vertices in the JAX package's NHWC layout [bs, H, W, 3, 3]
    (vertex, coordinate); 0 on background, gradient-stopped."""
    H, W = face_index_map.shape[1:]
    if image_size is None:
        image_size = W
    xp, yp = _pixel_grid(image_size, face_vertex_map.device, row_start, H)
    g = face_vertex_map.detach()
    xy = (g[..., 0, 0], g[..., 0, 1], g[..., 1, 0], g[..., 1, 1], g[..., 2, 0], g[..., 2, 1])
    w = _clamped_weights(xy, xp, yp, -1)
    return torch.where((face_index_map >= 0)[..., None], w, 0.0)


def compute_weight_map(faces, face_index_map, image_size=None, row_start=0):
    """The winning face's weights [bs, H, W, 3] from [bs, nf, 3, 3] faces and
    an index map [bs, H, W] of the image rows ``row_start .. row_start +
    H``; 0 on background, gradient-stopped."""
    bs, H, W = face_index_map.shape
    safe = torch.clamp(face_index_map, min=0).long().reshape(bs, -1, 1)
    flat = faces.detach().reshape(bs, -1, 9)
    g = torch.gather(flat, 1, safe.expand(-1, -1, 9)).reshape(bs, H, W, 3, 3)
    return weight_map_from_gathered(g, face_index_map, image_size, row_start)
