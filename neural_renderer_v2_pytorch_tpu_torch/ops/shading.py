"""Channel-planar shading maps: coordinates, depth, texture sampling,
normals and lights (counterpart of the planar functions of
``neural_renderer_v2_pytorch_tpu/ops/shading.py``).

Plain PyTorch, as the JAX package leaves this layer to XLA, except the
texture-atlas gradient, which is kernel K6 (:func:`resolve_cuda.
scatter_rows`).  Every expression is the JAX package's, in the same order
and association, so on the CPU the two agree to the last bit where each op
is correctly rounded (division by tensors only, sums of three written out).
"""

from __future__ import annotations

import torch

from ..models import lights as light_lib
from .maps import cross
from .resolve_cuda import scatter_rows


def coordinate_planes(fvm_planar, weight_planes):
    """Barycentric screen-XY map [bs, 2, H, W] from latched winner
    coordinates [bs, 9, H, W] and weights [bs, 3, H, W].  The NMR backward
    reaches the vertices only through this map (the weights are a stopped
    constant)."""
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    cx = fvm_planar[:, 0] * w0 + fvm_planar[:, 3] * w1 + fvm_planar[:, 6] * w2
    cy = fvm_planar[:, 1] * w0 + fvm_planar[:, 4] * w1 + fvm_planar[:, 7] * w2
    return torch.stack((cx, cy), dim=1)


def depth_plane(fvm_planar, face_index_map, weight_planes):
    """Perspective-correct depth [bs, 1, H, W], 0 on background."""
    z0, z1, z2 = fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]
    w0, w1, w2 = weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]
    d = 1.0 / (w0 / z0 + w1 / z1 + w2 / z2)
    return torch.where((face_index_map >= 0)[:, None], d[:, None], 0.0)


def _uv_coords(z, u, v, w, fg, eps):
    """Perspective-correct texel coordinates (x, y) [bs, H, W], clamped into
    the winning face's uv-bbox minus ``eps``, 0 on background.  ``z``,
    ``u``, ``v`` and ``w`` are triples of [bs, H, W] planes (one per face
    vertex); ``fg`` is the foreground mask."""
    depth = 1.0 / (
        w[0] / (z[0] + 1e-10) + 1e-10
        + w[1] / (z[1] + 1e-10) + 1e-10
        + w[2] / (z[2] + 1e-10) + 1e-10
    )

    def interp(c):
        val = (
            w[0] * c[0] / (z[0] + 1e-10)
            + w[1] * c[1] / (z[1] + 1e-10)
            + w[2] * c[2] / (z[2] + 1e-10)
        ) * depth
        lo = torch.minimum(torch.minimum(c[0], c[1]), c[2])
        hi = torch.maximum(torch.maximum(c[0], c[1]), c[2]) - eps
        # jnp.clip's order, and torch's even split of the gradient at ties
        return torch.where(fg, torch.minimum(hi, torch.maximum(lo, val)), 0.0)

    return interp(u), interp(v)


def _bilinear_taps(x, y):
    """Floor texel coordinates (int32) and the four bilinear weights, in the
    order floor/floor, floor-y/ceil-x, ceil-y/floor-x, ceil/ceil."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx0, wx1 = x0f + 1 - x, x - x0f
    wy0, wy1 = y0f + 1 - y, y - y0f
    return (x0f.to(torch.int32), y0f.to(torch.int32),
            (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1))


class _AtlasTaps(torch.autograd.Function):
    """The four bilinear taps [bs, 4, 3, P] of a flattened atlas [bs, 3, T]
    at anchor texels ``idx00`` [bs, P] (the others are +1, +tw, +tw+1).
    The anchor is clamped to [0, T - tw - 2] as a unit, so all four taps
    stay in the atlas (texel coordinates must lie in [0, tw-1] x [0, th-1]).

    The backward scatters all four taps' gradients as 12 channels at the
    anchor (kernel K6), then folds the quad channels onto their texels
    with three shifted adds, in the JAX package's order.  A negative
    ``idx00`` marks a pixel whose gradient is 0 (background): it reads the
    anchor 0 and scatters nothing.  (The JAX package adds its zeros at
    texel 0; with atomics, hundreds of thousands of them there serialise
    on one address.)"""

    @staticmethod
    def forward(ctx, flat, idx00, tw):
        T = flat.shape[-1]
        anchors = torch.clamp(idx00, 0, T - tw - 2)
        ctx.save_for_backward(torch.where(idx00 < 0, -1, anchors))
        ctx.tw = tw
        ctx.num_texels = T
        a = anchors.long()[:, None].expand(-1, 3, -1)
        return torch.stack(
            [torch.gather(flat, 2, a + off) for off in (0, 1, tw, tw + 1)], dim=1
        )

    @staticmethod
    def backward(ctx, grad):
        (anchors,) = ctx.saved_tensors            # -1: scatter nothing
        tw, T = ctx.tw, ctx.num_texels
        bs, P = anchors.shape
        quad = scatter_rows(grad.reshape(bs, 12, P).contiguous(),
                            anchors.to(torch.int32).contiguous(), T)   # [bs, T, 12]
        # anchor t contributed to texels t, t+1, t+tw, t+tw+1; in place on
        # one buffer, each texel summed as q0 + q1 + q_tw + q_tw1
        g = quad[..., 0:3].clone()
        g[:, 1:] += quad[:, : T - 1, 3:6]
        g[:, tw:] += quad[:, : T - tw, 6:9]
        g[:, tw + 1:] += quad[:, : T - tw - 1, 9:12]
        return g.transpose(1, 2), None, None


def sample_textures_atlas_planes(fvm_planar, uv_planes, textures, face_index_map,
                                 weight_planes, eps):
    """Bilinear sampling from a general (loaded) atlas: RGB [bs, 3, H, W].

    ``fvm_planar`` [bs, 9, H, W] latched winner coordinates (z on planes 2,
    5, 8); ``uv_planes`` [bs, 6, H, W] its texel-coordinate triangle
    u0,v0,u1,v1,u2,v2; ``textures`` [bs, 3, th, tw], differentiable;
    ``weight_planes`` [bs, 3, H, W]."""
    bs, _, H, W = fvm_planar.shape
    th, tw = textures.shape[2:]
    fg = face_index_map >= 0
    x, y = _uv_coords(
        (fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]),
        (uv_planes[:, 0], uv_planes[:, 2], uv_planes[:, 4]),
        (uv_planes[:, 1], uv_planes[:, 3], uv_planes[:, 5]),
        (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]),
        fg, eps,
    )
    x0, y0, tap_w = _bilinear_taps(x, y)
    flat = textures.reshape(bs, 3, th * tw)
    idx00 = torch.where(fg, y0 * tw + x0, -1).reshape(bs, H * W)
    taps4 = _AtlasTaps.apply(flat, idx00, tw).reshape(bs, 4, 3, H, W)
    images = sum(w[:, None] * taps4[:, i] for i, w in enumerate(tap_w))
    return torch.where(fg[:, None], images, 0.0)


def face_texel_attrs(textures, num_faces, texture_size):
    """Per-face texel patches [bs, nf, ts*ts*3] of a ``create_textures``
    atlas [bs, 3, th*ts, tw*ts] (face f owns the patch at grid cell
    (f // tw, f % tw)); texel t = y_local * ts + x_local, channel-minor."""
    bs = textures.shape[0]
    ts = texture_size
    th = textures.shape[2] // ts
    tw = textures.shape[3] // ts
    t = textures.reshape(bs, 3, th, ts, tw, ts).permute(0, 2, 4, 3, 5, 1)
    return t.reshape(bs, th * tw, ts * ts * 3)[:, :num_faces]


def sample_textures_texel_planes(fvm_planar, uv_planes, texel_planes, face_index_map,
                                 weight_planes, eps, texture_size, tile_width):
    """Bilinear sampling from the winner's latched texel patch
    ``texel_planes`` [bs, ts*ts*3, H, W] (``create_textures`` atlases):
    RGB [bs, 3, H, W].  Other arguments as
    :func:`sample_textures_atlas_planes`."""
    ts = texture_size
    fg = face_index_map >= 0
    x_f, y_f = _uv_coords(
        (fvm_planar[:, 2], fvm_planar[:, 5], fvm_planar[:, 8]),
        (uv_planes[:, 0], uv_planes[:, 2], uv_planes[:, 4]),
        (uv_planes[:, 1], uv_planes[:, 3], uv_planes[:, 5]),
        (weight_planes[:, 0], weight_planes[:, 1], weight_planes[:, 2]),
        fg, eps,
    )
    # patch-local texel coordinates of the winning face
    fid = torch.clamp(face_index_map, min=0)
    x_f = x_f - ((fid % tile_width) * ts).to(torch.float32)
    y_f = y_f - ((fid // tile_width) * ts).to(torch.float32)
    x0, y0, tap_w = _bilinear_taps(x_f, y_f)

    bs = texel_planes.shape[0]
    texels = texel_planes.reshape(bs, ts * ts, 3, *texel_planes.shape[2:])
    if ts == 2:
        # the clamp pins local coordinates to [0, 1 - eps]: floor 0, ceil
        # 1, so the taps are the four patch texels
        taps = tuple(texels[:, t] for t in range(4))
    else:
        # ceil may weigh 0 at the bbox edge; the clip keeps it in the patch
        xi_f = torch.clamp(x0, 0, ts - 1)
        yi_f = torch.clamp(y0, 0, ts - 1)
        xi_c = torch.clamp(xi_f + 1, 0, ts - 1)
        yi_c = torch.clamp(yi_f + 1, 0, ts - 1)
        texel_ids = torch.arange(ts * ts, device=texels.device)[None, :, None, None]

        def tap(xi, yi):
            sel = (yi * ts + xi)[:, None] == texel_ids             # [bs, ts*ts, H, W]
            return torch.sum(sel[:, :, None] * texels, dim=1)

        taps = (tap(xi_f, yi_f), tap(xi_c, yi_f), tap(xi_f, yi_c), tap(xi_c, yi_c))
    images = sum(w[:, None] * t for w, t in zip(tap_w, taps))
    return torch.where(fg[:, None], images, 0.0)


def face_vertex_normals(vertices, faces, face_vertices):
    """Smoothed per-face per-vertex normals [bs, nf, 3 (vertex), 3 (xyz)]
    from the planar face vertices [bs, 3, 3, nf]: face normals by cross
    products, summed per vertex, normalised, gathered per face.

    The per-vertex sum is a segment sum over the face-major slots grouped
    by vertex (a stable sort keeps each vertex's slots in order), so it
    adds in the JAX package's segment-sum order and, unlike an atomic
    ``index_add_`` on CUDA, gives the same bits on every run."""
    bs, nv = vertices.shape[:2]
    v01 = face_vertices[:, :, 1] - face_vertices[:, :, 0]          # [bs, 3, nf]
    v12 = face_vertices[:, :, 2] - face_vertices[:, :, 1]
    n = cross(v01, v12, dim=1).permute(0, 2, 1)                    # [bs, nf, 3]
    ids = faces.long()
    slots = ids.reshape(-1)
    order = torch.argsort(slots, stable=True)
    counts = torch.bincount(slots, minlength=nv)
    vn = torch.segment_reduce(n.repeat_interleave(3, dim=1)[:, order], "sum",
                              lengths=counts.expand(bs, nv), axis=1)
    norm = torch.sqrt(torch.sum(vn * vn, dim=2, keepdim=True))
    vn = vn / torch.clamp(norm, min=1e-12)
    return vn[:, ids]


def normal_planes(normal_vertex_planes, weight_planes):
    """Smoothed per-pixel normals [bs, 3, H, W] from the latched per-vertex
    normals [bs, 9, H, W] (plane 3 * vertex + xyz)."""
    n = normal_vertex_planes.reshape(
        normal_vertex_planes.shape[0], 3, 3, *normal_vertex_planes.shape[2:]
    )
    t = weight_planes[:, :, None] * n
    return t[:, 0] + t[:, 1] + t[:, 2]


def _abs(x):
    """``|x|`` whose gradient at 0 is +1, as ``jnp.abs``'s (torch.abs's is 0)."""
    return torch.where(x >= 0, x, -x)


def apply_lights_planar(rgb_planes, normal_map_planes, lights):
    """RGB [bs, 3, H, W] times the colour weight that ``lights`` give the
    normals [bs, 3, H, W] (reference rasterize.py:252-283).  An empty
    ``lights`` gives black."""
    color_weight = torch.zeros_like(normal_map_planes)
    for light in lights:
        if isinstance(light, light_lib.AmbientLight):
            color_weight = color_weight + light.color[:, :, None, None]
        elif isinstance(light, light_lib.DirectionalLight):
            t = -light.direction[:, :, None, None] * normal_map_planes
            intensity = t[:, 0] + t[:, 1] + t[:, 2]
            intensity = _abs(intensity) if light.backside else torch.relu(intensity)
            color_weight = color_weight + intensity[:, None] * light.color[:, :, None, None]
        elif isinstance(light, light_lib.SpecularLight):
            intensity = -normal_map_planes[:, 2]       # (0, 0, 1) . -normal
            intensity = _abs(intensity) if light.backside else torch.relu(intensity)
            alpha = light.alpha
            if alpha is None:
                alpha = torch.ones(light.color.shape[0], dtype=torch.float32,
                                   device=light.color.device)
            intensity = intensity ** alpha[:, None, None]
            color_weight = color_weight + intensity[:, None] * light.color[:, :, None, None]
        else:
            raise TypeError(f"unknown light type: {light!r}")
    return rgb_planes * color_weight
