"""The resolve's hand-written Hopper kernels (``csrc/*.cu``), each beside its
plain PyTorch version (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
resolve_pallas.py``).

  K1 ``face_setup``                 per-face constants + kill rule
  K2 ``resolve_xy``                 z-buffer resolve with XY latch
  K3 ``scatter_pixels_to_faces``    pixel -> face gradient scatter
  K4 ``scatter_faces_to_vertices``  face slot -> vertex gradient scatter

A wrapper runs the plain version for CPU tensors.  For CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Every launch adds one to ``LAUNCHES[name]``, so a run can show which
kernels its path went through.  K1 and K2 are bit-identical to their plain
versions; K3 and K4 sum with atomics, in a different order on every run.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .maps import to_map
from .resolve import face_constants_planar, kill_invalid, resolve_constants

KERNELS = (
    "face_setup",
    "resolve_xy",
    "scatter_pixels_to_faces",
    "scatter_faces_to_vertices",
)
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cuda(*tensors):
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _check(t, name, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _launch(name, device, *args):
    lib = cuda_build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "nr_" + name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


# --- K1 -------------------------------------------------------------------


def face_setup_plain(fvp, draw_backside):
    return kill_invalid(face_constants_planar(fvp), draw_backside)


def face_setup(fvp, draw_backside):
    """Planar face vertices f32 [bs, 3, 3, nf] -> killed constants f32
    [bs, 17, nf] (see :func:`resolve.kill_invalid`)."""
    if not _on_cuda(fvp):
        return face_setup_plain(fvp, draw_backside)
    bs, nf = fvp.shape[0], fvp.shape[-1]
    _check(fvp, "fvp", torch.float32, (bs, 3, 3, nf))
    consts = torch.empty((bs, 17, nf), dtype=torch.float32, device=fvp.device)
    _launch("face_setup", fvp.device, fvp.data_ptr(), consts.data_ptr(), bs, nf,
            int(draw_backside))
    return consts


# --- K2 -------------------------------------------------------------------


def _xy_rows(fvp):
    """[bs, 3, 3, nf] -> per-face latch rows [bs, nf, 6] = x0,y0,x1,y1,x2,y2."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    return fvp[:, :2].permute(0, 3, 2, 1).reshape(bs, nf, 6)


def resolve_xy_plain(consts, fvp, image_size, near, far):
    index, depth = resolve_constants(consts, image_size, near, far)
    coords = to_map(_xy_rows(fvp), index).permute(0, 3, 1, 2).contiguous()
    return index, depth, coords


def resolve_xy(consts, fvp, image_size, near, far):
    """Z-buffer resolve of killed constants [bs, 17, nf] at S = image_size.
    Returns (index i32 [bs, S, S] with -1 on background, depth f32
    [bs, S, S] with ``far`` on background, latched coordinates f32
    [bs, 6, S, S] = x0,y0,x1,y1,x2,y2 of the winner, 0 on background)."""
    if not _on_cuda(consts, fvp):
        return resolve_xy_plain(consts, fvp, image_size, near, far)
    bs, nf = consts.shape[0], consts.shape[-1]
    _check(consts, "consts", torch.float32, (bs, 17, nf))
    _check(fvp, "fvp", torch.float32, (bs, 3, 3, nf))
    S = int(image_size)
    dev = consts.device
    index = torch.empty((bs, S, S), dtype=torch.int32, device=dev)
    depth = torch.empty((bs, S, S), dtype=torch.float32, device=dev)
    coords = torch.empty((bs, 6, S, S), dtype=torch.float32, device=dev)
    _launch("resolve_xy", dev, consts.data_ptr(), fvp.data_ptr(), index.data_ptr(),
            depth.data_ptr(), coords.data_ptr(), bs, nf, S, float(near), float(far))
    return index, depth, coords


# --- K3 -------------------------------------------------------------------


def scatter_pixels_to_faces_plain(grad, face_index_map, num_faces):
    bs, D = grad.shape[:2]
    fim = face_index_map.reshape(bs, -1).long()
    mask = fim >= 0
    ids = (fim + num_faces * torch.arange(bs, device=fim.device)[:, None])[mask]
    g = grad.reshape(bs, D, -1).permute(1, 0, 2)[:, mask]          # [D, n]
    out = torch.zeros((D, bs * num_faces), dtype=grad.dtype, device=grad.device)
    out.index_add_(1, ids, g)
    return out.reshape(D, bs, num_faces).permute(1, 0, 2).contiguous()


def scatter_pixels_to_faces(grad, face_index_map, num_faces):
    """``out[b, d, f] = sum of grad[b, d, p] over pixels p with
    face_index_map[b, p] == f``: grad f32 [bs, D, H, W], face_index_map i32
    [bs, H, W] (-1 adds nothing) -> f32 [bs, D, num_faces]."""
    if not _on_cuda(grad, face_index_map):
        return scatter_pixels_to_faces_plain(grad, face_index_map, num_faces)
    bs, D, H, W = grad.shape
    _check(grad, "grad", torch.float32, (bs, D, H, W))
    _check(face_index_map, "face_index_map", torch.int32, (bs, H, W))
    out = torch.zeros((bs, D, num_faces), dtype=torch.float32, device=grad.device)
    _launch("scatter_pixels_to_faces", grad.device, grad.data_ptr(),
            face_index_map.data_ptr(), out.data_ptr(), bs, D, H * W, num_faces)
    return out


# --- K4 -------------------------------------------------------------------


def scatter_faces_to_vertices_plain(grad, faces, num_vertices):
    bs, nf = grad.shape[0], grad.shape[-1]
    # face-major slots (f * 3 + k): the summation order of the JAX
    # package's segment-sum
    ids = faces.reshape(-1).long()
    g = grad.permute(0, 3, 2, 1).reshape(bs, nf * 3, 3)     # [bs, slot, coord]
    out = torch.zeros((bs, num_vertices, 3), dtype=grad.dtype, device=grad.device)
    return out.index_add_(1, ids, g)


def scatter_faces_to_vertices(grad, faces, num_vertices):
    """``out[b, faces[f, k], c] += grad[b, c, k, f]``: planar face-vertex
    gradient f32 [bs, 3, 3, nf], faces i32 [nf, 3] -> f32 [bs, nv, 3]."""
    if not _on_cuda(grad, faces):
        return scatter_faces_to_vertices_plain(grad, faces, num_vertices)
    bs, nf = grad.shape[0], grad.shape[-1]
    _check(grad, "grad", torch.float32, (bs, 3, 3, nf))
    _check(faces, "faces", torch.int32, (nf, 3))
    out = torch.zeros((bs, num_vertices, 3), dtype=torch.float32, device=grad.device)
    _launch("scatter_faces_to_vertices", grad.device, grad.data_ptr(),
            faces.data_ptr(), out.data_ptr(), bs, nf, num_vertices)
    return out
