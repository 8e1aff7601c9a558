"""The port's hand-written Hopper kernels (``csrc/*.cu``), each beside its
plain PyTorch version (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
resolve_pallas.py``).

  K1 ``face_setup``                 per-face constants + kill rule
  K2 ``resolve_xy``                 z-buffer resolve with XY latch
  K2L ``resolve_latch``             z-buffer resolve with XYZ + attribute latch
  K3 ``scatter_pixels_to_faces``    pixel -> face gradient scatter
  K4 ``scatter_faces_to_vertices``  face slot -> vertex gradient scatter
  K5 ``gather_faces3``              vertex -> planar face-vertex gather
  K6 ``scatter_rows``               row scatter-add (texture-atlas gradient)

A wrapper runs the plain version for CPU tensors.  For CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
Only :func:`plain_versions`, which ``chip_smoke.py`` and the tests use to
hold a kernel against its plain version, routes CUDA tensors to the plain
versions.  Every launch adds one to ``LAUNCHES[name]``, so a run can show
which kernels its path went through.  K1, K2, K2L and K5 are bit-identical
to their plain versions; K3, K4 and K6 sum with atomics, in a different
order on every run.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..utils import cuda_build
from .maps import to_map
from .resolve import face_constants_planar, kill_invalid, resolve_constants

KERNELS = (
    "face_setup",
    "resolve_xy",
    "resolve_latch",
    "scatter_pixels_to_faces",
    "scatter_faces_to_vertices",
    "gather_faces3",
    "scatter_rows",
)
LAUNCHES = dict.fromkeys(KERNELS, 0)
# a module flag and not a ContextVar: autograd runs the backward of CUDA
# tensors on threads of its own, which do not see the caller's context
_route = {"plain": False}


def reset_launches():
    for name in KERNELS:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_versions():
    """Route every wrapper to its plain version, for CUDA tensors too, so
    that a run can be compared with the kernels' (``chip_smoke.py`` and the
    tests only)."""
    saved = _route["plain"]
    _route["plain"] = True
    try:
        yield
    finally:
        _route["plain"] = saved


def _on_cuda(*tensors):
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _use_kernel(*tensors):
    """Launch the kernel (CUDA tensors) or take the plain version (CPU
    tensors, or inside :func:`plain_versions`)."""
    return _on_cuda(*tensors) and not _route["plain"]


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
    if not _use_kernel(fvp):
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
    if not _use_kernel(consts, fvp):
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


# --- K2L ------------------------------------------------------------------


def _coord_rows(fvp):
    """[bs, 3, 3, nf] -> per-face latch rows [bs, nf, 9], column
    3 * vertex + coord."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    return fvp.permute(0, 3, 2, 1).reshape(bs, nf, 9)


def resolve_latch_plain(consts, fvp, face_attrs, image_size, near, far):
    index, depth = resolve_constants(consts, image_size, near, far)
    coords = to_map(_coord_rows(fvp), index).permute(0, 3, 1, 2).contiguous()
    attrs = to_map(face_attrs, index).permute(0, 3, 1, 2).contiguous()
    return index, depth, coords, attrs


def latch_limit_error(num_attrs, threads, max_threads, shared_bytes, shared_limit):
    """Why a K2L block cannot launch on a card, or None.  The counterpart
    of the TPU's VMEM probe (``resolve_pallas.py:1318``), which sized the
    resident planes by A; K2L's block does not grow with A, but a card or a
    build whose limits it exceeds must fail here, naming the call, and not
    as a refused launch."""
    if threads <= max_threads and shared_bytes <= shared_limit:
        return None
    return (
        f"resolve_latch with A={num_attrs} attribute planes cannot launch: a block "
        f"needs {threads} threads and {shared_bytes} bytes of shared memory; this "
        f"card allows {max_threads} threads (at the kernel's register use) and "
        f"{shared_limit} bytes"
    )


@functools.lru_cache(maxsize=None)
def _latch_limits(device):
    """(threads, max threads, shared bytes) of K2L, and the card's shared
    memory per block."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        err = cuda_build.load().nr_resolve_latch_limits(
            *(ctypes.addressof(v) for v in vals)
        )
    if err:
        raise RuntimeError(f"resolve_latch: cudaFuncGetAttributes failed with {err}")
    shared_limit = torch.cuda.get_device_properties(device).shared_memory_per_block
    return (*(v.value for v in vals), shared_limit)


def resolve_latch(consts, fvp, face_attrs, image_size, near, far):
    """Z-buffer resolve of killed constants [bs, 17, nf] at S = image_size
    with the winner's coordinates and attributes latched.  ``face_attrs``
    f32 [bs, nf, A] (A may be 0).  Returns (index i32 [bs, S, S], -1 on
    background; depth f32 [bs, S, S], ``far`` on background; coordinates
    f32 [bs, 9, S, S], plane 3 * vertex + coord; attributes f32
    [bs, A, S, S]; both 0 on background)."""
    if not _use_kernel(consts, fvp, face_attrs):
        return resolve_latch_plain(consts, fvp, face_attrs, image_size, near, far)
    bs, nf = consts.shape[0], consts.shape[-1]
    A = face_attrs.shape[-1]
    _check(consts, "consts", torch.float32, (bs, 17, nf))
    _check(fvp, "fvp", torch.float32, (bs, 3, 3, nf))
    _check(face_attrs, "face_attrs", torch.float32, (bs, nf, A))
    dev = consts.device
    error = latch_limit_error(A, *_latch_limits(dev))
    if error:
        raise ValueError(error)
    S = int(image_size)
    index = torch.empty((bs, S, S), dtype=torch.int32, device=dev)
    depth = torch.empty((bs, S, S), dtype=torch.float32, device=dev)
    coords = torch.empty((bs, 9, S, S), dtype=torch.float32, device=dev)
    attrs = torch.empty((bs, A, S, S), dtype=torch.float32, device=dev)
    _launch("resolve_latch", dev, consts.data_ptr(), fvp.data_ptr(),
            face_attrs.data_ptr(), index.data_ptr(), depth.data_ptr(),
            coords.data_ptr(), attrs.data_ptr(), bs, nf, A, S, float(near),
            float(far))
    return index, depth, coords, attrs


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
    if not _use_kernel(grad, face_index_map):
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
    if not _use_kernel(grad, faces):
        return scatter_faces_to_vertices_plain(grad, faces, num_vertices)
    bs, nf = grad.shape[0], grad.shape[-1]
    _check(grad, "grad", torch.float32, (bs, 3, 3, nf))
    _check(faces, "faces", torch.int32, (nf, 3))
    out = torch.zeros((bs, num_vertices, 3), dtype=torch.float32, device=grad.device)
    _launch("scatter_faces_to_vertices", grad.device, grad.data_ptr(),
            faces.data_ptr(), out.data_ptr(), bs, nf, num_vertices)
    return out


# --- K5 -------------------------------------------------------------------


def gather_faces3_plain(table, faces):
    return table[:, faces.long()].permute(0, 3, 2, 1).contiguous()


def gather_faces3(table, faces):
    """``out[b, d, k, f] = table[b, faces[f, k], d]``: table f32
    [bs, n, D], faces i32 [nf, 3] -> f32 [bs, D, 3, nf] (for vertices, the
    planar face vertices [bs, coord, vertex, nf])."""
    if not _use_kernel(table, faces):
        return gather_faces3_plain(table, faces)
    bs, n, D = table.shape
    nf = faces.shape[0]
    _check(table, "table", torch.float32, (bs, n, D))
    _check(faces, "faces", torch.int32, (nf, 3))
    out = torch.empty((bs, D, 3, nf), dtype=torch.float32, device=table.device)
    _launch("gather_faces3", table.device, table.data_ptr(), faces.data_ptr(),
            out.data_ptr(), bs, n, D, nf)
    return out


# --- K6 -------------------------------------------------------------------


def scatter_rows_plain(grad, ids, num_rows):
    bs, D, _ = grad.shape
    mask = ids >= 0
    rows = (ids.long() + num_rows * torch.arange(bs, device=ids.device)[:, None])[mask]
    out = torch.zeros((bs * num_rows, D), dtype=grad.dtype, device=grad.device)
    out.index_add_(0, rows, grad.permute(0, 2, 1)[mask])
    return out.reshape(bs, num_rows, D)


def scatter_rows(grad, ids, num_rows):
    """``out[b, ids[b, p], d] += grad[b, d, p]``: grad f32 [bs, D, P], ids
    i32 [bs, P] (negative adds nothing) -> f32 [bs, num_rows, D]."""
    if not _use_kernel(grad, ids):
        return scatter_rows_plain(grad, ids, num_rows)
    bs, D, P = grad.shape
    _check(grad, "grad", torch.float32, (bs, D, P))
    _check(ids, "ids", torch.int32, (bs, P))
    out = torch.zeros((bs, num_rows, D), dtype=torch.float32, device=grad.device)
    _launch("scatter_rows", grad.device, grad.data_ptr(), ids.data_ptr(),
            out.data_ptr(), bs, D, P, num_rows)
    return out
