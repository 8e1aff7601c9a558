"""The port's hand-written Hopper kernels (``csrc/*.cu``), each beside its
plain PyTorch version (counterpart of ``neural_renderer_v2_pytorch_tpu/ops/
resolve_pallas.py``).

  K1 ``face_setup``                 per-face constants + kill rule (on no
                                    path: every resolve form computes them
                                    while staging faces, K7 the bbox)
  K2 ``resolve_xy``                 z-buffer resolve with XY latch
  K2L ``resolve_latch``             z-buffer resolve with XYZ + attribute latch
  K2D ``resolve_depth``             z-buffer resolve, id and depth only
  K3 ``scatter_pixels_to_faces``    pixel -> face gradient scatter, summed by
                                    winner in each block before its atomics
  K4 ``scatter_faces_to_vertices``  face slot -> vertex gradient sum, each
                                    vertex over its own slots
                                    (:func:`vertex_slots`)
  K5 ``gather_faces3``              vertex -> planar face-vertex gather
  K6 ``atlas_taps_grad``            texture-atlas gradient: the four bilinear
                                    taps scattered at their texels
  K7 ``bin_faces``                  per-tile face bins from the face vertices:
                                    exact (the pair total read back), or
                                    capped (overflow bins, nothing read back)
  K8 ``resolve_binned_xy``, ``resolve_binned_latch``, ``resolve_binned_depth``
                                    the three resolve forms over K7's bins,
                                    a CTA per bin
  K9 ``gather_rows``                row gather, planar or row layout (the
                                    face-sharded path's winner planes, to_map)
  K10 ``nmr_planes``                the winner's clamped weights, the
                                    coordinate map and the foreground (and the
                                    weight planes where the render reads them)
  K11 ``nmr_planes_vjp``            the coordinate map's VJP onto the winner
                                    planes, the weights recomputed
  K12 ``nmr_coordinate_grad``       the NMR backward's coordinate gradient, x
                                    and y in one launch (a band's halo rows too)
  K13 ``atlas_sample``              the loaded atlas's bilinear sampler
  K14 ``atlas_sample_vjp``          its VJP, the atlas taps added as K6 adds them
  K15 ``lights_shade``              the per-pixel normals, the lights' colour
                                    weight and the shaded RGB
  K16 ``lights_shade_vjp``          their VJP onto the RGB, the normal planes
                                    and (where asked) the light table

The resolve has two routes that give the same bits, both from the face
vertices: "tiled" (K2, K2L, K2D: every tile streams every face's
coordinates and forms the constants of those that touch it) and "binned"
(K7, then K8: every tile streams its own bin and forms its entries'
constants).  Neither launches K1.  :func:`resolve_route` picks one from
the shapes.

A wrapper runs the plain version for CPU tensors.  For CUDA tensors it
launches the kernel on the current stream or raises; there is no fallback.
:func:`plain_versions`, which ``chip_smoke.py`` and the tests use to hold
a kernel against its plain version, routes CUDA tensors to the plain
versions.  Every launch adds one to ``LAUNCHES[name]``,
so a run can show which kernels its path went through, and every call of
an NMR pass on CUDA tensors inside :func:`plain_versions` adds one to
``LAUNCHES["nmr_plain"]``; ``SLOT_TABLE_BUILDS`` counts the builds of K4's
vertex -> slot tables, which launch no kernel of the port.  K1, K2, K2L,
K2D, K5, K7, K8, K9, K10, K11, K12, K13 and K15 are bit-identical to
their plain versions on the card (K12's channel sum adds as ``torch.sum``
does there), and K4 to its plain version on the CPU (whose ``index_add_``
sums each vertex in slot order), on every run, as are K14's and K16's
per-pixel gradients; K3, K6 and K14's atlas gradient sum with atomics, in
a different order on every run; K16's light-table gradient sums its
terms in its own fixed order.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref

import torch

from ..utils import cuda_build
from .resolve import (
    DEPTH_MIN_DELTA,
    _pixel_grid,
    coordinate_planes,
    face_candidate,
    face_constants_planar,
    kill_invalid,
    pixel_centres,
    resolve_constants,
    weight_planes_from_gathered,
)

KERNELS = (
    "face_setup",
    "resolve_xy",
    "resolve_latch",
    "resolve_depth",
    "scatter_pixels_to_faces",
    "scatter_faces_to_vertices",
    "gather_faces3",
    "atlas_taps_grad",
    "bin_faces",
    "resolve_binned_xy",
    "resolve_binned_latch",
    "resolve_binned_depth",
    "gather_rows",
    "nmr_planes",
    "nmr_planes_vjp",
    "nmr_coordinate_grad",
    "atlas_sample",
    "atlas_sample_vjp",
    "lights_shade",
    "lights_shade_vjp",
)
# the calls of an NMR pass (K10-K12) on CUDA tensors that took its plain
# version (inside plain_versions()): a run whose count is not 0 bypassed the
# fused path
NMR_PLAIN = "nmr_plain"
LAUNCHES = dict.fromkeys(KERNELS + (NMR_PLAIN,), 0)
# builds of K4's vertex -> slot tables (:func:`vertex_slots`); reset with
# LAUNCHES
SLOT_TABLE_BUILDS = 0
# the compiled core's graphs (``ops/graphs.py``): captures, replays of
# forward and backward graphs, and recaptures of a graph whose replay had
# overflow bins (K7's capped form).  A wrapper counts its launch in LAUNCHES
# when it runs, at a warm-up or a capture too, and never at a replay: a
# replay of a graph launches what its capture counted (``Graph.launches``)
GRAPHS = dict.fromkeys(("captures", "forward_replays", "backward_replays",
                        "overflow_recaptures"), 0)
# K7's capped binnings on each device (:func:`bin_faces` with a capacity):
# an int64 tensor there of BIN_COUNT_FIELDS, which K7 adds into itself, so
# a binning in a graph counts at every replay, in a caller's capture too.
# Made by the first binning on the device (an eager one, outside any
# capture); read by ``graphs.bin_counters``; zeroed with LAUNCHES
BIN_COUNT_FIELDS = ("binnings", "pairs", "slots", "overflow_bins")
BIN_COUNTS = {}
# a module flag and not a ContextVar: autograd runs the backward of CUDA
# tensors on threads of its own, which do not see the caller's context
_route = {"plain": False, "mode": None}

ROUTES = ("tiled", "binned")
# the binned route's pixel tile (K7's kTile, K8's kBinEdge): on an H100,
# K7 + K8 at 8x8 beat 16x16 at every binned configuration, 2048^2 included,
# since K7's cost grows with tiles + pairs (PERF.md)
BIN_TILE = (8, 8)
# K7 pads its per-tile counters to a multiple of this many, the chunk one
# block scans (kScanChunk in csrc/bin_faces.cu)
BIN_SCAN_TILE = 4096
# K7's control words after the padded counters (csrc/bin_faces.cu): the
# pair total, and the overflow bins of the capped form
BIN_TOTAL_WORD, BIN_OVERFLOW_WORD = 1, 3
# K7 keeps the tiles' pixel-centre bounds in 48 KB of shared memory: at most
# this many tiles along both axes together (kMaxTableTiles)
BIN_MAX_AXIS_TILES = 6144
# the binned route from this many (batch image, 16x16 tile, face) products
# on.  chip_smoke.py times both routes at its seven configurations and at
# seven tori between them: on an H100 the tiled one won up to 33.3M
# products and the binned one from 40.6M on; the tiled time grows ~0.007
# ms per million products and meets the binned route's run-to-run
# 0.15-0.29 ms (its K7 reads the pair total back) between 26M and 41M
# (PERF.md)
BINNED_FROM = 34_000_000


def reset_launches():
    global SLOT_TABLE_BUILDS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in GRAPHS:
        GRAPHS[name] = 0
    for counts in BIN_COUNTS.values():
        counts.zero_()
    SLOT_TABLE_BUILDS = 0


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
    """True for tensors on one card, False for CPU ones; raises on anything
    else.  (Device indices, not device objects: this runs at every launch.)"""
    index = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != index or not (t.is_cuda or t.is_cpu):
            raise ValueError("want tensors on one card or on the CPU, got "
                             + ", ".join(str(t.device) for t in tensors))
    return index >= 0


@contextlib.contextmanager
def forced_route(mode):
    """Send every resolve whose caller asks for ``mode="auto"`` down the
    ``"tiled"`` or ``"binned"`` route (``chip_smoke.py`` and the tests only,
    to hold one route against the other through the public entry points).
    ``resolve_and_gather`` and ``compute_face_index_map`` also take
    ``mode``, as their JAX counterparts do; ``Renderer`` and the
    ``rasterize_*`` functions take none, and this reaches them."""
    if mode not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {mode!r}")
    saved = _route["mode"]
    _route["mode"] = mode
    try:
        yield
    finally:
        _route["mode"] = saved


def resolve_route(bs, rows, image_size, nf, mode="auto"):
    """The resolve route for ``bs`` images of ``rows`` x ``image_size``
    pixels over ``nf`` faces: ``mode`` itself when it is "tiled" or
    "binned", else the route :func:`forced_route` set, else the rule.  The
    tiled route streams every face through every 16x16 tile; the binned
    one pays K7 (eagerly, and a host sync) to stream each tile's own bin.  The rule
    reads the shapes only: binned from :data:`BINNED_FROM` products of
    images, tiles and faces on.  (The counterpart of the TPU package's
    windowed/binned pick, ``resolve_pallas.py:1366``, which followed its
    VMEM budget instead.)"""
    if mode in ROUTES:
        return mode
    if mode != "auto":
        raise ValueError(f"mode must be 'auto' or one of {ROUTES}, got {mode!r}")
    if _route["mode"] is not None:
        return _route["mode"]
    tiles = -(-rows // 16) * -(-image_size // 16)
    return "binned" if bs * tiles * nf >= BINNED_FROM else "tiled"


def _use_kernel(*tensors):
    """Launch the kernel (CUDA tensors) or take the plain version (CPU
    tensors, or inside :func:`plain_versions`)."""
    return _on_cuda(*tensors) and not _route["plain"]


def _check(t, name, dtype, shape):
    """``shape`` a tuple (``torch.Size`` compares with it as it is)."""
    if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _check_fvp(fvp):
    """Check planar face vertices f32 [bs, 3, 3, nf]; returns (bs, nf)."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    _check(fvp, "fvp", torch.float32, (bs, 3, 3, nf))
    return bs, nf


# entry -> its loaded C function (filled by cuda_build.load()) and the
# packer of its argument block
_ENTRIES = cuda_build.ENTRIES
_PACK = {name: packer.pack for name, packer in cuda_build.PACKERS.items()}


def _launch(entry, index, *args):
    """Launch the C entry ``nr_<entry>`` on the current stream of card
    ``index``, raise on its error code, and count the launch in
    ``LAUNCHES`` (K7's count pass, ``"bin_faces_count"``, is counted with
    its ``"bin_faces"``).  The launch path of every wrapper: the card and
    the arguments are packed into one block of int64 slots (``bytes``,
    ``cuda_build.PACKERS``), so ctypes converts two arguments, the block and
    the stream, read as a raw pointer (no ``Stream`` object); the entry
    itself switches to the card when it is not the current one."""
    fn = _ENTRIES.get(entry)
    if fn is None:
        cuda_build.load()
        fn = _ENTRIES[entry]
    # what PyTorch's own generated code calls; CUDA builds only, so it is
    # reached here, on the card's path, and never at import
    err = fn(_PACK[entry](index, *args), torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {err}")
    if entry in LAUNCHES:
        LAUNCHES[entry] += 1


def _window(image_size, row_start, num_rows):
    """(S, row_start, num_rows) as ints, num_rows defaulting to the image."""
    S = int(image_size)
    return S, int(row_start), S if num_rows is None else int(num_rows)


# --- K1 -------------------------------------------------------------------


def face_setup_plain(fvp, draw_backside):
    return kill_invalid(face_constants_planar(fvp), draw_backside)


def face_setup(fvp, draw_backside):
    """Planar face vertices f32 [bs, 3, 3, nf] -> killed constants f32
    [bs, 17, nf] (see :func:`resolve.kill_invalid`)."""
    if not _use_kernel(fvp):
        return face_setup_plain(fvp, draw_backside)
    bs, nf = _check_fvp(fvp)
    consts = torch.empty((bs, 17, nf), dtype=torch.float32, device=fvp.device)
    _launch("face_setup", fvp.get_device(), fvp.data_ptr(), consts.data_ptr(), bs, nf,
            int(draw_backside))
    return consts


# --- K2, K2L, K2D: the tiled route ---------------------------------------


def _xy_rows(fvp):
    """[bs, 3, 3, nf] -> per-face latch rows [bs, nf, 6] = x0,y0,x1,y1,x2,y2."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    return fvp[:, :2].permute(0, 3, 2, 1).reshape(bs, nf, 6)


def _coord_rows(fvp):
    """[bs, 3, 3, nf] -> per-face latch rows [bs, nf, 9], column
    3 * vertex + coord."""
    bs, nf = fvp.shape[0], fvp.shape[-1]
    return fvp.permute(0, 3, 2, 1).reshape(bs, nf, 9)


def _winner_planes(rows, index):
    """The winner's rows [bs, nf, D] as planes [bs, D, *index.shape[1:]], 0
    on background: the plain latch."""
    bs = index.shape[0]
    planes = gather_rows_plain(rows, index.reshape(bs, -1), planar=True)
    return planes.reshape(bs, rows.shape[-1], *index.shape[1:])


def _latch_xy(index, depth, fvp):
    return index, depth, _winner_planes(_xy_rows(fvp), index)


def _latch_copy(index, depth, fvp, face_attrs):
    return index, depth, _winner_planes(_coord_rows(fvp), index), _winner_planes(face_attrs, index)


def _tiled_fold(fvp, draw_backside, image_size, near, far, row_start, num_rows):
    """The tiled forms' plain version: K1's plain version, then the
    sequential fold over all faces."""
    return resolve_constants(face_setup_plain(fvp, draw_backside), image_size, near, far,
                             row_start=row_start, num_rows=num_rows)


def resolve_xy_plain(fvp, draw_backside, image_size, near, far, row_start=0, num_rows=None):
    index, depth = _tiled_fold(fvp, draw_backside, image_size, near, far, row_start, num_rows)
    return _latch_xy(index, depth, fvp)


def resolve_xy(fvp, draw_backside, image_size, near, far, row_start=0, num_rows=None):
    """Z-buffer resolve of planar face vertices f32 [bs, 3, 3, nf] at S =
    image_size, over the image rows ``row_start .. row_start + num_rows``
    (all S by default); degenerate faces, and backfacing ones unless
    ``draw_backside``, are killed as K1 kills them.  Returns (index i32
    [bs, rows, S] with -1 on background, depth f32 [bs, rows, S] with
    ``far`` on background, latched coordinates f32 [bs, 6, rows, S] =
    x0,y0,x1,y1,x2,y2 of the winner, 0 on background).  One launch: the
    kernel computes each face's constants itself (no K1)."""
    if not _use_kernel(fvp):
        return resolve_xy_plain(fvp, draw_backside, image_size, near, far, row_start, num_rows)
    bs, nf = _check_fvp(fvp)
    S, r0, rows = _window(image_size, row_start, num_rows)
    index = fvp.new_empty((bs, rows, S), dtype=torch.int32)
    depth = fvp.new_empty((bs, rows, S))
    coords = fvp.new_empty((bs, 6, rows, S))
    _launch("resolve_xy", fvp.get_device(), fvp.data_ptr(), index.data_ptr(), depth.data_ptr(),
            coords.data_ptr(), bs, nf, S, r0, rows, int(draw_backside), float(near),
            float(far))
    return index, depth, coords


def resolve_latch_plain(fvp, face_attrs, draw_backside, image_size, near, far, row_start=0,
                        num_rows=None):
    index, depth = _tiled_fold(fvp, draw_backside, image_size, near, far, row_start, num_rows)
    return _latch_copy(index, depth, fvp, face_attrs)


def latch_limit_error(num_attrs, threads, max_threads, shared_bytes, shared_limit,
                      kernel="resolve_latch"):
    """Why a block of a copy-form resolve (K2L, or K8's ``resolve_binned_latch``)
    cannot launch on a card, or None.  The counterpart of the TPU's VMEM
    probe (``resolve_pallas.py:1318``), which sized the resident planes by
    A; these blocks do not grow with A, but a card or a build whose limits
    they exceed must fail here, naming the call, and not as a refused
    launch."""
    if threads <= max_threads and shared_bytes <= shared_limit:
        return None
    return (
        f"{kernel} with A={num_attrs} attribute planes cannot launch: a block "
        f"needs {threads} threads and {shared_bytes} bytes of shared memory; this "
        f"card allows {max_threads} threads (at the kernel's register use) and "
        f"{shared_limit} bytes"
    )


@functools.lru_cache(maxsize=None)
def _latch_limits(device, binned=False):
    """(threads, max threads, shared bytes) of the copy-form resolve (K8's
    when ``binned``, else K2L's), and the card's shared memory per block."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        err = cuda_build.load().nr_resolve_latch_limits(
            int(binned), *(ctypes.addressof(v) for v in vals)
        )
    if err:
        raise RuntimeError(f"resolve latch limits: cudaFuncGetAttributes failed with {err}")
    shared_limit = torch.cuda.get_device_properties(device).shared_memory_per_block
    return (*(v.value for v in vals), shared_limit)


def _check_latch(fvp, face_attrs, kernel, binned=False):
    """Check the copy-form inputs and the launch limits of K2L, or K8 when
    ``binned``; returns (bs, nf, A)."""
    bs, nf = _check_fvp(fvp)
    A = face_attrs.shape[-1]
    _check(face_attrs, "face_attrs", torch.float32, (bs, nf, A))
    error = latch_limit_error(A, *_latch_limits(fvp.device, binned), kernel=kernel)
    if error:
        raise ValueError(error)
    return bs, nf, A


def _latch_outputs(bs, A, rows, S, device):
    return (torch.empty((bs, rows, S), dtype=torch.int32, device=device),
            torch.empty((bs, rows, S), dtype=torch.float32, device=device),
            torch.empty((bs, 9, rows, S), dtype=torch.float32, device=device),
            torch.empty((bs, A, rows, S), dtype=torch.float32, device=device))


def resolve_latch(fvp, face_attrs, draw_backside, image_size, near, far, row_start=0,
                  num_rows=None):
    """:func:`resolve_xy` with the winner's coordinates and attributes
    latched.  ``face_attrs`` f32 [bs, nf, A] (A may be 0).  Returns (index
    i32 [bs, rows, S], -1 on background; depth f32 [bs, rows, S], ``far``
    on background; coordinates f32 [bs, 9, rows, S], plane 3 * vertex +
    coord; attributes f32 [bs, A, rows, S]; both 0 on background)."""
    if not _use_kernel(fvp, face_attrs):
        return resolve_latch_plain(fvp, face_attrs, draw_backside, image_size, near, far,
                                   row_start, num_rows)
    bs, nf, A = _check_latch(fvp, face_attrs, "resolve_latch")
    S, r0, rows = _window(image_size, row_start, num_rows)
    out = _latch_outputs(bs, A, rows, S, fvp.device)
    _launch("resolve_latch", fvp.get_device(), fvp.data_ptr(), face_attrs.data_ptr(),
            *(t.data_ptr() for t in out), bs, nf, A, S, r0, rows, int(draw_backside),
            float(near), float(far))
    return out


def resolve_depth_plain(fvp, draw_backside, image_size, near, far, row_start=0, num_rows=None):
    return _tiled_fold(fvp, draw_backside, image_size, near, far, row_start, num_rows)


def resolve_depth(fvp, draw_backside, image_size, near, far, row_start=0, num_rows=None):
    """The id/depth form of :func:`resolve_xy`: (index i32 [bs, rows, S],
    -1 on background; depth f32 [bs, rows, S], ``far`` on background)."""
    if not _use_kernel(fvp):
        return resolve_depth_plain(fvp, draw_backside, image_size, near, far, row_start,
                                   num_rows)
    bs, nf = _check_fvp(fvp)
    S, r0, rows = _window(image_size, row_start, num_rows)
    index = fvp.new_empty((bs, rows, S), dtype=torch.int32)
    depth = fvp.new_empty((bs, rows, S))
    _launch("resolve_depth", fvp.get_device(), fvp.data_ptr(), index.data_ptr(),
            depth.data_ptr(), bs, nf, S, r0, rows, int(draw_backside), float(near), float(far))
    return index, depth


# --- K3 -------------------------------------------------------------------


def scatter_pixels_to_faces_plain(grad, face_index_map, num_faces):
    bs, D = grad.shape[:2]
    fim = face_index_map.reshape(bs, -1).long()
    mask = (fim >= 0) & (fim < num_faces)
    ids = (fim + num_faces * torch.arange(bs, device=fim.device)[:, None])[mask]
    g = grad.reshape(bs, D, -1).permute(1, 0, 2)[:, mask]          # [D, n]
    out = torch.zeros((D, bs * num_faces), dtype=grad.dtype, device=grad.device)
    out.index_add_(1, ids, g)
    return out.reshape(D, bs, num_faces).permute(1, 0, 2).contiguous()


def scatter_pixels_to_faces(grad, face_index_map, num_faces):
    """``out[b, d, f] = sum of grad[b, d, p] over pixels p with
    face_index_map[b, p] == f``: grad f32 [bs, D, H, W], face_index_map i32
    [bs, H, W] (ids outside [0, num_faces) add nothing) -> f32
    [bs, D, num_faces].

    On the card one call is two device operations, the output's zero fill
    and the kernel, which sums each block's pixels by winner before one
    atomic per (face, plane); a block is a run of 256 pixels."""
    if not _use_kernel(grad, face_index_map):
        return scatter_pixels_to_faces_plain(grad, face_index_map, num_faces)
    bs, D, H, W = grad.shape
    _check(grad, "grad", torch.float32, (bs, D, H, W))
    _check(face_index_map, "face_index_map", torch.int32, (bs, H, W))
    out = grad.new_empty((bs, D, num_faces))
    _launch("scatter_pixels_to_faces", grad.get_device(), grad.data_ptr(),
            face_index_map.data_ptr(), out.data_ptr(), bs, D, H * W, num_faces)
    return out


# --- K4 -------------------------------------------------------------------


def scatter_faces_to_vertices_plain(grad, faces, num_vertices):
    bs, nf = grad.shape[0], grad.shape[-1]
    # face-major slots (f * 3 + k): the summation order of the JAX
    # package's segment-sum; a slot whose id lies outside the table adds
    # nothing (dropped, the rest kept in order)
    ids = faces.reshape(-1).long()
    g = grad.permute(0, 3, 2, 1).reshape(bs, nf * 3, 3)     # [bs, slot, coord]
    keep = (ids >= 0) & (ids < num_vertices)
    out = torch.zeros((bs, num_vertices, 3), dtype=grad.dtype, device=grad.device)
    return out.index_add_(1, ids[keep], g[:, keep])


def build_vertex_slots(faces, num_vertices):
    """K4's vertex -> slot table of ``faces`` [nf, 3], on its device:
    (offsets i32 [nv + 1], slots i32 [3 nf]).  Vertex v owns the face-major
    slots s = 3 f + k with ``faces[f, k] == v``, at ``slots[offsets[v] :
    offsets[v + 1]]`` in ascending order; ids outside [0, nv) own none
    (their slots sort past ``offsets[nv]``).  A stable sort by vertex id,
    then each vertex's first position: no host sync."""
    ids = faces.reshape(-1)
    key = torch.where((ids >= 0) & (ids < num_vertices), ids, num_vertices)
    sorted_key, slots = torch.sort(key, stable=True)
    first = torch.arange(num_vertices + 1, dtype=key.dtype, device=key.device)
    return torch.searchsorted(sorted_key, first, out_int32=True), slots.to(torch.int32)


# id(faces) -> (a weak reference to faces, what the table was built from,
# the table); an entry leaves with its tensor
_slot_tables = {}


def vertex_slots(faces, num_vertices):
    """:func:`build_vertex_slots`, kept for each faces tensor: built anew
    only for another tensor, after an in-place edit (``faces._version``),
    for other storage or another ``num_vertices``.  A fit that passes the
    same faces tensor every step builds one table.  Each build adds one to
    ``SLOT_TABLE_BUILDS``."""
    global SLOT_TABLE_BUILDS
    key = id(faces)
    stamp = (faces._version, faces.data_ptr(), faces.get_device(), num_vertices)
    entry = _slot_tables.get(key)
    if entry is not None and entry[0]() is faces and entry[1] == stamp:
        return entry[2]
    table = build_vertex_slots(faces, num_vertices)
    ref = weakref.ref(faces, lambda _, key=key: _slot_tables.pop(key, None))
    _slot_tables[key] = (ref, stamp, table)
    SLOT_TABLE_BUILDS += 1
    return table


def scatter_faces_to_vertices(grad, faces, num_vertices):
    """``out[b, faces[f, k], c] += grad[b, c, k, f]``: planar face-vertex
    gradient f32 [bs, 3, 3, nf], faces i32 [nf, 3] -> f32 [bs, nv, 3].  On
    the card each vertex sums its own slots (:func:`vertex_slots`) in
    ascending order from 0, the order of the plain version on the CPU: its
    bits, on every run.  Ids outside [0, nv) add nothing, as in the TPU
    package's one-hot ``_scatter3_kernel``, on both tiers."""
    if not _use_kernel(grad, faces):
        return scatter_faces_to_vertices_plain(grad, faces, num_vertices)
    bs, nf = grad.shape[0], grad.shape[-1]
    _check(grad, "grad", torch.float32, (bs, 3, 3, nf))
    _check(faces, "faces", torch.int32, (nf, 3))
    offsets, slots = vertex_slots(faces, num_vertices)
    out = torch.empty((bs, num_vertices, 3), dtype=torch.float32, device=grad.device)
    _launch("scatter_faces_to_vertices", grad.get_device(), grad.data_ptr(),
            offsets.data_ptr(), slots.data_ptr(), out.data_ptr(), bs, nf, num_vertices)
    return out


# --- K5 and K9: the gathers -----------------------------------------------


def gather_faces3_plain(table, faces):
    ok = (faces >= 0) & (faces < table.shape[1])
    rows = table[:, torch.where(ok, faces, 0).long()]           # [bs, nf, 3, D]
    return torch.where(ok[..., None], rows, 0.0).permute(0, 3, 2, 1).contiguous()


def gather_faces3(table, faces):
    """``out[b, d, k, f] = table[b, faces[f, k], d]``: table f32
    [bs, n, D], faces i32 [nf, 3] -> f32 [bs, D, 3, nf] (for vertices, the
    planar face vertices [bs, coord, vertex, nf]).  An id outside [0, n)
    reads 0, as in the TPU package's one-hot ``_gather3_kernel``, on both
    tiers."""
    if not _use_kernel(table, faces):
        return gather_faces3_plain(table, faces)
    bs, n, D = table.shape
    nf = faces.shape[0]
    _check(table, "table", torch.float32, (bs, n, D))
    _check(faces, "faces", torch.int32, (nf, 3))
    out = torch.empty((bs, D, 3, nf), dtype=torch.float32, device=table.device)
    _launch("gather_faces3", table.get_device(), table.data_ptr(), faces.data_ptr(),
            out.data_ptr(), bs, n, D, nf)
    return out


def gather_rows_plain(table, ids, planar=False):
    bs, n, D = table.shape
    if n == 0:                          # every id lies outside an empty table
        out = table.new_zeros((bs, ids.shape[-1], D))
        return out.permute(0, 2, 1).contiguous() if planar else out
    ok = (ids >= 0) & (ids < n)
    rows = torch.gather(table, 1, torch.where(ok, ids, 0).long()[..., None].expand(bs, -1, D))
    out = torch.where(ok[..., None], rows, 0.0)
    return out.permute(0, 2, 1).contiguous() if planar else out


def gather_rows(table, ids, planar=False):
    """``table[b, ids[b, p], :]``, 0 where ``ids[b, p]`` lies outside
    [0, n): table f32 [bs, n, D], ids i32 [bs, P] (contiguous rows; a batch
    stride of 0 shares them across the batch) -> f32 [bs, D, P] when
    ``planar``, else [bs, P, D].  The counterpart of the TPU package's
    ``gather_rows_pallas``, whose one-hot products also read 0 for such an
    id.  Its checks are one comparison each for the table and for the ids
    in the common layouts (this call is on the face-sharded path's every
    step, and its launch path is most of its time)."""
    index = table.get_device()
    if not (table.is_cuda and ids.get_device() == index and not _route["plain"]):
        if not _use_kernel(table, ids):        # raises on tensors on two devices
            return gather_rows_plain(table, ids, planar)
    bs, n, D = table.shape
    P = ids.shape[-1]
    if (table.dtype, table.stride()) != (torch.float32, (n * D, D, 1)):
        _check(table, "table", torch.float32, (bs, n, D))
    batch_stride = P
    if (ids.dtype, ids.shape, ids.stride()) != (torch.int32, (bs, P), (P, 1)):
        batch_stride = _shared_ids_stride(ids, bs, P)
    out = table.new_empty((bs, D, P) if planar else (bs, P, D))
    _launch("gather_rows", index, table.data_ptr(), ids.data_ptr(), out.data_ptr(), bs, n, D, P,
            batch_stride, int(planar))
    return out


def _shared_ids_stride(ids, bs, P):
    """K9's batch stride of ids outside the common layout: P for
    contiguous rows, 0 for rows shared by the batch; raises on others."""
    batch_stride = ids.stride(0) if bs > 1 else P
    if (ids.dtype != torch.int32 or tuple(ids.shape) != (bs, P)
            or (P > 1 and ids.stride(1) != 1) or batch_stride not in (0, P)):
        raise ValueError(f"ids: want int32 {(bs, P)} with contiguous rows, got {ids.dtype} "
                         f"{tuple(ids.shape)} strides {ids.stride()}")
    return batch_stride


# --- K6 -------------------------------------------------------------------


def scatter_rows_plain(grad, ids, num_rows):
    """``out[b, ids[b, p], d] += grad[b, d, p]``: grad f32 [bs, D, P], ids
    i32 [bs, P] (negative adds nothing) -> f32 [bs, num_rows, D].  The
    function of the JAX package's ``scatter_rows_pallas``; here the first
    half of :func:`atlas_taps_grad_plain`."""
    bs, D, _ = grad.shape
    mask = ids >= 0
    rows = (ids.long() + num_rows * torch.arange(bs, device=ids.device)[:, None])[mask]
    out = torch.zeros((bs * num_rows, D), dtype=grad.dtype, device=grad.device)
    out.index_add_(0, rows, grad.permute(0, 2, 1)[mask])
    return out.reshape(bs, num_rows, D)


def fold_taps(quad, tw):
    """The JAX package's fold of the four taps' channels, scattered at their
    anchor (``quad`` f32 [bs, T, 12]), onto the taps' texels: anchor t
    contributed to texels t, t+1, t+tw, t+tw+1, each texel summed as q0 +
    q1 + q_tw + q_tw1 (in place on one buffer); a tap past T is dropped.
    -> f32 [bs, 3, T], contiguous."""
    T = quad.shape[1]
    g = quad[..., 0:3].clone()
    g[:, 1:] += quad[:, : T - 1, 3:6]
    g[:, tw:] += quad[:, : T - tw, 6:9]
    g[:, tw + 1:] += quad[:, : T - tw - 1, 9:12]
    return g.transpose(1, 2).contiguous()


def atlas_taps_grad_plain(grad, anchors, tw, num_texels):
    ok = (anchors >= 0) & (anchors < num_texels)
    return fold_taps(scatter_rows_plain(grad, torch.where(ok, anchors, -1), num_texels), tw)


def atlas_taps_grad(grad, anchors, tw, num_texels):
    """The gradient of a flattened atlas [bs, 3, T] (T = ``num_texels``)
    from its four bilinear taps at each pixel: ``out[b, c, a + k_i] +=
    grad[b, 3 i + c, p]`` for k = (0, 1, tw, tw + 1), where ``a =
    anchors[b, p]`` lies in [0, T) (others add nothing) and each tap only
    where ``a + k_i < T``: grad f32 [bs, 12, P], anchors i32 [bs, P] ->
    f32 [bs, 3, T], contiguous (the backward of ``shading._AtlasTaps``)."""
    if not _use_kernel(grad, anchors):
        return atlas_taps_grad_plain(grad, anchors, tw, num_texels)
    bs, _, P = grad.shape
    _check(grad, "grad", torch.float32, (bs, 12, P))
    _check(anchors, "anchors", torch.int32, (bs, P))
    out = torch.zeros((bs, 3, num_texels), dtype=torch.float32, device=grad.device)
    _launch("atlas_taps_grad", grad.get_device(), grad.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), bs, P, tw, num_texels)
    return out


# --- K7 -------------------------------------------------------------------


def _tile_centre_ranges(image_size, start, extent, tile):
    """Pixel-centre ranges (lo, hi) f32 [n], on the CPU, of the n tiles of
    ``tile`` pixels over pixels start .. start + extent - 1, the last one
    clipped at the end."""
    first = torch.arange(0, extent, tile)
    last = torch.clamp(first + tile, max=extent) - 1
    return pixel_centres(start + first, image_size), pixel_centres(start + last, image_size)


def bin_faces_plain(fvp, draw_backside, image_size, row_start=0, num_rows=None,
                    capacity=None):
    consts = face_setup_plain(fvp, draw_backside)
    bs, _, nf = consts.shape
    S, r0, rows = _window(image_size, row_start, num_rows)
    th, tw = BIN_TILE
    dev = consts.device
    x_lo, x_hi = (t.to(dev) for t in _tile_centre_ranges(S, 0, S, tw))
    y_lo, y_hi = (t.to(dev) for t in _tile_centre_ranges(S, r0, rows, th))
    tiles_x, n_tiles = len(x_lo), len(x_lo) * len(y_lo)
    # each face's tile rectangle: the tiles whose centre range meets its
    # bbox by K2's strict test (a tile whose hi < min misses, lo <= max hits)
    xmin, xmax, ymin, ymax = (consts[:, 13 + j].contiguous() for j in range(4))
    tx0 = torch.searchsorted(x_hi, xmin)
    ty0 = torch.searchsorted(y_hi, ymin)
    wx = (torch.searchsorted(x_lo, xmax, right=True) - tx0).clamp(min=0).reshape(-1)
    wy = (torch.searchsorted(y_lo, ymax, right=True) - ty0).clamp(min=0).reshape(-1)
    # one (tile, face) pair per tile of each rectangle, in (image, face) order
    n = wx * wy
    src = torch.repeat_interleave(torch.arange(bs * nf, device=dev), n)
    k = torch.arange(len(src), device=dev) - (torch.cumsum(n, 0) - n)[src]
    ty = ty0.reshape(-1)[src] + k // wx[src]
    tx = tx0.reshape(-1)[src] + k % wx[src]
    key = (src // nf) * n_tiles + ty * tiles_x + tx
    # a stable sort by tile keeps every bin in ascending face order
    ids = (src % nf)[torch.sort(key, stable=True).indices].to(torch.int32)
    cnt = torch.bincount(key, minlength=bs * n_tiles)
    offsets = torch.cumsum(cnt, 0) - cnt
    bins = (cnt.reshape(bs, n_tiles).to(torch.int32),
            offsets.reshape(bs, n_tiles).to(torch.int32), ids)
    if capacity is None:
        return bins
    capped = _capped(*bins, capacity)
    bin_counts(dev).add_(torch.tensor([1, len(ids), capacity, int(capped[3])], device=dev))
    return capped


def bin_counts(device):
    """The int64 [len(BIN_COUNT_FIELDS)] counts of K7's capped binnings on
    ``device`` (:data:`BIN_COUNTS`), made there at the first call: outside
    a capture, which would hold its zero fill."""
    key = torch.device(device)
    counts = BIN_COUNTS.get(key)
    if counts is None:
        if key.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "bin_faces: K7's counts on this card are made by its first binning there, "
                "outside a CUDA graph capture: run the binning once before capturing it")
        counts = BIN_COUNTS[key] = torch.zeros(len(BIN_COUNT_FIELDS), dtype=torch.int64,
                                               device=key)
    return counts


def _capped(cnt, offsets, ids, capacity):
    """Exact bins in K7's capped form: a bin whose pairs end past
    ``capacity`` in the exclusive scan overflows (offset -1, cnt kept);
    ``ids`` [capacity] holds the bins that fit, -1 past them; and the
    overflow bins' count i32 [1]."""
    over = offsets + cnt > capacity
    fit = int(cnt[~over].sum())
    capped = torch.full((capacity,), -1, dtype=torch.int32, device=ids.device)
    capped[:fit] = ids[:fit]
    return (cnt, torch.where(over, -1, offsets), capped,
            over.sum().to(torch.int32).reshape(1))


def bin_faces(fvp, draw_backside, image_size, row_start=0, num_rows=None, capacity=None):
    """Per-tile face bins of planar face vertices f32 [bs, 3, 3, nf] over
    the image rows ``row_start .. row_start + num_rows`` (all S by
    default), in tiles of :data:`BIN_TILE` pixels, row-major: (cnt i32
    [bs, tiles], offsets i32 [bs, tiles], ids i32 [pairs]).  Tile t of
    image b holds ``ids[offsets[b, t] : offsets[b, t] + cnt[b, t]]``, the
    faces that K1's kill rule (with ``draw_backside``) keeps and whose bbox
    meets its pixel-centre range, in ascending order.

    With ``capacity`` (an int), the capped form, which reads nothing back
    (what a CUDA graph captures): ``ids`` holds ``capacity`` slots, and a
    bin whose pairs end past them in the scan of the counts is an overflow
    bin, with offset -1 and its cnt kept (K8 resolves it over every face,
    to the same bits); returns (cnt, offsets, ids, overflow), overflow i32
    [1] the count of overflow bins.  Those are the bins from the first
    whose pairs end past the capacity on, in (image, tile) order; ``ids``
    past the last bin that fits is undefined.  The capped form also adds
    the binning, its pair total, its capacity and its overflow bins into
    the device's :func:`bin_counts` (on the card K7's own atomics, so a
    graph that holds it counts at every replay).

    On the card: four device operations (``csrc/bin_faces.cu``, which forms
    each bbox and the kill rule from the coordinates, as K1 would), and
    without ``capacity`` one host sync, which reads the pair total back to
    size ``ids`` (its capacity: no bin overflows)."""
    if capacity is not None and capacity < 0:
        raise ValueError(f"bin_faces: capacity must be >= 0, got {capacity}")
    if not _use_kernel(fvp):
        return bin_faces_plain(fvp, draw_backside, image_size, row_start, num_rows, capacity)
    bs, nf = _check_fvp(fvp)
    S, r0, rows = _window(image_size, row_start, num_rows)
    th, tw = BIN_TILE
    tiles_x, tiles_y = -(-S // tw), -(-rows // th)
    if tiles_x + tiles_y > BIN_MAX_AXIS_TILES:
        raise ValueError(f"bin_faces: {tiles_x} x {tiles_y} tiles; K7 takes at most "
                         f"{BIN_MAX_AXIS_TILES} along both axes together")
    n_tiles = tiles_x * tiles_y
    n_bins = bs * n_tiles
    cnt = fvp.new_empty((bs, n_tiles), dtype=torch.int32)
    offsets = torch.empty_like(cnt)
    if n_bins == 0:
        if capacity is None:
            return cnt, offsets, cnt.new_empty((0,))
        return cnt, offsets, cnt.new_empty((capacity,)), cnt.new_zeros((1,))
    counts = bin_counts(fvp.device)
    padded = -(-n_bins // BIN_SCAN_TILE) * BIN_SCAN_TILE
    # the per-tile counters (then fill cursors), four control words and a
    # 64-bit scan state per chunk
    scratch = cnt.new_empty((padded + 4 + 2 * (padded // BIN_SCAN_TILE),))
    geometry = (bs, nf, S, r0, rows, int(draw_backside))
    index = fvp.get_device()
    _launch("bin_faces_count", index, fvp.data_ptr(), scratch.data_ptr(), *geometry)
    slots = capacity
    if capacity is None:
        slots = int(scratch[padded + BIN_TOTAL_WORD])                 # the host sync
    # ids, then the fill's unsorted pairs, which the order pass reads
    pairs = cnt.new_empty((2 * slots,))
    ids = pairs[:slots]
    # K7 is two entries of one wrapper call; LAUNCHES counts the call once,
    # at its scan, fill and order passes (this entry), so that one binning
    # reads as one launch
    # the capped form adds its binning, pairs, slots and overflow bins into
    # the device's counts
    _launch("bin_faces", index, fvp.data_ptr(), scratch.data_ptr(), cnt.data_ptr(),
            offsets.data_ptr(), pairs[slots:].data_ptr(), ids.data_ptr(), *geometry, slots,
            0 if capacity is None else counts.data_ptr())
    if capacity is None:
        return cnt, offsets, ids
    return cnt, offsets, ids, scratch.narrow(0, padded + BIN_OVERFLOW_WORD, 1)


# --- K8: the binned route -------------------------------------------------


def _binned_fold(fvp, draw_backside, bins, image_size, near, far, row_start, num_rows):
    """The z-buffer fold over the bins of the :data:`BIN_TILE` pixel tiles,
    of K1's plain constants of the face vertices, vectorised over tiles:
    step k folds the k-th face of every tile's bin, so every pixel still
    takes its tile's faces in ascending order.  An overflow bin (offset -1,
    :func:`bin_faces`' capped form) folds every face, its k-th face being
    face k, unless its count is 0 (no face meets the tile).  Returns (index,
    depth) [bs, rows, S]."""
    consts = face_setup_plain(fvp, draw_backside)
    cnt, offsets, ids = (t.long() for t in bins)
    bs, nf = consts.shape[0], consts.shape[-1]
    over = offsets < 0
    cnt = torch.where(over & (cnt > 0), nf, cnt)
    if ids.numel() == 0:
        ids = ids.new_zeros((1,))           # read where no bin has an entry
    S, r0, rows = _window(image_size, row_start, num_rows)
    th, tw = BIN_TILE
    ny, nx = -(-rows // th), -(-S // tw)
    dev = consts.device
    # pixel centres of every tile's th x tw pixels, those past the canvas
    # and window edges too (cropped below)
    xp = pixel_centres(torch.arange(nx * tw), S).to(dev).reshape(1, nx, 1, tw)
    yp = pixel_centres(torch.arange(r0, r0 + ny * th), S).to(dev).reshape(ny, 1, th, 1)
    xp = xp.expand(ny, nx, 1, tw).reshape(ny * nx, 1, tw)
    yp = yp.expand(ny, nx, th, 1).reshape(ny * nx, th, 1)
    depth = torch.full((bs, ny * nx, th, tw), far, dtype=torch.float32, device=dev)
    index = torch.full((bs, ny * nx, th, tw), -1, dtype=torch.int32, device=dev)
    for k in range(int(cnt.max()) if cnt.numel() else 0):
        live = cnt > k                                        # [bs, tiles]
        f = torch.where(over, k, ids[torch.where(live & ~over, offsets + k, 0)])
        f = torch.where(live, f, 0)
        c = torch.gather(consts, 2, f[:, None, :].expand(-1, 17, -1))[..., None, None]
        c = tuple(c[:, j] for j in range(17))                 # each [bs, tiles, 1, 1]
        out, zp = face_candidate(xp, yp, c[:9], c[9:12], c[12], c[13:17], near, far)
        zcand = torch.where(out | ~live[..., None, None], torch.inf, zp)
        accept = zcand <= depth - DEPTH_MIN_DELTA
        depth = torch.where(accept, zcand, depth)
        index = torch.where(accept, f[..., None, None].to(torch.int32), index)

    def crop(t):
        t = t.reshape(bs, ny, nx, th, tw).permute(0, 1, 3, 2, 4)
        return t.reshape(bs, ny * th, nx * tw)[:, :rows, :S].contiguous()

    return crop(index), crop(depth)


def _check_bins(bins, bs, rows, S):
    """Check K8's bins; returns their pointers."""
    cnt, offsets, ids = bins
    th, tw = BIN_TILE
    n_tiles = -(-rows // th) * -(-S // tw)
    _check(cnt, "cnt", torch.int32, (bs, n_tiles))
    _check(offsets, "offsets", torch.int32, (bs, n_tiles))
    _check(ids, "ids", torch.int32, (ids.shape[0],))
    return tuple(t.data_ptr() for t in bins)


def resolve_binned_xy_plain(fvp, draw_backside, bins, image_size, near, far, row_start=0,
                            num_rows=None):
    index, depth = _binned_fold(fvp, draw_backside, bins, image_size, near, far, row_start,
                                num_rows)
    return _latch_xy(index, depth, fvp)


def resolve_binned_xy(fvp, draw_backside, bins, image_size, near, far, row_start=0,
                      num_rows=None):
    """:func:`resolve_xy` over the per-tile bins of its faces
    (:func:`bin_faces`, made for the same window and ``draw_backside``);
    the same outputs, bit for bit.  The kernel gathers each bin entry's
    face vertices and forms its constants itself (no K1)."""
    if not _use_kernel(fvp, *bins):
        return resolve_binned_xy_plain(fvp, draw_backside, bins, image_size, near, far,
                                       row_start, num_rows)
    bs, nf = _check_fvp(fvp)
    S, r0, rows = _window(image_size, row_start, num_rows)
    bin_ptrs = _check_bins(bins, bs, rows, S)
    index = fvp.new_empty((bs, rows, S), dtype=torch.int32)
    depth = fvp.new_empty((bs, rows, S))
    coords = fvp.new_empty((bs, 6, rows, S))
    _launch("resolve_binned_xy", fvp.get_device(), fvp.data_ptr(), *bin_ptrs, index.data_ptr(),
            depth.data_ptr(), coords.data_ptr(), bs, nf, S, r0, rows, int(draw_backside),
            float(near), float(far))
    return index, depth, coords


def resolve_binned_latch_plain(fvp, face_attrs, draw_backside, bins, image_size, near, far,
                               row_start=0, num_rows=None):
    index, depth = _binned_fold(fvp, draw_backside, bins, image_size, near, far, row_start,
                                num_rows)
    return _latch_copy(index, depth, fvp, face_attrs)


def resolve_binned_latch(fvp, face_attrs, draw_backside, bins, image_size, near, far,
                         row_start=0, num_rows=None):
    """:func:`resolve_latch` over the per-tile bins of its faces
    (:func:`bin_faces`); the same outputs, bit for bit."""
    if not _use_kernel(fvp, face_attrs, *bins):
        return resolve_binned_latch_plain(fvp, face_attrs, draw_backside, bins, image_size,
                                          near, far, row_start, num_rows)
    bs, nf, A = _check_latch(fvp, face_attrs, "resolve_binned_latch", binned=True)
    S, r0, rows = _window(image_size, row_start, num_rows)
    bin_ptrs = _check_bins(bins, bs, rows, S)
    out = _latch_outputs(bs, A, rows, S, fvp.device)
    _launch("resolve_binned_latch", fvp.get_device(), fvp.data_ptr(), face_attrs.data_ptr(),
            *bin_ptrs, *(t.data_ptr() for t in out), bs, nf, A, S, r0, rows,
            int(draw_backside), float(near), float(far))
    return out


def resolve_binned_depth_plain(fvp, draw_backside, bins, image_size, near, far, row_start=0,
                               num_rows=None):
    return _binned_fold(fvp, draw_backside, bins, image_size, near, far, row_start, num_rows)


def resolve_binned_depth(fvp, draw_backside, bins, image_size, near, far, row_start=0,
                         num_rows=None):
    """:func:`resolve_depth` over the per-tile bins of its faces
    (:func:`bin_faces`); the same outputs, bit for bit."""
    if not _use_kernel(fvp, *bins):
        return resolve_binned_depth_plain(fvp, draw_backside, bins, image_size, near, far,
                                          row_start, num_rows)
    bs, nf = _check_fvp(fvp)
    S, r0, rows = _window(image_size, row_start, num_rows)
    bin_ptrs = _check_bins(bins, bs, rows, S)
    index = fvp.new_empty((bs, rows, S), dtype=torch.int32)
    depth = fvp.new_empty((bs, rows, S))
    _launch("resolve_binned_depth", fvp.get_device(), fvp.data_ptr(), *bin_ptrs,
            index.data_ptr(), depth.data_ptr(), bs, nf, S, r0, rows, int(draw_backside),
            float(near), float(far))
    return index, depth


# --- K10, K11, K12: the NMR passes -----------------------------------------


def _nmr_route(entry, floats, ints=()):
    """True to launch NMR pass ``entry``'s kernel: CUDA tensors outside
    :func:`plain_versions`, which must be float32 (``floats``) and int32
    (``ints``), else ValueError.  A call on CUDA tensors inside
    :func:`plain_versions` adds one to ``LAUNCHES["nmr_plain"]``."""
    if not _on_cuda(*floats, *ints):
        return False
    if _route["plain"]:
        LAUNCHES[NMR_PLAIN] += 1
        return False
    for tensors, dtype in ((floats, torch.float32), (ints, torch.int32)):
        for t in tensors:
            if t.dtype != dtype:
                raise ValueError(f"{entry}: want {dtype} tensors, got {t.dtype}")
    return True


def _image_planes(t):
    """``t`` [bs, n, rows, W] and its batch stride, each image's planes
    contiguous (a copy only where they are not, so a slice of planes of a
    larger map, as the face-sharded path's winner planes, is read in
    place)."""
    bs, n, rows, W = t.shape
    if t.stride()[1:] != (rows * W, W, 1):
        t = t.contiguous()
    return t, t.stride(0) if bs > 1 else n * rows * W


def nmr_planes_plain(fvm_planar, face_index_map, image_size, row_start=0, weights=False):
    w = weight_planes_from_gathered(fvm_planar, face_index_map, image_size, row_start)
    foreground = (face_index_map >= 0).to(torch.float32)[:, None]
    return coordinate_planes(fvm_planar, w), (w if weights else None), foreground


def nmr_planes(fvm_planar, face_index_map, image_size, row_start=0, weights=False):
    """From the resolve's winner planes f32 [bs, 9, rows, W] (plane 3 *
    vertex + coord; the z planes are not read) and its index map i32
    [bs, rows, W] of the image rows ``row_start ..`` of an ``image_size``
    render: (the coordinate map f32 [bs, 2, rows, W] of
    :func:`resolve.coordinate_planes`; the weight planes f32 [bs, 3, rows,
    W] of :func:`resolve.weight_planes_from_gathered` when ``weights``, else
    None; the foreground f32 [bs, 1, rows, W], 1 where the index is >= 0).
    One launch, which writes the weight planes only when asked (a
    silhouette render never makes them)."""
    if not _nmr_route("nmr_planes", (fvm_planar,), (face_index_map,)):
        return nmr_planes_plain(fvm_planar, face_index_map, image_size, row_start, weights)
    fvm, fvm_batch = _image_planes(fvm_planar)
    index = face_index_map.contiguous()
    bs, _, rows, W = fvm.shape
    xp, yp = _pixel_grid(image_size, fvm.device, row_start, rows)
    coords = fvm.new_empty((bs, 2, rows, W))
    w = fvm.new_empty((bs, 3, rows, W)) if weights else None
    foreground = fvm.new_empty((bs, 1, rows, W))
    _launch("nmr_planes", fvm.get_device(), fvm.data_ptr(), index.data_ptr(), xp.data_ptr(),
            yp.data_ptr(), coords.data_ptr(), 0 if w is None else w.data_ptr(),
            foreground.data_ptr(), bs, rows, W, fvm_batch)
    return coords, w, foreground


def nmr_planes_vjp_plain(grad, fvm_planar, face_index_map, image_size, row_start=0):
    w = weight_planes_from_gathered(fvm_planar, face_index_map, image_size, row_start)
    bs, _, rows, W = grad.shape
    # each XY plane's product as the multiply's backward forms it, added to
    # zeros as autograd summed it with the other plane reads' zero-filled
    # gradients (so a -0 product reads +0)
    out = grad.new_zeros((bs, 9, rows, W))
    for k in range(3):
        for coord in range(2):
            out[:, 3 * k + coord] += grad[:, coord] * w[:, k]
    return out


def nmr_planes_vjp(grad, fvm_planar, face_index_map, image_size, row_start=0):
    """The VJP of :func:`nmr_planes`' coordinate map: its gradient f32
    [bs, 2, rows, W] -> the winner planes' f32 [bs, 9, rows, W], the weights
    (gradient-stopped) recomputed from ``fvm_planar`` and the index map;
    zeros on the z planes.  One launch."""
    if not _nmr_route("nmr_planes_vjp", (grad, fvm_planar), (face_index_map,)):
        return nmr_planes_vjp_plain(grad, fvm_planar, face_index_map, image_size, row_start)
    fvm, fvm_batch = _image_planes(fvm_planar)
    index, grad = face_index_map.contiguous(), grad.contiguous()
    bs, _, rows, W = fvm.shape
    xp, yp = _pixel_grid(image_size, fvm.device, row_start, rows)
    out = fvm.new_empty((bs, 9, rows, W))
    _launch("nmr_planes_vjp", fvm.get_device(), grad.data_ptr(), fvm.data_ptr(), index.data_ptr(),
            xp.data_ptr(), yp.data_ptr(), out.data_ptr(), bs, rows, W, fvm_batch)
    return out


def nmr_coordinate_grad_plain(images, grad, above, below, render_size):
    # differentiation imports this module
    from .differentiation import band_coordinate_grad_plain

    return band_coordinate_grad_plain(images, grad, above, below, render_size)


def _halo_rows(rows):
    """A halo's (images, grad) rows [bs, C, 1, W], columns contiguous and
    one layout for both (copies where not): (images, grad, batch stride,
    channel stride), or null pointers at an image edge."""
    if rows is None:
        return 0, 0, 0, 0
    images, grad = rows
    if images.stride(3) != 1 or images.stride() != grad.stride():
        images, grad = images.contiguous(), grad.contiguous()
    return images.data_ptr(), grad.data_ptr(), images.stride(0), images.stride(1)


def nmr_coordinate_grad(images, grad, above, below, render_size):
    """The NMR backward's coordinate gradient (x on channel 0, y on channel
    1) f32 [bs, 2, rows, W] of a band of rows of a ``render_size``-row
    image, from its images and their gradient f32 [bs, C, rows, W] (rows >
    0) and the rows just outside the band, ``above`` and ``below``
    ((images, grad) rows [bs, C, 1, W]) or None at the image's top or
    bottom edge: ``differentiation.band_coordinate_grad``'s pass.  One
    launch for both terms."""
    halo = [t for rows in (above, below) if rows is not None for t in rows]
    if not _nmr_route("nmr_coordinate_grad", (images, grad, *halo)):
        return nmr_coordinate_grad_plain(images, grad, above, below, render_size)
    images, grad = images.contiguous(), grad.contiguous()
    bs, C, rows, W = images.shape
    out = images.new_empty((bs, 2, rows, W))
    a_images, a_grad, a_batch, a_channel = _halo_rows(above)
    b_images, b_grad, b_batch, b_channel = _halo_rows(below)
    # 2 / render_size, the double rounded to float32 in the entry, as the
    # plain version's tensor divisor holds it
    _launch("nmr_coordinate_grad", images.get_device(), images.data_ptr(), grad.data_ptr(),
            a_images, a_grad, b_images, b_grad, out.data_ptr(), bs, C, rows, W, a_batch,
            a_channel, b_batch, b_channel, 2.0 / render_size)
    return out


# --- K13, K14: the loaded-atlas sampler ------------------------------------


def _atlas_parts(z_planes, uv_planes, textures, face_index_map, weight_planes, eps):
    """What the sampler computes before its taps' sum, in
    ``shading._uv_coords``'s and ``_bilinear_taps``' expressions: (the
    foreground [bs, H, W], the texel coordinates x and y, the tap weights,
    the anchors i64 [bs, 1, P] clamped to [0, T - tw - 2] (background's too),
    the four taps [bs, 3, H, W] each)."""
    # shading imports this module
    from .shading import _bilinear_taps, _uv_coords

    bs, _, th, tw = textures.shape
    H, W = face_index_map.shape[1:]
    fg = face_index_map >= 0
    x, y = _uv_coords(z_planes.unbind(1), uv_planes[:, 0::2].unbind(1),
                      uv_planes[:, 1::2].unbind(1), weight_planes.unbind(1), fg, eps)
    x0, y0, tap_w = _bilinear_taps(x, y)
    idx00 = torch.where(fg, y0 * tw + x0, -1).reshape(bs, 1, H * W)
    anchors = torch.clamp(idx00, 0, th * tw - tw - 2).long()
    flat = textures.reshape(bs, 3, th * tw)
    a = anchors.expand(-1, 3, -1)
    taps = tuple(torch.gather(flat, 2, a + off).reshape(bs, 3, H, W)
                 for off in (0, 1, tw, tw + 1))
    return fg, x, y, tap_w, anchors, taps


def atlas_sample_plain(z_planes, uv_planes, textures, face_index_map, weight_planes, eps):
    fg, _, _, tap_w, _, taps = _atlas_parts(z_planes, uv_planes, textures, face_index_map,
                                            weight_planes, eps)
    images = sum(w[:, None] * t for w, t in zip(tap_w, taps))
    return torch.where(fg[:, None], images, 0.0)


def _pixel_planes(t, name, n, bs, H, W):
    """(t, batch stride, plane stride) of f32 planes [bs, n, H, W], each
    plane's pixels contiguous (a copy only where they are not, so a slice of
    a larger map's planes is read in place)."""
    if t.dtype != torch.float32 or tuple(t.shape) != (bs, n, H, W):
        raise ValueError(f"{name}: want float32 {(bs, n, H, W)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride()[2:] != (W, 1):
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def _sampler_inputs(z_planes, uv_planes, textures, face_index_map, weight_planes):
    """The kernels' view of the sampler's inputs: ((z, uv, w planes), index,
    atlas, bs, P, tw, T, the planes' and the atlas's strides); raises on a
    dtype or a shape the kernels do not take."""
    bs, H, W = face_index_map.shape
    if face_index_map.dtype != torch.int32:
        raise ValueError(f"face_index_map: want int32, got {face_index_map.dtype}")
    index = face_index_map.contiguous()
    z, z_batch, z_plane = _pixel_planes(z_planes, "z_planes", 3, bs, H, W)
    uv, uv_batch, uv_plane = _pixel_planes(uv_planes, "uv_planes", 6, bs, H, W)
    w, w_batch, w_plane = _pixel_planes(weight_planes, "weight_planes", 3, bs, H, W)
    if textures.dtype != torch.float32 or textures.dim() != 4 or textures.shape[:2] != (bs, 3):
        raise ValueError(f"textures: want float32 ({bs}, 3, th, tw), got {textures.dtype} "
                         f"{tuple(textures.shape)}")
    th, tw = textures.shape[2:]
    T = th * tw
    if T < tw + 2:
        raise ValueError(f"textures: an atlas of {th} x {tw} texels has no room for the "
                         "four taps")
    if textures.stride()[1:] != (T, tw, 1):
        textures = textures.contiguous()
    atlas_batch = textures.stride(0) if bs > 1 else 3 * T
    strides = (z_batch, z_plane, uv_batch, uv_plane, w_batch, w_plane, atlas_batch)
    return (z, uv, w), index, textures, bs, H * W, tw, T, strides


def atlas_sample(z_planes, uv_planes, textures, face_index_map, weight_planes, eps):
    """Bilinear sampling from a loaded atlas: the winner's vertex depths f32
    [bs, 3, H, W], texel-coordinate triangle f32 [bs, 6, H, W] (u0, v0, u1,
    v1, u2, v2), the atlas f32 [bs, 3, th, tw] (a batch stride of 0 is read
    in place), the index map i32 [bs, H, W] and the weights f32 [bs, 3, H,
    W] -> RGB f32 [bs, 3, H, W], 0 on background (the forward of
    ``shading._AtlasSample``).  One launch; nothing kept for the
    backward."""
    if not _use_kernel(z_planes, uv_planes, textures, face_index_map, weight_planes):
        return atlas_sample_plain(z_planes, uv_planes, textures, face_index_map,
                                  weight_planes, eps)
    planes, index, atlas, bs, P, tw, T, strides = _sampler_inputs(
        z_planes, uv_planes, textures, face_index_map, weight_planes)
    H, W = face_index_map.shape[1:]
    out = atlas.new_empty((bs, 3, H, W))
    _launch("atlas_sample", index.get_device(), *(t.data_ptr() for t in planes),
            index.data_ptr(), atlas.data_ptr(), out.data_ptr(), bs, P, tw, T, *strides,
            float(eps))
    return out


def _min_grad(a, b, g):
    """The gradients of ``torch.minimum(a, b)`` from ``g``: split evenly at
    a tie, all to the operand taken (to both where a NaN is)."""
    half = torch.where(a == b, g / 2, g)
    return half.masked_fill(a > b, 0), half.masked_fill(a < b, 0)


def _max_grad(a, b, g):
    """The gradients of ``torch.maximum(a, b)`` from ``g``."""
    half = torch.where(a == b, g / 2, g)
    return half.masked_fill(a < b, 0), half.masked_fill(a > b, 0)


def _coord_vjp(c, w, zz, depth, eps, g):
    """The VJP of ``shading._uv_coords``'s ``interp`` before its mask: the
    clamped coordinate's gradient ``g`` onto the triangle's coordinates
    ``c``, the weights ``w`` and ``zz`` (each three planes) and the depth.
    Returns (gc, gw, gzz, gdepth), lists of three planes but gdepth."""
    wc = [w[k] * c[k] for k in range(3)]
    s = wc[0] / zz[0] + wc[1] / zz[1] + wc[2] / zz[2]
    val = s * depth
    mn01 = torch.minimum(c[0], c[1])
    lo = torch.minimum(mn01, c[2])
    mx01 = torch.maximum(c[0], c[1])
    hi = torch.maximum(mx01, c[2]) - eps
    m = torch.maximum(lo, val)
    ghi, gm = _min_grad(hi, m, g)
    glo, gval = _max_grad(lo, val, gm)
    gmx01, g2_hi = _max_grad(mx01, c[2], ghi)
    g0_hi, g1_hi = _max_grad(c[0], c[1], gmx01)
    gmn01, g2_lo = _min_grad(mn01, c[2], glo)
    g0_lo, g1_lo = _min_grad(c[0], c[1], gmn01)
    gs = gval * depth
    gwc = [gs / zz[k] for k in range(3)]
    gc = [g0_hi + g0_lo, g1_hi + g1_lo, g2_hi + g2_lo]
    gc = [gc[k] + gwc[k] * w[k] for k in range(3)]
    gw = [gwc[k] * c[k] for k in range(3)]
    gzz = [((-gs) * wc[k]) / (zz[k] * zz[k]) for k in range(3)]
    return gc, gw, gzz, gval * s


def atlas_sample_vjp_plain(grad, z_planes, uv_planes, textures, face_index_map, weight_planes,
                           eps, needs=(True, True, True, True)):
    fg, x, y, tap_w, anchors, taps = _atlas_parts(z_planes, uv_planes, textures,
                                                  face_index_map, weight_planes, eps)
    bs, _, th, tw = textures.shape
    P = anchors.shape[-1]
    # the foreground mask
    g = torch.where(fg[:, None], grad, 0.0)
    g_atlas = None
    if needs[2]:
        # each tap's three channels at its texel: K6's function
        g12 = torch.cat([g * t[:, None] for t in tap_w], 1).reshape(bs, 12, P)
        marked = torch.where(fg.reshape(bs, P), anchors[:, 0].int(), -1)
        g_atlas = atlas_taps_grad_plain(g12, marked, tw, th * tw).reshape(bs, 3, th, tw)
    # the tap weights' gradients onto x and y (floor's gradient is 0)
    gt = [(g[:, 0] * t[:, 0] + g[:, 1] * t[:, 1]) + g[:, 2] * t[:, 2] for t in taps]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx0, wx1 = x0f + 1 - x, x - x0f
    wy0, wy1 = y0f + 1 - y, y - y0f
    gx = (gt[1] * wy0 + gt[3] * wy1) - (gt[0] * wy0 + gt[2] * wy1)
    gy = (gt[2] * wx0 + gt[3] * wx1) - (gt[0] * wx0 + gt[1] * wx1)
    # the perspective-correct coordinates
    z, w = z_planes.unbind(1), weight_planes.unbind(1)
    zz = [z[k] + 1e-10 for k in range(3)]
    total = w[0] / zz[0] + 1e-10 + w[1] / zz[1] + 1e-10 + w[2] / zz[2] + 1e-10
    depth = 1.0 / total
    gu, gw_u, gzz_u, gdepth_u = _coord_vjp(uv_planes[:, 0::2].unbind(1), w, zz, depth, eps, gx)
    gv, gw_v, gzz_v, gdepth_v = _coord_vjp(uv_planes[:, 1::2].unbind(1), w, zz, depth, eps, gy)
    gS = (-(gdepth_u + gdepth_v)) * (depth * depth)
    gw = [gw_u[k] + gw_v[k] + gS / zz[k] for k in range(3)]
    gz = [gzz_u[k] + gzz_v[k] + ((-gS) * w[k]) / (zz[k] * zz[k]) for k in range(3)]

    def planes(ps):
        return torch.where(fg[:, None], torch.stack(ps, 1), 0.0)

    guv = [p for k in range(3) for p in (gu[k], gv[k])]
    return (planes(gz) if needs[0] else None, planes(guv) if needs[1] else None, g_atlas,
            planes(gw) if needs[3] else None)


def atlas_sample_vjp(grad, z_planes, uv_planes, textures, face_index_map, weight_planes, eps,
                     needs=(True, True, True, True)):
    """The VJP of :func:`atlas_sample`: RGB's gradient f32 [bs, 3, H, W] ->
    (the depths' f32 [bs, 3, H, W], the texel coordinates' f32 [bs, 6, H,
    W], the atlas's f32 [bs, 3, th, tw], the weights' f32 [bs, 3, H, W]),
    each contiguous, or None where ``needs`` (four flags in that order) says
    it is not wanted.  One launch, after the atlas gradient's zero fill:
    everything the forward computed recomputed, each tap's three channels
    added at its texel as K6 adds them.  Gradients split evenly at the
    uv-bbox clamp's ties, as ``torch.minimum`` and ``torch.maximum``'s;
    background pixels' are 0."""
    if not _use_kernel(grad, z_planes, uv_planes, textures, face_index_map, weight_planes):
        return atlas_sample_vjp_plain(grad, z_planes, uv_planes, textures, face_index_map,
                                      weight_planes, eps, needs)
    planes, index, atlas, bs, P, tw, T, strides = _sampler_inputs(
        z_planes, uv_planes, textures, face_index_map, weight_planes)
    H, W = face_index_map.shape[1:]
    if grad.dtype != torch.float32 or tuple(grad.shape) != (bs, 3, H, W):
        raise ValueError(f"grad: want float32 {(bs, 3, H, W)}, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    grad = grad.contiguous()
    outs = [atlas.new_empty((bs, n, H, W)) if need else None
            for n, need in zip((3, 6), needs[:2])]
    g_atlas = (torch.zeros((bs, 3, *textures.shape[2:]), dtype=torch.float32,
                           device=atlas.device) if needs[2] else None)
    g_w = atlas.new_empty((bs, 3, H, W)) if needs[3] else None
    _launch("atlas_sample_vjp", index.get_device(), grad.data_ptr(),
            *(t.data_ptr() for t in planes), index.data_ptr(), atlas.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (*outs, g_w, g_atlas)), bs, P, tw, T,
            *strides, float(eps))
    return outs[0], outs[1], g_atlas, g_w


# --- K15, K16: the lights ---------------------------------------------------

# a light's row of the table the lights' kernels read: colour (3),
# direction (3), exponent (1)
LIGHT_FIELDS = 7
# at most this many lights a launch: a bit each in the kernels' kind masks
# (kMaxLights in csrc/lights_shade.cu)
MAX_LIGHTS = 64
# the lights' kernels' block of pixels (kThreads): K16 sums the table's
# gradient over each block of this many pixels of an image
LIGHTS_BLOCK = 256


def lights_shade_plain(rgb, normals, weights, table, kinds):
    # shading imports this module
    from .shading import color_weight_planes, normal_planes

    return rgb * color_weight_planes(normal_planes(normals, weights), table, kinds)


def _lights_vjp_parts(grad, rgb, normals, weights, table, kinds, terms):
    """What K16 computes per pixel, in its order and association: (the
    colour weight, the per-pixel normals' gradient, each [bs, H, W] planes
    of three, and with ``terms`` the table gradient's terms [bs, L, 7, H,
    W], else None)."""
    from .shading import light_intensity, normal_planes

    n = normal_planes(normals, weights)
    N, g = n.unbind(1), grad.unbind(1)
    g_cw = [g[c] * rgb[:, c] for c in range(3)]
    zero = torch.zeros_like(N[0])
    cw, gN, rows = [zero] * 3, [zero] * 3, []
    for l, (kind, backside) in enumerate(kinds):
        row = table[:, l, :, None, None]
        col = [row[:, c] for c in range(3)]
        term = [zero] * LIGHT_FIELDS
        if kind == "ambient":
            cw = [cw[c] + col[c] for c in range(3)]
            term[:3] = g_cw
        else:
            pre, base, value = light_intensity(n, table[:, l], kind, backside)
            cw = [cw[c] + value * col[c] for c in range(3)]
            term[:3] = [g_cw[c] * value for c in range(3)]
            gi = (g_cw[0] * col[0] + g_cw[1] * col[1]) + g_cw[2] * col[2]
            gbase = gi
            if kind == "specular":
                # pow's backward: self's 0 where alpha is 0, the exponent's 0
                # where the base is 0 and alpha >= 0
                a = row[:, 6]
                gbase = torch.where(a == 0, 0.0, gi * (a * base ** (a - 1)))
                term[6] = gi * torch.where((base == 0) & (a >= 0), 0.0, value * torch.log(base))
            # _abs's gradient +-1 (+1 at 0); relu's passes where its output
            # is above 0
            gpre = (torch.where(pre >= 0, gbase, -gbase) if backside
                    else torch.where(base <= 0, 0.0, gbase))
            if kind == "directional":
                gN = [gN[c] + gpre * (-row[:, 3 + c]) for c in range(3)]
                term[3:6] = [-(gpre * N[c]) for c in range(3)]
            else:
                gN[2] = gN[2] + (-gpre)
        if terms:
            rows.append(torch.stack(term, 1))
    if not terms:
        return cw, gN, None
    return cw, gN, (torch.stack(rows, 1) if rows
                    else table.new_zeros((*table.shape, *rgb.shape[2:])))


def lights_shade_vjp_plain(grad, rgb, normals, weights, table, kinds, needs=(True, True, True)):
    cw, gN, terms = _lights_vjp_parts(grad, rgb, normals, weights, table, kinds, needs[2])
    g_rgb = torch.stack([grad[:, c] * cw[c] for c in range(3)], 1) if needs[0] else None
    g_normals = (torch.stack([gN[c] * weights[:, k] for k in range(3) for c in range(3)], 1)
                 if needs[1] else None)
    return g_rgb, g_normals, None if terms is None else terms.sum((3, 4))


def _light_masks(kinds):
    """The kernels' kind masks (directional, specular, backside) of
    ``kinds``: bit l of each for light l, as int64 values."""
    masks = [0, 0, 0]
    for l, (kind, backside) in enumerate(kinds):
        masks[0] |= (kind == "directional") << l
        masks[1] |= (kind == "specular") << l
        masks[2] |= bool(backside) << l
    return [m - (1 << 64) if m >> 63 else m for m in masks]


def _lights_inputs(rgb, normals, weights, table, kinds):
    """The kernels' view of the lights' inputs: ((rgb, normals, weights
    planes), their strides, the table, bs, H, W); raises on a dtype, a shape
    or a number of lights the kernels do not take."""
    if rgb.dim() != 4:
        raise ValueError(f"rgb: want float32 (bs, 3, H, W), got {tuple(rgb.shape)}")
    bs, _, H, W = rgb.shape
    rgb, rgb_batch, rgb_plane = _pixel_planes(rgb, "rgb", 3, bs, H, W)
    normals, n_batch, n_plane = _pixel_planes(normals, "normals", 9, bs, H, W)
    weights, w_batch, w_plane = _pixel_planes(weights, "weights", 3, bs, H, W)
    L = len(kinds)
    if L > MAX_LIGHTS:
        raise ValueError(f"lights: the kernels take at most {MAX_LIGHTS} lights, got {L}")
    if table.dtype != torch.float32 or tuple(table.shape) != (bs, L, LIGHT_FIELDS):
        raise ValueError(f"table: want float32 {(bs, L, LIGHT_FIELDS)}, got {table.dtype} "
                         f"{tuple(table.shape)}")
    strides = (rgb_batch, rgb_plane, n_batch, n_plane, w_batch, w_plane)
    return (rgb, normals, weights), strides, table.contiguous(), bs, H, W


def lights_shade(rgb, normals, weights, table, kinds):
    """The lights' shading of RGB f32 [bs, 3, H, W] at the per-pixel normals
    of the winner's vertex normals f32 [bs, 9, H, W] (plane 3 * vertex +
    xyz; a slice of a larger map's planes is read in place) and the weights
    f32 [bs, 3, H, W]: ``shading.normal_planes``, then the colour weight of
    ``kinds`` (one (kind, backside) pair a light, kind "ambient",
    "directional" or "specular") over their fields ``table`` f32 [bs, L, 7]
    (``shading.light_table``), times the RGB -> f32 [bs, 3, H, W].  One
    launch; nothing kept for the backward."""
    if not _use_kernel(rgb, normals, weights, table):
        return lights_shade_plain(rgb, normals, weights, table, kinds)
    planes, strides, table, bs, H, W = _lights_inputs(rgb, normals, weights, table, kinds)
    out = planes[0].new_empty((bs, 3, H, W))
    _launch("lights_shade", table.get_device(), *(t.data_ptr() for t in planes),
            table.data_ptr(), out.data_ptr(), bs, H * W, len(kinds), *_light_masks(kinds),
            *strides)
    return out


def lights_shade_vjp(grad, rgb, normals, weights, table, kinds, needs=(True, True, True)):
    """The VJP of :func:`lights_shade`: the shaded RGB's gradient f32 [bs,
    3, H, W] -> (the RGB's f32 [bs, 3, H, W], the normal planes' f32 [bs, 9,
    H, W], the table's f32 [bs, L, 7]), each contiguous, or None where
    ``needs`` (three flags in that order) says it is not wanted; the weights
    take none.  One launch, everything the forward computed recomputed; the
    table's gradient as partial sums over blocks of pixels, which one
    ``torch.sum`` adds (no extra work where it is not asked for)."""
    if not _use_kernel(grad, rgb, normals, weights, table):
        return lights_shade_vjp_plain(grad, rgb, normals, weights, table, kinds, needs)
    planes, strides, table, bs, H, W = _lights_inputs(rgb, normals, weights, table, kinds)
    if grad.dtype != torch.float32 or tuple(grad.shape) != (bs, 3, H, W):
        raise ValueError(f"grad: want float32 {(bs, 3, H, W)}, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    grad = grad.contiguous()
    P, L = H * W, len(kinds)
    g_rgb = grad.new_empty((bs, 3, H, W)) if needs[0] else None
    g_normals = grad.new_empty((bs, 9, H, W)) if needs[1] else None
    partials = (grad.new_empty((bs, -(-P // LIGHTS_BLOCK), L, LIGHT_FIELDS)) if needs[2]
                else None)
    _launch("lights_shade_vjp", table.get_device(), grad.data_ptr(),
            *(t.data_ptr() for t in planes), table.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (g_rgb, g_normals, partials)), bs, P, L,
            *_light_masks(kinds), *strides)
    return g_rgb, g_normals, None if partials is None else partials.sum(1)
