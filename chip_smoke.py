#!/usr/bin/env python3
"""Drive the PyTorch port's optimisation steps on one CUDA GPU: silhouettes,
textured, lit and depth rendering, both at high resolution, and the
user-facing path (OBJ I/O, examples 1-5, the convergence fit).

    python3 chip_smoke.py

Builds the hand-written kernels from ``neural_renderer_v2_pytorch_tpu_torch
/csrc`` (one nvcc per source, in parallel) and then, for each path:

- silhouettes: checks each kernel against its plain PyTorch version on the
  card (K2, which forms the face constants itself, also against K7 + K8
  with and without backfaces), the whole forward+backward against the
  plain versions and against a golden made by the JAX package, takes five
  Adam steps of a vertex fit (launch counts read around it: no path
  launches K1), and repeats the checks on an 81,920-face mesh;
- the loaded-atlas sampler: K13 and K14 against their plain versions (K13
  and K14's depth and texel-coordinate gradients bit-equal) at the cell
  ``atlas-fit-256``'s shapes, 32 views of 512^2 over one 1190 x 1920
  atlas (``sampler_phase``), each timed beside its bound;
- textured: checks K5, K2L, K3 and K6 (at ``atlas``, over the anchors its
  step scatters to) against their plain versions at the
  ``atlas``, ``lit`` and ``textured-scale`` configurations, the ``atlas``
  and ``lit`` steps through ``Renderer.render`` (and depth and
  ``rasterize_all`` at ``atlas``) against the plain versions, the RGB
  golden, and takes five Adam steps of an atlas + vertex fit (launch counts
  read around it);
- high resolution (``hires``: 81,920 faces at 1024^2 AA, resolve at 2048^2;
  ``hires-lit``: 158,720 faces, lit, 512^2 AA): checks K7's bins (from the
  face vertices) against their plain version, every K8 form against
  K2/K2L/K2D and against its plain version there, with and without
  backfaces, and against the plain resolve at ``bench`` and at S = 100;
  checks K1 and K3 against their plain versions at both paths' shapes;
  runs both resolve routes at all seven configurations (images,
  index maps and gradients held against each other, each route timed, the
  rule's choice printed) and at five tori between them that sweep the
  route threshold; holds both steps against the plain versions; takes
  five Adam steps of a ``hires`` vertex fit and one ``hires-lit`` step, and
  drives ``compute_face_index_map`` and ``render_depth`` (launch counts
  read around each: no K1 on any path, ``check_k1``), then the same
  ``compute_face_index_map`` calls through the compiled core (a forward
  graph each, K2D at ``lit``, K7 capped and K8 at ``hires-lit``; ids and
  depth bit-equal to the eager entry's);
- sharded rendering (``parallel``): holds K9 ``gather_rows`` bit-equal to
  its plain version at the face-sharded path's shapes (``scale``, D = 9;
  ``textured-scale``, D = 27) in both layouts, then runs five meshes on
  ranks that share the one card through gloo (NCCL takes one rank per
  card): ``scale-face2`` and ``textured-scale-face2`` (faces over 2 ranks),
  ``bench-tile2`` and ``atlas-tile2-backgrounds`` (rows over 2; the atlas
  scene blended over a seeded background, whose gradient is checked too)
  and ``all-axes`` (the lit scene, two views, over (2, 2, 2): 8 ranks).
  Each rank runs the global stage on its row band (the NMR backward's
  1-row halos exchanged) and gathers the finished images; it holds its
  step to the single-device step on the card (images and its index band
  equal, cross-shard near-tie pixels counted, gradients within 1e-4 of
  their largest magnitude), takes the collective census (no collective
  of render-size planes) and the launch counts around it; then takes the
  same step through the compiled core (the rank's chain of CUDA graphs,
  one per stretch between two collectives, the collectives run eagerly
  between the replays): four calls, the second capturing, each held to
  the eager sharded step (images equal, gradients within 1e-4, the same
  census), a replayed step launching no kernel eagerly (its eager
  operations counted and named), and at the face-2 runs K9 and the
  id/depth resolve held in the replayed chain; and times eager and graphed
  steps and their collectives (by kind) in turns; every rank's gradients
  must be the same bits as every other rank's, eager and graphed.  These
  times show what a step costs when ranks share a card, not how the path
  scales;

- the user-facing path (``examples``): ``utils.scenes.write_example_data``
  at 256^2 and its torus OBJ through ``load_obj`` (int32 faces on the
  card, the fan triangulation of the written quads), then examples 1-4
  through their ``run()`` at 256^2 with anti-aliasing (example 1's 90
  views; 30 steps of examples 2-4), example 5's sharded fit at 64^2 on two
  ranks sharing the card, and the convergence fit (the JAX package's
  tests/test_rasterize.py:165-204: two triangles, IoU loss, the port's
  ``Adam(lr=0.005)``, 256^2 without anti-aliasing) to below 0.01 within
  350 steps.  Each fit's first step is held to the plain versions (images
  and index map equal, gradients within 1e-4) and timed (median step ms,
  device operations and busy share per step); each run's launches are
  read around it (every kernel of its path, no K1, at most one K4 vertex
  -> slot table per fit), each loss must fall and each GIF be written;
- the face-vertex gather and its transpose (K5, K4) at the meshes of
  ``bench`` (and ``atlas``), ``scale`` and ``textured-scale``, batch 1 and
  8: K5 bit-equal to its plain version, K4 to the plain version on CPU
  copies (batch 2 too) and to itself on a second call, each in one device
  operation; each timed in turns with its library yardstick, beside its
  device time and bound; and the host-time split of one K4, one K5 and one
  K9 wrapper call into the parts of the packed launch path (K9's beside
  the alternatives its parts were chosen from, and K9 launched through a
  typed entry, ``tools/launch_abi.cu``, in turns with the packed one);
- the redesigned kernels: K7 at the four binned configurations and on a
  crowded tile (one bin whose ids span two of the order pass's bitmap
  windows) in turns with its parent design (``tools/bin_faces_designs.cu``),
  both bit-equal to the plain bins, K7 in at most four device operations
  and a readback;
  K9 in turns with ``torch.gather`` at ``scale`` (D = 9) and
  ``textured-scale`` (D = 27); K3 in turns with its parent design
  (``tools/resolve_scatter_parents.cu``), its 32 x 8-pixel block and
  ``index_add_`` at ``bench`` (D = 6), ``atlas`` (15), ``lit`` (36) and
  K9's transpose at ``textured-scale`` (27), each within 1e-4 of the plain
  version and K3 in at most two device operations; K6 at ``atlas`` in turns
  with its designs (``tools/atlas_taps_designs.cu``: float atomics only,
  warp aggregation of equal anchors with and without float2 pairs), the
  parent's K6 with its three folds and copy, and ``index_add_`` over the
  four taps after a zero fill, each within 1e-4 of the plain version and
  K6 in at most two device operations; the tiled forms (every
  CTA loading every face, the next batch into registers) in turns with the
  parent's forms (the same feed) and with the designs of ``TILED_DESIGNS``
  (``tools/resolve_designs.cu``: the face stream multicast by bulk copies
  across clusters of 1, 2, 4 and 8 CTAs, or 2 of its 9 runs) at ``bench``
  (K2, K2D), ``atlas`` and ``lit`` (K2L) and ``scale`` (K2 over 81,920
  faces), all bit-equal;
  each K8 form (a CTA per bin, from the face vertices) in turns with the
  parent's K8 alone (a CTA per bin over K1's constants), with the parent's
  chain K1 + K7 + K8 beside K7 + K8, and with the warp-per-bin design
  (static stride or atomic counter), at ``hires`` (XY), ``hires-lit``
  (copy, id/depth) and on the crowded tile, all bit-equal;

then times each kernel, its plain version, the one PyTorch call that
computes the same function where there is one, and each step, with CUDA
events and the profiler's device time, beside the least time the card
could take for the same work.  All of the above runs under ``nr.eager()``,
op by op, as before the compiled core, so that each launch check counts
its steps' launches as they run.  Last, the compiled core
(``ops/graphs.py``): at ``bench``, ``atlas`` and ``lit`` (the tiled
route) and ``scale`` and ``hires`` (the binned route, K7 in its capped
form) through the user's entry points, under ``bench.py``'s loss, the
graphed core (each
render replays a CUDA graph captured at its second call) and the whole step
captured by its caller (camera, render, loss, backward and ``bench.py``'s
update in one ``torch.cuda.graph``) against the eager step: images equal,
gradients within 1e-4, the graphs holding the eager step's launches, a
replay from the second call, step t's outputs intact after step t + 1 and
no output a graph's buffer; the three forms timed in turns (CUDA events,
busy share and operations under the profiler), the capture seconds
logged; int64 faces over 10 steps in one capture and one K4 table, an
in-place edit of them captured anew, a no_grad render equal, and at
``scale`` a graph captured with half its pair total's slots: its replay
bit-equal with overflow bins, which it reports, and the next call
captured anew at twice the capacity; the same capacity in a whole step
captured by its caller: bit-equal replays, each adding its overflow word
to K7's counts (``graphs.bin_counters``); K7 + K8 over exact, half-capacity and
zero-capacity bins timed in turns; ``compute_face_index_map`` eager and
graphed in turns at ``lit`` and ``hires-lit``, and the sharded runs'
eager and graphed per-rank steps.  Each five-step
fit builds one vertex -> slot table for K4
(``resolve_cuda.SLOT_TABLE_BUILDS``).  Then the measurement modules
(``neural_renderer_v2_pytorch_tpu_torch/benchmarks/``, whose ``steps`` and
``roofline`` also hold this script's step forms, profiler reading and
bounds): ``bench`` at 20 chained iterations and 2 cycles (its chained step
held to the eager step: images equal, gradients within 1e-4),
``measure_time`` over 4 azimuths, ``scaling --quick``, ``kernel_census``
and ``roofline`` at ``bench`` and ``hires`` (K9, and K14 in the atlas's
gradient step), each module's JSON line
printed and checked.  Last, the JAX package's pipeline edge cases
(``utils.scenes.edge_scenes``, its tests/test_pipeline_edge.py at 32^2: a
face off screen, a face clipped by the near plane, one face, a batch of an
empty and a full slot with and without anti-aliasing, three random soups of
duplicate and degenerate faces, their RGBA over a ``create_textures`` atlas
and over a loaded one) on the tiled and the binned route, eager and
graphed: images, index maps, ``to_map`` rows and gradients held to the plain
versions on the card, and the mixed batch's whole step captured by its
caller on each route; every kernel but K1 launched in that phase.  Last,
on a machine with two cards or more, the sharded entry with one rank per
card over NCCL (phase 23): the runs above that fit the cards (and the lit
two-view scene at (1, 2, 2) and (2, 2, 1) in the place of (2, 2, 2)),
each rank held to the single-device step (images and index band equal,
gradients within 1e-5 of their largest magnitude, every rank's the same
bits), eagerly and through its chain, which must be one forward and one
backward CUDA graph holding the eager step's collectives; every rank
again while the last one forgets its chain and captures alone; each
rank's eager and graphed step ms in turns, the NCCL device ms by kind,
and ``scale`` at 512^2 over 1, 2 and 4 cards (Mpx/s, efficiency); on one
card it logs that it did not run.  And the whole run's seconds.

Any failure raises and the script exits non-zero without its last line.  On
success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
There is no CPU path: without CUDA the script fails.
"""

import collections
import contextlib
import ctypes
import hashlib
import json
import logging
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

import neural_renderer_v2_pytorch_tpu_torch as nr
from neural_renderer_v2_pytorch_tpu_torch import parallel
from neural_renderer_v2_pytorch_tpu_torch.benchmarks import (
    bench,
    kernel_census,
    measure_time,
    roofline,
    scaling,
)
from neural_renderer_v2_pytorch_tpu_torch.benchmarks.roofline import (
    HBM_BYTES_PER_S,
    atlas_taps_inputs,
    atlas_taps_library,
    atlas_taps_work,
    bound,
    gather_faces3_work,
    gather_rows_work,
    resolve_bound,
    scatter_pixels_work,
    scatter_vertices_work,
)
from neural_renderer_v2_pytorch_tpu_torch.benchmarks.steps import (
    GRAD_RTOL,
    UPDATE,
    CallerGraph,
    EagerOps,
    GraphCase,
    bench_loss,
    call_device_ms,
    case_graph,
    check_against,
    check_close,
    check_equal,
    kernel_device_ms,
    median_ms,
    profile_device,
    time_forms,
)
from neural_renderer_v2_pytorch_tpu_torch.ops import graphs
from neural_renderer_v2_pytorch_tpu_torch.ops import resolve_cuda as rc
from neural_renderer_v2_pytorch_tpu_torch.ops.gather_resolve import (
    gather_face_vertices,
    resolve_and_gather,
)
from neural_renderer_v2_pytorch_tpu_torch.ops.rasterize import face_attributes
from neural_renderer_v2_pytorch_tpu_torch.ops.resolve import DEPTH_MIN_DELTA
from neural_renderer_v2_pytorch_tpu_torch.utils import cuda_build
from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import (
    EDGE_SIZE,
    EDGE_TEXTURE_SIZE,
    atlas_scene,
    edge_scenes,
    icosphere,
    lit_light_arrays,
    texel_scene,
    torus,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
RGB_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_rgb_golden.npz")
PKG = "neural_renderer_v2_pytorch_tpu_torch"
TPU_KERNELS = "neural_renderer_v2_pytorch_tpu/ops/resolve_pallas.py"
# name -> (source, the TPU kernel it replaces, the configuration its times
# in the kernels line come from)
NMR_REPLACES = "none: XLA fuses the chain"
SAMPLER_REPLACES = "none: XLA fused the sampler"
# the loaded-atlas sampler (K13, K14) at the benchmark cell atlas-fit-256's
# shapes: the atlas scene's torus (40, 32) over one 1190 x 1920 atlas seen
# from 32 azimuths (elevation 30, distance 2.732) at 256^2 AA (512^2 renders)
SAMPLER_LABEL = "atlas-fit-32x512"
SAMPLER_VIEWS = 32
KERNELS = {
    "face_setup": (f"{PKG}/csrc/face_setup.cu", f"{TPU_KERNELS}:180", "hires"),
    "resolve_xy": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:348", "bench"),
    "resolve_latch": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:348", "atlas"),
    "resolve_depth": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:348", "bench"),
    "scatter_pixels_to_faces": (f"{PKG}/csrc/scatter_pixels_to_faces.cu", f"{TPU_KERNELS}:1512", "bench"),
    "scatter_faces_to_vertices": (f"{PKG}/csrc/scatter_faces_to_vertices.cu", f"{TPU_KERNELS}:2741", "bench"),
    "gather_faces3": (f"{PKG}/csrc/gather_rows.cu", f"{TPU_KERNELS}:2605", "atlas"),
    "atlas_taps_grad": (f"{PKG}/csrc/atlas_taps_grad.cu", f"{TPU_KERNELS}:2090", "atlas"),
    "bin_faces": (f"{PKG}/csrc/bin_faces.cu", f"{TPU_KERNELS}:1020", "hires"),
    "resolve_binned_xy": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:858", "hires"),
    "resolve_binned_latch": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:858", "hires-lit"),
    "resolve_binned_depth": (f"{PKG}/csrc/resolve.cu", f"{TPU_KERNELS}:858", "hires-lit"),
    "gather_rows": (f"{PKG}/csrc/gather_rows.cu", f"{TPU_KERNELS}:2277", "textured-scale"),
    "nmr_planes": (f"{PKG}/csrc/nmr_planes.cu", NMR_REPLACES, "nmr-32x512"),
    "nmr_planes_vjp": (f"{PKG}/csrc/nmr_planes.cu", NMR_REPLACES, "nmr-32x512"),
    "nmr_coordinate_grad": (f"{PKG}/csrc/nmr_planes.cu", NMR_REPLACES, "nmr-32x512"),
    "atlas_sample": (f"{PKG}/csrc/atlas_sample.cu", SAMPLER_REPLACES, SAMPLER_LABEL),
    "atlas_sample_vjp": (f"{PKG}/csrc/atlas_sample.cu", SAMPLER_REPLACES, SAMPLER_LABEL),
}
# every resolve form computes the face constants itself, K7 each face's
# bbox: no path launches K1 (check_k1)
SILHOUETTE_KERNELS = ("resolve_xy", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                      "gather_faces3")
TEXTURED_KERNELS = ("resolve_latch", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                    "gather_faces3", "atlas_sample", "atlas_sample_vjp")
HIRES_KERNELS = ("bin_faces", "resolve_binned_xy", "scatter_pixels_to_faces",
                 "scatter_faces_to_vertices", "gather_faces3")
HIRES_LIT_KERNELS = ("bin_faces", "resolve_binned_latch", "scatter_pixels_to_faces",
                     "scatter_faces_to_vertices", "gather_faces3")
INDEX_MAP_KERNELS = ("resolve_depth", "bin_faces", "resolve_binned_depth",
                     "resolve_binned_latch")
# the NMR passes, which no TPU kernel did (K10, K11, K12): one launch each
# a render
NMR_KERNELS = ("nmr_planes", "nmr_planes_vjp", "nmr_coordinate_grad")
# the NMR passes at the benchmark cells' shapes (silhouettes): label ->
# (batch, render size), mesh164k's 32 x 512^2 and recon's 128 x 128^2
NMR_SHAPES = {"nmr-32x512": (32, 512), "nmr-128x128": (128, 128)}
# the least bytes a pixel each NMR pass moves (float32, int32): K10 reads
# the six XY planes and the index map and writes the coordinate map and the
# foreground (40; 52 with the weight planes), K11 reads the coordinate
# map's gradient, the XY planes and the index map and writes nine planes
# (72), K12 reads C image and C gradient planes and writes two (16 at C = 1)
NMR_BYTES = {"nmr_planes": 40, "nmr_planes_vjp": 72, "nmr_coordinate_grad": 16}
# tori whose 512^2 silhouettes sweep the route threshold: 9,920 (the perf
# matrix's 9K row), 19,888, 26,000, 32,480, 39,680 (its 39K row), 50,400
# and 62,000 faces
SWEEP_TORI = ((80, 62), (113, 88), (130, 100), (145, 112), (160, 124), (180, 140), (200, 155))
GOLDEN_IMAGE_ATOL = 1e-5   # CUDA's pow and the card's sums against XLA:CPU
# name -> (scene, texture_size, lit, image_size, anti_aliasing): rows of the
# JAX package's perf matrix (README.md:119-136, benchmarks/scaling.py:154-247),
# and hires-lit, the lit row's scene and lights on the 158,720-face mesh at
# 512^2 AA, where the resolve runs at 1024^2 with A = 27
TEXTURED = {
    "atlas": (lambda: atlas_scene(40, 32), None, False, 256, True),
    "lit": (lambda: texel_scene(40, 32, 2), 2, True, 256, True),
    "textured-scale": (lambda: texel_scene(320, 248, 2), 2, False, 512, False),
    "hires-lit": (lambda: texel_scene(320, 248, 2), 2, True, 512, True),
}
# the sharded runs (``parallel``), on ranks that share the one card through
# gloo (NCCL takes one rank per card): name -> (data, tile, face) mesh.
# scale-face2 and textured-scale-face2 are scale and textured-scale with
# their faces over two ranks (the JAX package's auto_mesh gives two devices
# a face axis from 20K faces on); bench-tile2 is bench over two row bands
# (auto_mesh's choice for a small mesh); atlas-tile2-backgrounds is atlas
# over two row bands, blended over a seeded background image; all-axes is
# the lit scene, two views, at the JAX package's multichip shape (2, 2, 2)
SHARDED = {
    "scale-face2": (1, 1, 2),
    "textured-scale-face2": (1, 1, 2),
    "bench-tile2": (1, 2, 1),
    "atlas-tile2-backgrounds": (1, 2, 1),
    "all-axes": (2, 2, 2),
}
SHARDED_TIMEOUT = 300.0   # seconds for one spawn of ranks, every collective included
SHARDED_STEPS = 5         # timed steps of each sharded run on each rank
LATCH_FORMS = ("resolve_xy", "resolve_latch", "resolve_binned_xy", "resolve_binned_latch")


def log(msg):
    print(msg, flush=True)


def check_k1(label, launches):
    """No path launches K1: the resolve forms of both routes compute the
    face constants themselves, and K7 each face's bbox."""
    if launches["face_setup"]:
        raise AssertionError(f"{label}: {launches['face_setup']} K1 launches: {launches}")


# one kernel at one configuration: its call, its plain version's (None where
# that would take minutes), the least time the card could take for the same
# work as (ms, "bytes" | "operations"), and the one PyTorch call that
# computes the same function, where there is one
Call = collections.namedtuple("Call", "kernel plain bound library", defaults=(None,))


def index_add_call(out, dim, index, source):
    """The library yardstick of a scatter: one ``index_add_`` (its inputs
    prepared beforehand; the port never calls it)."""
    return lambda: out.index_add_(dim, index, source)


def covered_index_add(out, dim, index, source):
    """:func:`index_add_call` over the covered entries only: those of the
    flat ``index`` that are >= 0, with their slices of ``source`` along
    ``dim`` taken out beforehand, as the scatter kernels add no background
    pixel."""
    keep = (index >= 0).nonzero()[:, 0]
    return index_add_call(out, dim, index[keep].long(),
                          source.index_select(dim, keep).contiguous())


def scatter_check(label, index, nf, D, gen):
    """K3 against its plain version on random gradients over ``D`` planes of
    ``index``'s shape.  Returns (max_abs_err, Call)."""
    S = index.shape[1:]
    g = torch.randn((1, D, *S), generator=gen, device=index.device)
    err = check_close(f"{label} scatter_pixels_to_faces D={D}",
                      rc.scatter_pixels_to_faces(g, index, nf),
                      rc.scatter_pixels_to_faces_plain(g, index, nf))
    return err, Call(
        lambda: rc.scatter_pixels_to_faces(g, index, nf),
        lambda: rc.scatter_pixels_to_faces_plain(g, index, nf),
        bound(*scatter_pixels_work(index, D, nf)),
        covered_index_add(torch.zeros((D, nf), device=index.device), 1, index.reshape(-1),
                          g.reshape(D, -1)),
    )


def ndc_scene(vertices, faces, dev, azimuth=0.0):
    """World mesh -> (NDC vertices [1, nv, 3], faces i32) through the port's camera."""
    r = nr.Renderer(dev)
    r.viewpoints = nr.get_points_from_angles(2.732, 30, azimuth)
    v = torch.tensor(vertices[None], device=dev)
    return r.transform_vertices(v), torch.tensor(faces, device=dev)


def on_plain(fn):
    """``fn`` run on the plain versions."""
    def run():
        with rc.plain_versions():
            return fn()
    return run


def nmr_inputs(bs, S, gen):
    """Winner planes f32 [bs, 9, S, S] as the silhouette resolve leaves them
    (zero z planes, 0 on background, about half the pixels covered) and
    their index map i32 [bs, S, S]."""
    dev = gen.device
    fim = torch.randint(0, 1000, (bs, S, S), generator=gen, device=dev, dtype=torch.int32)
    fim[torch.rand((bs, S, S), generator=gen, device=dev) < 0.5] = -1
    fvm = torch.rand((bs, 9, S, S), generator=gen, device=dev) * 2 - 1
    fvm[:, 2::3] = 0.0
    fvm *= (fim >= 0)[:, None]
    return fvm, fim


def nmr_kernels_vs_plain(label, fvm, fim, gen):
    """K10 (with and without the weight planes), K11 and K12 (C = 1, a
    silhouette) bit-equal to their plain versions on winner planes ``fvm``
    f32 [bs, 9, S, S] and their index map ``fim`` of an S^2 render.
    Returns ({name: max_abs_err}, {name: Call}), the calls in the
    silhouette's forms."""
    bs, _, S, _ = fvm.shape
    images = (fim >= 0).to(torch.float32)[:, None]
    grad = torch.randn((bs, 1, S, S), generator=gen, device=fvm.device)
    grad_coords = torch.randn((bs, 2, S, S), generator=gen, device=fvm.device)
    for weights in (False, True):
        got = rc.nmr_planes(fvm, fim, S, 0, weights)
        want = on_plain(lambda: rc.nmr_planes(fvm, fim, S, 0, weights))()
        for part, g, w in zip(("coords", "weights", "foreground"), got, want):
            if w is not None:
                check_equal(f"{label} nmr_planes weights={weights} {part}", g, w)
    forms = {
        "nmr_planes": lambda: rc.nmr_planes(fvm, fim, S),
        "nmr_planes_vjp": lambda: rc.nmr_planes_vjp(grad_coords, fvm, fim, S),
        "nmr_coordinate_grad": lambda: rc.nmr_coordinate_grad(images, grad, None, None, S),
    }
    errs = {"nmr_planes": 0.0}
    for name in ("nmr_planes_vjp", "nmr_coordinate_grad"):
        errs[name] = check_equal(f"{label} {name}", forms[name](), on_plain(forms[name])())
    pixels = bs * S * S
    calls = {name: Call(fn, on_plain(fn), bound(NMR_BYTES[name] * pixels, 0))
             for name, fn in forms.items()}
    log(f"[{label}] NMR kernels bit-equal to their plain versions: {bs} x {S}^2, "
        f"coverage {float(images.mean()):.4f}")
    return errs, calls


def sampler_inputs(dev):
    """The loaded-atlas sampler's inputs at :data:`SAMPLER_LABEL`'s render,
    as the render passed them (``roofline.atlas_sample_inputs``): (z
    planes, texel-coordinate planes, the atlas expanded over the views, the
    index map, the weight planes)."""
    v, f, vt, ft, tex = atlas_scene(40, 32)
    r = nr.Renderer(dev)
    r.image_size = 256
    azimuths = torch.arange(SAMPLER_VIEWS, dtype=torch.float32) * (360.0 / SAMPLER_VIEWS)
    r.viewpoints = nr.get_points_from_angles(torch.full_like(azimuths, 2.732),
                                             torch.full_like(azimuths, 30.0), azimuths).to(dev)
    x = torch.tensor(v[None], device=dev).expand(SAMPLER_VIEWS, -1, -1)
    atlas = torch.tensor(tex, device=dev).requires_grad_(True)
    vt = torch.tensor(vt, device=dev).expand(SAMPLER_VIEWS, -1, -1)
    with torch.enable_grad():
        images = r.render(x, torch.tensor(f, device=dev), vt, torch.tensor(ft, device=dev),
                          atlas.expand(SAMPLER_VIEWS, -1, -1, -1))
    return tuple(t.detach() for t in roofline.atlas_sample_inputs(images)[:5])


def sampler_kernels_vs_plain(label, inputs, gen):
    """K13 bit-equal to its plain version, K14's depth and texel-coordinate
    gradients bit-equal to its plain VJP's and its atlas gradient within
    1e-4 of its largest (atomics), at the sampler's ``inputs``.  Each call's
    bound: K13 reads the index map and writes RGB (16 bytes a pixel), a
    covered pixel's nine depth and texel-coordinate planes and three weights
    (48 bytes) and the atlas once; K14 reads the index map and RGB's
    gradient and writes the nine depth and texel-coordinate gradient planes
    (52 bytes a pixel), reads a covered pixel's 48 bytes and the atlas
    once, and writes the [bs, 3, T] atlas gradient once (its zero fill).
    Returns ({name: max_abs_err}, {name: Call})."""
    z, uv, atlas, fim, w = inputs
    bs, _, H, W = z.shape
    T = atlas.shape[2] * atlas.shape[3]
    grad = torch.randn((bs, 3, H, W), generator=gen, device=z.device)
    needs = (True, True, True, False)
    forms = {
        "atlas_sample": lambda: rc.atlas_sample(z, uv, atlas, fim, w, 1e-5),
        "atlas_sample_vjp": lambda: rc.atlas_sample_vjp(grad, z, uv, atlas, fim, w, 1e-5, needs),
    }
    errs = {"atlas_sample": check_equal(f"{label} atlas_sample", forms["atlas_sample"](),
                                        on_plain(forms["atlas_sample"])())}
    got, want = forms["atlas_sample_vjp"](), on_plain(forms["atlas_sample_vjp"])()
    for k, part in ((0, "z"), (1, "uv")):
        check_equal(f"{label} atlas_sample_vjp {part}", got[k], want[k])
    errs["atlas_sample_vjp"] = check_close(f"{label} atlas_sample_vjp atlas", got[2], want[2])
    pixels, covered = bs * H * W, int((fim >= 0).sum())
    atlas_once = 12 * T
    nbytes = {"atlas_sample": 16 * pixels + 48 * covered + atlas_once,
              "atlas_sample_vjp": 52 * pixels + 48 * covered + atlas_once + 12 * bs * T}
    calls = {name: Call(fn, on_plain(fn), bound(nbytes[name], 0)) for name, fn in forms.items()}
    log(f"[{label}] sampler kernels vs plain: {bs} x {H}x{W}, atlas {tuple(atlas.shape[2:])} "
        f"(batch stride {atlas.stride(0)}), coverage {covered / pixels:.4f}, "
        f"max_abs_err {json.dumps(errs)}")
    return errs, calls


def sampler_phase(dev, gen):
    """K13 and K14 against their plain versions at :data:`SAMPLER_LABEL`'s
    shapes, and each call's device ms (CUDA events, and the profiler's
    records: K14's with its zero fill), bound and plain ms.  Returns
    ({name: max_abs_err}, {name: Call}, {name: times})."""
    errs, calls = sampler_kernels_vs_plain(SAMPLER_LABEL, sampler_inputs(dev), gen)
    times = {}
    for name, call in calls.items():
        k_ms = median_ms(call.kernel, 50)
        prof = profile_kept(call.kernel)
        k_dev = call_device_ms(prof)
        p_ms = median_ms(call.plain, 10, warmup=1)
        times[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=call.bound[0],
                           bound_by=call.bound[1], library_ms=None, device_ms=k_dev)
        log(f"[time] {SAMPLER_LABEL} {name}: kernel {k_ms:.4f} ms (device, every record of "
            f"the call: {'not measured' if k_dev is None else f'{k_dev:.4f} ms'}), plain "
            f"{p_ms:.4f} ms, bound {call.bound[0]:.4f} ms by {call.bound[1]}")
    return errs, calls, times


def kernels_vs_plain(label, ndc, faces, size, gen):
    """Each silhouette kernel against its plain version at one scene's
    shapes.  Returns ({name: max_abs_err}, {name: Call})."""
    dev = ndc.device
    nv, nf = ndc.shape[1], faces.shape[0]
    table = ndc.detach().contiguous()
    fvp = rc.gather_faces3(table, faces)
    errs, calls = {}, {}
    faces_long = faces.long()
    errs["gather_faces3"] = check_equal(f"{label} gather_faces3", fvp,
                                        rc.gather_faces3_plain(table, faces))
    calls["gather_faces3"] = Call(lambda: rc.gather_faces3(table, faces),
                                  lambda: rc.gather_faces3_plain(table, faces),
                                  bound(*gather_faces3_work(1, nv, nf)),
                                  lambda: table[:, faces_long])

    for backside in (True, False):
        ck, cp = rc.face_setup(fvp, backside), rc.face_setup_plain(fvp, backside)
        errs["face_setup"] = check_equal(f"{label} face_setup draw_backside={backside}", ck, cp)
        # K2 against K7 + K8 on the same faces (against the plain fold below)
        check_parts(f"{label} resolve_xy vs K7 + K8, draw_backside={backside}",
                    rc.resolve_xy(fvp, backside, size, 0.1, 100.0),
                    rc.resolve_binned_xy(fvp, backside, rc.bin_faces(fvp, backside, size), size,
                                         0.1, 100.0))
    consts = rc.face_setup(fvp, True)

    ik, dk, xk = rc.resolve_xy(fvp, True, size, 0.1, 100.0)
    ip, dp, xp = rc.resolve_xy_plain(fvp, True, size, 0.1, 100.0)
    diff = ik != ip
    if diff.any():
        gap = float((dk - dp).abs()[diff].max())
        raise AssertionError(
            f"{label} resolve_xy: {int(diff.sum())} pixels differ, depth gap {gap}"
        )
    check_equal(f"{label} resolve_xy depth", dk, dp)
    check_equal(f"{label} resolve_xy coords", xk, xp)
    errs["resolve_xy"] = 0.0
    coverage = float((ik >= 0).float().mean())
    calls["resolve_xy"] = Call(
        lambda: rc.resolve_xy(fvp, True, size, 0.1, 100.0),
        lambda: rc.resolve_xy_plain(fvp, True, size, 0.1, 100.0),
        resolve_bound(consts, size, 8, 36),
    )

    errs["scatter_pixels_to_faces"], calls["scatter_pixels_to_faces"] = scatter_check(
        label, ik, nf, 6, gen)

    # the NMR passes over these winner planes, in the nine-plane layout
    z = torch.zeros_like(xk[:, :1])
    fvm = torch.cat([xk[:, 0:2], z, xk[:, 2:4], z, xk[:, 4:6], z], 1)
    nmr_errs, nmr_calls = nmr_kernels_vs_plain(label, fvm, ik, gen)
    errs.update(nmr_errs)
    calls.update(nmr_calls)

    g9 = torch.randn((1, 3, 3, nf), generator=gen, device=dev)
    # on the card the plain version's index_add_ sums with atomics: compare
    # with it on CPU copies, where it sums in K4's order
    errs["scatter_faces_to_vertices"] = check_equal(
        f"{label} scatter_faces_to_vertices vs plain on CPU copies",
        rc.scatter_faces_to_vertices(g9, faces, nv).cpu(),
        rc.scatter_faces_to_vertices_plain(g9.cpu(), faces.cpu(), nv),
    )
    calls["scatter_faces_to_vertices"] = Call(
        lambda: rc.scatter_faces_to_vertices(g9, faces, nv),
        lambda: rc.scatter_faces_to_vertices_plain(g9, faces, nv),
        bound(*scatter_vertices_work(1, nv, nf)),
        index_add_call(torch.zeros((1, nv, 3), device=dev), 1, faces_long.reshape(-1),
                       g9.permute(0, 3, 2, 1).reshape(1, nf * 3, 3).contiguous()),
    )
    torch.cuda.synchronize()
    log(f"[{label}] kernels vs plain: nf={nf} canvas={size}^2 coverage={coverage:.4f} "
        f"max_abs_err={json.dumps(errs)}")
    return errs, calls


def check_one_slot_table(label):
    """A fit that passes one faces tensor every step builds K4's vertex ->
    slot table once (read right after the fit's steps)."""
    if rc.SLOT_TABLE_BUILDS != 1:
        raise AssertionError(f"{label}: {rc.SLOT_TABLE_BUILDS} vertex -> slot table "
                             f"builds, want 1")


def host_ms(fn):
    """One call's time on the host clock, synchronised (for plain versions
    that take seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_parts(label, got, want, parts=("index", "depth", "coords", "attrs")):
    for part, g, w in zip(parts, got, want):
        check_equal(f"{label} {part}", g, w)


def binned_kernels(label, fvp, consts, attrs, size, gen):
    """K1 against its plain version on the path's faces (``consts``, K1's
    constants, feed only the bounds: no path launches K1); with and without
    backfaces, K7 against its plain version on the whole canvas and on the
    row window S/2 .. S/2 + S/4 and each K8 form against the tiled form
    (K2, K2L, K2D) there; with backfaces each K8 form against its own plain
    version (the bin-by-bin fold, one call) on the whole canvas; and K3
    against its plain version over the path's planes (D = 6 without
    attributes, else 9 + A) of the resolved index map.  Returns ({name:
    max_abs_err}, {name: Call}) for K3, K7, the K8 forms and the tiled
    forms at these shapes."""
    S, nf, A = size, fvp.shape[-1], attrs.shape[-1]
    for backside in (True, False):
        check_equal(f"{label} face_setup draw_backside={backside}",
                    rc.face_setup(fvp, backside), rc.face_setup_plain(fvp, backside))
    if not torch.equal(consts, rc.face_setup(fvp, True)):
        raise AssertionError(f"{label}: the constants are not K1's of these faces")
    window = (S // 2, S // 4)
    plain_ms = {}
    for backside in (False, True):
        bins = rc.bin_faces(fvp, backside, S)
        check_parts(f"{label} bin_faces draw_backside={backside}", bins,
                    rc.bin_faces_plain(fvp, backside, S), ("cnt", "offsets", "ids"))
        win_bins = rc.bin_faces(fvp, backside, S, *window)
        check_parts(f"{label} bin_faces window {window} draw_backside={backside}", win_bins,
                    rc.bin_faces_plain(fvp, backside, S, *window), ("cnt", "offsets", "ids"))
        forms = {   # name -> (binned form on bins b, tiled form, plain binned form)
            "resolve_binned_xy": (
                lambda b, *w, d=backside: rc.resolve_binned_xy(fvp, d, b, S, 0.1, 100.0, *w),
                lambda *w, d=backside: rc.resolve_xy(fvp, d, S, 0.1, 100.0, *w),
                lambda: rc.resolve_binned_xy_plain(fvp, True, bins, S, 0.1, 100.0)),
            "resolve_binned_latch": (
                lambda b, *w, d=backside: rc.resolve_binned_latch(fvp, attrs, d, b, S, 0.1,
                                                                  100.0, *w),
                lambda *w, d=backside: rc.resolve_latch(fvp, attrs, d, S, 0.1, 100.0, *w),
                lambda: rc.resolve_binned_latch_plain(fvp, attrs, True, bins, S, 0.1, 100.0)),
            "resolve_binned_depth": (
                lambda b, *w, d=backside: rc.resolve_binned_depth(fvp, d, b, S, 0.1, 100.0, *w),
                lambda *w, d=backside: rc.resolve_depth(fvp, d, S, 0.1, 100.0, *w),
                lambda: rc.resolve_binned_depth_plain(fvp, True, bins, S, 0.1, 100.0)),
        }
        for name, (binned, tiled, plain) in forms.items():
            check_parts(f"{label} {name} vs tiled, draw_backside={backside}", binned(bins),
                        tiled())
            check_parts(f"{label} {name} vs tiled, window {window}, draw_backside={backside}",
                        binned(win_bins, *window), tiled(*window))
            if backside:
                want, plain_ms[name] = host_ms(plain)
                check_parts(f"{label} {name} vs plain", binned(bins), want)
    cnt = bins[0]
    pairs = int(cnt.sum())
    index = forms["resolve_binned_depth"][0](bins)[0]
    bin_bytes = 8 * cnt.numel() + 4 * pairs
    log(f"[{label}] K7 bins from the face vertices equal to plain (canvas and window, with and "
        f"without backfaces), every K8 form bit-equal to the tiled form (both ways) and to its "
        f"plain version: nf={nf} A={A} canvas={S}^2 "
        f"coverage={float((index >= 0).float().mean()):.4f} pairs={pairs} "
        f"({pairs / nf:.3f} per face) max bin {int(cnt.max())}; one plain call (host ms) "
        f"{json.dumps(plain_ms)}")
    tiled_forms = {"resolve_binned_xy": "resolve_xy", "resolve_binned_latch": "resolve_latch",
                   "resolve_binned_depth": "resolve_depth"}
    # (output planes, per-face input bytes: the face vertices, + 4 A of
    # attributes for the copy form; each form reads them once at least)
    shape = {"resolve_binned_xy": (8, 36), "resolve_binned_latch": (11 + A, 36 + 4 * A),
             "resolve_binned_depth": (2, 36)}
    errs = {}
    errs["scatter_pixels_to_faces"], k3 = scatter_check(label, index, nf, 9 + A if A else 6, gen)
    calls = {"scatter_pixels_to_faces": k3,
             "face_setup": Call(lambda: rc.face_setup(fvp, True),
                                lambda: rc.face_setup_plain(fvp, True), bound(104 * nf, 30 * nf)),
             # the six x/y coordinates of every face, the bins written
             "bin_faces": Call(lambda: rc.bin_faces(fvp, True, S),
                               lambda: rc.bin_faces_plain(fvp, True, S),
                               bound(24 * nf + bin_bytes, 0))}
    for name, (binned, tiled, _) in forms.items():
        planes, face_bytes = shape[name]
        calls[name] = Call(lambda binned=binned: binned(bins), plain_ms[name],
                           resolve_bound(consts, S, planes, face_bytes, bin_bytes))
        calls[tiled_forms[name]] = Call(tiled, None, resolve_bound(consts, S, planes, face_bytes))
    log(f"[{label}] K1 bit-equal to plain, K3 over D={9 + A if A else 6} max abs err "
        f"{errs['scatter_pixels_to_faces']}")
    return errs, calls


def binned_vs_plain_resolve(label, ndc, faces, size, gen):
    """Each K8 form, and K2D, against the plain resolve (the sequential fold
    over all faces) on the whole canvas and on the row window S/2 .. S/2 +
    S/4.  Returns {"resolve_depth": Call} at these shapes."""
    fvp = rc.gather_faces3(ndc, faces)
    consts = rc.face_setup(fvp, True)
    attrs = torch.randn((1, faces.shape[0], 6), generator=gen, device=ndc.device)
    for window in ((), (size // 2, size // 4)):
        args = (size, 0.1, 100.0, *window)
        want_xy = rc.resolve_xy_plain(fvp, True, *args)
        want_latch = rc.resolve_latch_plain(fvp, attrs, True, *args)
        want = rc.resolve_depth_plain(fvp, True, *args)
        bins = rc.bin_faces(fvp, True, size, *window)
        check_parts(f"{label} resolve_binned_xy vs plain {window}",
                    rc.resolve_binned_xy(fvp, True, bins, *args), want_xy)
        check_parts(f"{label} resolve_binned_latch vs plain {window}",
                    rc.resolve_binned_latch(fvp, attrs, True, bins, *args), want_latch)
        check_parts(f"{label} resolve_binned_depth vs plain {window}",
                    rc.resolve_binned_depth(fvp, True, bins, *args), want)
        check_parts(f"{label} resolve_depth vs plain {window}",
                    rc.resolve_depth(fvp, True, *args), want)
    log(f"[{label}] every K8 form and K2D bit-equal to the plain resolve at "
        f"{size}^2, whole canvas and rows {size // 2}..{size // 2 + size // 4 - 1}")
    return {"resolve_depth": Call(lambda: rc.resolve_depth(fvp, True, size, 0.1, 100.0),
                                  lambda: rc.resolve_depth_plain(fvp, True, size, 0.1, 100.0),
                                  resolve_bound(consts, size, 2, 36))}


def routes_agree(label, step, fim, resolve, shape, smi):
    """One step (``step()`` -> (images, {name: gradient})) and the index
    map (``fim()``) through each route: images and index maps equal,
    gradients within GRAD_RTOL of their largest magnitude.  Times the
    resolve (``resolve(route)``: the tiled form alone, or K7 and K8) on
    each route.
    Returns ({route: ms}, the rule's route)."""
    out = {}
    for route in rc.ROUTES:
        with rc.forced_route(route):
            images, grads = step()
            out[route] = (images, grads, fim())
    (it, gt, ft), (ib, gb, fb) = out["tiled"], out["binned"]
    check_equal(f"{label} images, binned vs tiled", ib, it)
    check_equal(f"{label} index map, binned vs tiled", fb, ft)
    errs = {name: check_close(f"{label} {name} grads, binned vs tiled", gb[name], gt[name])
            for name in gt}
    with torch.no_grad():
        ms = {route: median_ms(lambda: resolve(route), 10) for route in rc.ROUTES}
    rule = rc.resolve_route(*shape)
    log(f"[routes] {label} (bs, rows, S, nf)={shape}: images and index maps equal, grad max "
        f"abs err {json.dumps(errs)}; resolve ms tiled {ms['tiled']:.4f} binned "
        f"{ms['binned']:.4f}; the rule picks {rule}, measured faster "
        f"{min(ms, key=ms.get)}  ({smi})")
    return ms, rule


def pattern_loss(images):
    """Squared distance to a fixed diagonal pattern.  Unlike bench_loss it
    gives silhouette edges a gradient without anti-aliasing too (on a binary
    image bench_loss's NMR gradients cancel)."""
    i = torch.arange(images.shape[-1], device=images.device)
    target = ((i[:, None] + i[None, :]) % 7).float() / 6.0
    return torch.sum((images - target) ** 2)


def sil_step(r, v, f, loss_fn):
    """A silhouette step through ``r.render_silhouettes``: fresh vertices
    from ``v``, ``loss_fn`` of the images, backward; returns the images and
    the vertex gradient."""
    def step():
        xx = v.clone().requires_grad_(True)
        images = r.render_silhouettes(xx, f)
        loss_fn(images).backward()
        return images.detach(), {"vertices": xx.grad}
    return step


def index_map(renderer, vertices, faces, latch_z):
    with torch.no_grad():
        fvp = gather_face_vertices(renderer.transform_vertices(vertices), faces)
        size = renderer.image_size * (2 if renderer.anti_aliasing else 1)
        return resolve_and_gather(fvp, size, renderer.near, renderer.far,
                                  renderer.draw_backside, None, latch_z)[0]


def steps_vs_plain(label, step, fim):
    """``step()`` -> (images, {name: gradient}) with the kernels and with
    their plain versions: images and index map (``fim()``) bit-equal,
    gradients within GRAD_RTOL of their largest magnitude."""
    out = []
    for ctx in (contextlib.nullcontext(), rc.plain_versions()):
        with ctx:
            images, grads = step()
            out.append((images, grads, fim()))
    (ik, gk, fk), (ip, gp, fp) = out
    check_equal(f"{label} images", ik, ip)
    check_equal(f"{label} index map", fk, fp)
    errs = {}
    for name in gp:
        if not torch.isfinite(gk[name]).all() or float(gk[name].abs().max()) == 0.0:
            raise AssertionError(f"{label}: {name} gradients not finite or all zero")
        errs[name] = check_close(f"{label} {name} grads", gk[name], gp[name])
    log(f"[{label}] step kernels vs plain: images/index equal, grad max abs err "
        f"{json.dumps(errs)} (max |g| "
        f"{json.dumps({k: float(v.abs().max()) for k, v in gp.items()})}), "
        f"coverage {float((fk >= 0).float().mean()):.4f}")


def slice_vs_plain(label, renderer, vertices, faces, loss_fn):
    """Forward+backward through Renderer.render_silhouettes with the kernels
    and with their plain versions."""
    def step():
        x = vertices.clone().requires_grad_(True)
        images = renderer.render_silhouettes(x, faces)
        loss_fn(images).backward()
        return images.detach(), {"vertices": x.grad}

    steps_vs_plain(label, step, lambda: index_map(renderer, vertices, faces, False))


class Textured:
    """One textured configuration on the card (see TEXTURED)."""

    def __init__(self, name, dev):
        make_scene, texture_size, lit, image_size, anti_aliasing = TEXTURED[name]
        v, f, vt, ft, tex = make_scene()
        self.name = name
        self.renderer = r = nr.Renderer(dev)
        r.image_size, r.anti_aliasing, r.texture_size = image_size, anti_aliasing, texture_size
        r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
        self.vertices = torch.tensor(v[None], device=dev)
        self.faces = torch.tensor(f, device=dev)
        self.vt = torch.tensor(vt, device=dev)
        self.ft = torch.tensor(ft, device=dev)
        self.textures = torch.tensor(tex, device=dev)
        self.light_arrays = lit_light_arrays() if lit else None
        self.size = image_size * (2 if anti_aliasing else 1)

    def lights(self):
        """Fresh lights whose colours take gradients, or None."""
        if self.light_arrays is None:
            return None
        cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
               "specular": nr.SpecularLight}
        out = []
        for kind, arrays in self.light_arrays:
            fields = {k: torch.tensor(a, device=self.vertices.device) for k, a in arrays.items()}
            fields["color"].requires_grad_(True)
            out.append(cls[kind](**fields))
        return tuple(out)

    def params(self, textures=None, lights=None):
        return nr.RasterizeParam(
            vertices_textures=self.vt, faces_textures=self.ft,
            textures=self.textures if textures is None else textures,
            texture_size=self.renderer.texture_size, lights=lights,
        )

    def step(self, entry="rgba"):
        """Forward + backward of sum(image^2), the perf matrix's loss:
        (images, {name: gradient}) into the vertices, the atlas (``atlas``)
        and the light colours (``lit``)."""
        x = self.vertices.clone().requires_grad_(True)
        tex = self.textures.clone().requires_grad_(self.name == "atlas")
        lights = self.lights()
        if entry == "rgba":
            images = self.renderer.render(x, self.faces, self.vt, self.ft, tex, lights=lights)
        elif entry == "depth":
            images = self.renderer.render_depth(x, self.faces)
        else:
            r = self.renderer
            hp = nr.RasterizeHyperparam(image_size=r.image_size, anti_aliasing=r.anti_aliasing)
            images = nr.rasterize_all(r.transform_vertices(x), self.faces,
                                      self.params(tex, lights), hp)
        torch.sum(images * images).backward()
        grads = {"vertices": x.grad}
        if tex.grad is not None:
            grads["textures"] = tex.grad
        for i, light in enumerate(lights or ()):
            grads[f"light{i}_color"] = light.color.grad
        return images.detach(), grads

    def fim(self):
        return index_map(self.renderer, self.vertices, self.faces, True)

    def latch_inputs(self):
        """(table, fvp, consts, face attributes) as the RGB path builds them."""
        with torch.no_grad():
            ndc = self.renderer.transform_vertices(self.vertices).contiguous()
            fvp = gather_face_vertices(ndc, self.faces)
            attrs = face_attributes(ndc, self.faces, fvp, self.params(lights=self.lights()))
        return ndc, fvp, rc.face_setup(fvp, True), attrs.contiguous()


def atlas_grad_inputs(cfg, gen):
    """K6's inputs at an atlas configuration: random gradients g12 f32
    [1, 12, P] over the anchors its step scatters to (read from the graph
    of one render, ``roofline.atlas_taps_inputs``); (g12, anchors, tw,
    T)."""
    tex = cfg.textures.clone().requires_grad_(True)
    with torch.enable_grad():
        anchors, tw, T = atlas_taps_inputs(
            cfg.renderer.render(cfg.vertices, cfg.faces, cfg.vt, cfg.ft, tex))
    g12 = torch.randn((1, 12, anchors.shape[1]), generator=gen, device=anchors.device)
    return g12, anchors, tw, T


def textured_kernels_vs_plain(cfg, gen):
    """K5, K2L, K3 (D = 9 + A) and, for ``atlas``, K6 against their plain
    versions at a configuration's shapes.  Returns ({name: max_abs_err},
    {name: Call}, ms of the one plain resolve call)."""
    ndc, fvp, consts, attrs = cfg.latch_inputs()
    S, nf, A = cfg.size, fvp.shape[-1], attrs.shape[-1]
    errs, calls = {}, {}
    errs["gather_faces3"] = check_equal(f"{cfg.name} gather_faces3", fvp,
                                        rc.gather_faces3_plain(ndc, cfg.faces))
    nv, faces_long = ndc.shape[1], cfg.faces.long()
    calls["gather_faces3"] = Call(lambda: rc.gather_faces3(ndc, cfg.faces),
                                  lambda: rc.gather_faces3_plain(ndc, cfg.faces),
                                  bound(*gather_faces3_work(1, nv, nf)),
                                  lambda: ndc[:, faces_long])

    got = rc.resolve_latch(fvp, attrs, True, S, 0.1, 100.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rc.resolve_latch_plain(fvp, attrs, True, S, 0.1, 100.0)
    torch.cuda.synchronize()
    plain_resolve_ms = (time.perf_counter() - t0) * 1e3
    for part, g, w in zip(("index", "depth", "coords", "attrs"), got, want):
        check_equal(f"{cfg.name} resolve_latch {part}", g, w)
    errs["resolve_latch"] = 0.0
    index = got[0]
    calls["resolve_latch"] = Call(
        lambda: rc.resolve_latch(fvp, attrs, True, S, 0.1, 100.0),
        lambda: rc.resolve_latch_plain(fvp, attrs, True, S, 0.1, 100.0),
        resolve_bound(consts, S, 11 + A, 36 + 4 * A),
    )

    errs["scatter_pixels_to_faces"], calls["scatter_pixels_to_faces"] = scatter_check(
        cfg.name, index, nf, 9 + A, gen)

    if cfg.renderer.texture_size is None:
        g12, anchors, tw, T = atlas_grad_inputs(cfg, gen)
        errs["atlas_taps_grad"] = check_close(
            f"{cfg.name} atlas_taps_grad", rc.atlas_taps_grad(g12, anchors, tw, T),
            rc.atlas_taps_grad_plain(g12, anchors, tw, T))
        calls["atlas_taps_grad"] = Call(
            lambda: rc.atlas_taps_grad(g12, anchors, tw, T),
            lambda: rc.atlas_taps_grad_plain(g12, anchors, tw, T),
            bound(*atlas_taps_work(anchors, T)),
            atlas_taps_library(g12, anchors, tw, T),
        )
    torch.cuda.synchronize()
    log(f"[{cfg.name}] kernels vs plain: nf={nf} A={A} canvas={S}^2 coverage="
        f"{float((index >= 0).float().mean()):.4f} max_abs_err={json.dumps(errs)}; "
        f"one plain resolve call {plain_resolve_ms:.1f} ms")
    return errs, calls, plain_resolve_ms


def rgb_golden(dev):
    """The JAX package's RGB golden (stored NDC: the camera is bypassed):
    index map equal, images within GOLDEN_IMAGE_ATOL, gradients within
    GRAD_RTOL of their largest magnitude."""
    gold = np.load(RGB_GOLDEN)
    faces = torch.tensor(gold["faces"], device=dev)
    hp = nr.RasterizeHyperparam(image_size=64)
    errs = {}
    for name, (_, f, vt, ft, tex), lit in (("atlas", atlas_scene(40, 32, 40, 64), False),
                                         ("lit", texel_scene(40, 32, 2), True)):
        leaves = {"vertices": gold["ndc"], "vertices_textures": vt, "textures": tex}
        arrays = [a for _, a in lit_light_arrays()] if lit else []
        for i, a in enumerate(arrays):
            leaves.update({f"light{i}_{k}": v for k, v in a.items()})
        t = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in leaves.items()}
        lights = None
        if lit:
            lights = (
                nr.DirectionalLight(t["light0_color"], t["light0_direction"]),
                nr.AmbientLight(t["light1_color"]),
                nr.SpecularLight(t["light2_color"]),
            )
        params = nr.RasterizeParam(
            vertices_textures=t["vertices_textures"], faces_textures=torch.tensor(ft, device=dev),
            textures=t["textures"], texture_size=2 if lit else None, lights=lights,
        )
        images = nr.rasterize_rgba(t["vertices"], faces, params, hp)
        torch.sum(images * images).backward()
        errs[f"{name} image"] = check_close(
            f"golden {name} image", images.detach().cpu(),
            torch.tensor(gold[f"{name}_image"]), rtol=GOLDEN_IMAGE_ATOL,
        )
        for key in gold.files:
            if key.startswith(f"{name}_grad_"):
                errs[key] = check_close(f"golden {key}", t[key[len(name) + 6:]].grad.cpu(),
                                        torch.tensor(gold[key]))
    with torch.no_grad():
        x = torch.tensor(gold["ndc"], device=dev)
        fim = resolve_and_gather(gather_face_vertices(x, faces), 128, 0.1, 100.0, True,
                                 None, True)[0]
    check_equal("golden RGB index map", fim.cpu(), torch.tensor(gold["fim"]))
    log(f"[golden rgb] index map equal to JAX, max abs errs {json.dumps(errs)}")


def gather_rows_check(label, table, index):
    """K9 against its plain version in both layouts at a face path's shapes:
    the per-face rows [1, nf, D] the winner gather reads and the index map
    it gathers over (-1 on background).  Returns the planar form's Call."""
    bs, n, D = table.shape
    ids = index.reshape(bs, -1).contiguous()
    P = ids.shape[1]
    for planar in (True, False):
        check_equal(f"{label} gather_rows D={D} planar={planar}",
                    rc.gather_rows(table, ids, planar), rc.gather_rows_plain(table, ids, planar))
    named = int(torch.unique(ids[ids >= 0]).numel())
    row_ms = median_ms(lambda: rc.gather_rows(table, ids, False), 50)
    log(f"[{label}] K9 gather_rows bit-equal to plain, planar and row layouts: n={n} D={D} "
        f"P={P} coverage={float((ids >= 0).float().mean()):.4f} rows named {named}; "
        f"row layout {row_ms:.4f} ms")
    gather_index = ids.clamp(min=0).long()[..., None].expand(bs, P, D)
    return Call(lambda: rc.gather_rows(table, ids, True),
                lambda: rc.gather_rows_plain(table, ids, True),
                bound(*gather_rows_work(ids, D)),
                lambda: torch.gather(table, 1, gather_index))


class ShardedCase:
    """One sharded run's global inputs (see SHARDED), made alike on every
    rank: the NDC vertices and, textured, the texels, the lights' tensors
    and the background image as leaves that take gradients; the entry it
    renders through and its loss (scale's, bench's, or the perf matrix's
    sum(rgba^2))."""

    def __init__(self, name, dev, shape=None):
        self.name, self.shape = name, SHARDED[name] if shape is None else shape
        tex, lights, self.texture_size = None, (), 2
        if name == "scale-face2":
            v, f = icosphere(6)
            azimuths, self.image_size, self.anti_aliasing = (30.0,), 512, False
            self.loss = pattern_loss
        elif name == "bench-tile2":
            v, f = torus(40, 32)
            azimuths, self.image_size, self.anti_aliasing = (0.0,), 256, True
            self.loss = bench_loss
        elif name == "textured-scale-face2":
            v, f, vt, ft, tex = texel_scene(320, 248, 2)
            azimuths, self.image_size, self.anti_aliasing = (0.0,), 512, False
        elif name == "atlas-tile2-backgrounds":
            make_scene, self.texture_size, _, self.image_size, self.anti_aliasing = \
                TEXTURED["atlas"]
            v, f, vt, ft, tex = make_scene()
            azimuths = (0.0,)
        else:
            v, f, vt, ft, tex = texel_scene(40, 32, 2)
            lights = lit_light_arrays()
            azimuths, self.image_size, self.anti_aliasing = (0.0, 45.0), 128, True
        self.size = self.image_size * (2 if self.anti_aliasing else 1)
        ndc = []
        for azimuth in azimuths:
            r = nr.Renderer(dev)
            r.viewpoints = nr.get_points_from_angles(2.732, 30, azimuth)
            with torch.no_grad():
                ndc.append(r.transform_vertices(torch.tensor(v[None], device=dev)))
        bs = len(azimuths)
        self.faces = torch.tensor(f, device=dev)
        self.leaves = {"vertices": torch.cat(ndc)}
        self.entry = "silhouettes" if tex is None else "rgba"
        if tex is not None:
            self.loss = lambda images: torch.sum(images * images)
            self.vt = torch.tensor(np.repeat(vt, bs, 0), device=dev)
            self.ft = torch.tensor(ft, device=dev)
            self.leaves["textures"] = torch.tensor(np.repeat(tex, bs, 0), device=dev)
        self.lights = [(kind, list(arrays)) for kind, arrays in lights]
        for i, (_, arrays) in enumerate(lights):
            for field, a in arrays.items():
                self.leaves[f"light{i}_{field}"] = torch.tensor(a, device=dev)
        if name.endswith("-backgrounds"):
            rng = np.random.RandomState(0)
            self.leaves["backgrounds"] = torch.tensor(
                rng.rand(bs, 3, self.size, self.size).astype(np.float32), device=dev)

    def step(self, mesh=None):
        """Forward + backward, sharded over ``mesh`` or on this device alone:
        (images, {leaf: gradient}, the collectives the forward counted)."""
        t = {k: v.clone().requires_grad_(True) for k, v in self.leaves.items()}
        params = None
        if self.entry == "rgba":
            cls = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
                   "specular": nr.SpecularLight}
            lights = tuple(cls[kind](**{field: t[f"light{i}_{field}"] for field in fields})
                           for i, (kind, fields) in enumerate(self.lights)) or None
            params = nr.RasterizeParam(vertices_textures=self.vt, faces_textures=self.ft,
                                       textures=t["textures"], texture_size=self.texture_size,
                                       lights=lights, backgrounds=t.get("backgrounds"))
        hp = nr.RasterizeHyperparam(image_size=self.image_size, anti_aliasing=self.anti_aliasing)
        if mesh is None:
            images = getattr(nr, f"rasterize_{self.entry}")(t["vertices"], self.faces, params, hp)
        else:
            images = getattr(parallel, f"rasterize_{self.entry}_sharded")(
                t["vertices"], self.faces, params, hp, mesh=mesh)
        forward = dict(parallel.COLLECTIVES)
        self.loss(images).backward()
        return images.detach(), {k: v.grad for k, v in t.items()}, forward

    def band(self, mesh):
        """(this rank's batch slice of the face vertices [bl, nf, 3, 3], its
        row window (row_start, rows), the per-rank face count)."""
        data, tile, face = self.shape
        bl = self.leaves["vertices"].shape[0] // data
        d = mesh.coords["data"]
        fv = self.leaves["vertices"][d * bl:(d + 1) * bl][:, self.faces.long()]
        rows = parallel.band_rows(self.image_size, self.anti_aliasing, tile)
        return fv, (mesh.coords["tile"] * rows, rows), -(-self.faces.shape[0] // face)


def check_index_band(label, case, mesh):
    """This rank's band of the sharded index map (the face-sharded resolve
    with face > 1, else the windowed resolve) against the single-device map
    of the whole canvas: equal, rows past the image bottom background.
    Returns the cross-shard near-tie pixels: both shards' winners within
    DEPTH_MIN_DELTA of each other, where the fold may part from the
    sequential z-buffer (none differed, or this raised)."""
    fv, (r0, rows), per = case.band(mesh)
    S, face = case.size, case.shape[2]
    with torch.no_grad():
        want = nr.compute_face_index_map(fv, S)[:, r0:r0 + rows]
        window = dict(row_start=r0, num_rows=rows)
        if face > 1:
            got = parallel.compute_face_index_map_face_sharded(fv, S, group=mesh.groups["face"],
                                                               **window)
        else:
            got = nr.compute_face_index_map(fv, S, **window)
        check_equal(f"{label} index band", got[:, :want.shape[1]], want)
        if not bool((got[:, want.shape[1]:] < 0).all()):
            raise AssertionError(f"{label}: rows past the image bottom not background")
        if face == 1:
            return 0
        shards = [nr.compute_face_index_map(fv[:, k * per:(k + 1) * per], S, return_depth=True,
                                            **window) for k in range(face)]
    ties = torch.zeros_like(got, dtype=torch.bool)
    for a in range(face):
        for b in range(a + 1, face):
            (ia, da), (ib, db) = shards[a], shards[b]
            ties |= (ia >= 0) & (ib >= 0) & ((da - db).abs() < DEPTH_MIN_DELTA)
    return int(ties.sum())


def index_map_graphed(cases, eager_maps):
    """Phase 15's graphed pass: ``compute_face_index_map`` at each (label,
    face vertices, size) of ``cases``, whole and over the window of
    ``eager_maps`` (the eager entry's (index, depth) of each), three calls
    each through the compiled core: the first eager, the second capturing
    a forward graph, the third replaying it; every call's ids and depth
    bit-equal to the eager ones, a replay launching nothing eagerly, the
    graph holding the route's id/depth form (K7 capped on the binned
    route).  Returns {label: the route and each window's graph}."""
    out = {}
    for (label, fv, S), maps in zip(cases, eager_maps):
        route = rc.resolve_route(fv.shape[0], S, S, fv.shape[1])
        form = "resolve_binned_depth" if route == "binned" else "resolve_depth"
        out[label] = dict(route=route, windows=[])
        for (row_start, num_rows), want in zip(((0, None), (S // 2, S // 4)), maps):
            kw = dict(row_start=row_start, num_rows=num_rows, return_depth=True)
            rc.reset_launches()
            for call in range(3):
                launched = dict(rc.LAUNCHES)
                index, depth = nr.compute_face_index_map(fv, S, **kw)
                check_equal(f"{label} graphed compute_face_index_map call {call + 1} index",
                            index, want[0])
                check_equal(f"{label} graphed compute_face_index_map call {call + 1} depth",
                            depth, want[1])
            if rc.LAUNCHES != launched:
                raise AssertionError(f"{label}: a replayed compute_face_index_map launched "
                                     f"eagerly: {rc.LAUNCHES} after {launched}")
            if rc.GRAPHS["captures"] != 1 or rc.GRAPHS["forward_replays"] != 2:
                raise AssertionError(f"{label} compute_face_index_map: {rc.GRAPHS}, want one "
                                     f"capture and two replays")
            graph = [g for (r, _), kept in graphs._entries.items() if r is graphs.INDEX_MAPS
                     for g in kept][-1]
            held = graph.launches["forward"]
            if held.get(form) != 1 or held.get("bin_faces", 0) != (route == "binned"):
                raise AssertionError(f"{label}: the index-map graph holds {held}, want {form}")
            out[label]["windows"].append(dict(window=[row_start, num_rows], held=held,
                                              capture_s=graph.seconds,
                                              capacities=graph.capacities))
        log(f"[index map] {label} graphed ({route}): three calls each whole and windowed, the "
            f"second capturing, ids and depth bit-equal to the eager entry's; graphs hold "
            f"{json.dumps([w['held'] for w in out[label]['windows']])}, capture s "
            f"{[round(w['capture_s'], 6) for w in out[label]['windows']]}"
            + (f", K7 capped at {[w['capacities'] for w in out[label]['windows']]}"
               if route == "binned" else ""))
    return out


def sharded_census(data, tile, face):
    """(forward, step) counts of ``parallel.COLLECTIVES`` for one sharded
    step on a (data, tile, face) mesh: the face fold's two all-gathers, the
    finished images' all-gather, then in the backward the NMR halo rows and
    the one gradient all-reduce."""
    forward = {"face_all_gather": 2 * (face > 1), "image_all_gather": int(data * tile > 1),
               "halo_exchange": 0, "grad_all_reduce": 0}
    return forward, dict(forward, halo_exchange=int(tile > 1), grad_all_reduce=1)


def sharded_turn(case, mesh, steps):
    """``steps`` timed steps of ``case`` over ``mesh`` (each after a barrier
    and a sync): (step ms, collective ms, {kind: [ms]})."""
    import torch.distributed as dist

    ms, coll_ms, kind_ms = [], [], collections.defaultdict(list)
    for _ in range(steps):
        dist.barrier()
        torch.cuda.synchronize()
        parallel.reset_collectives()
        t0 = time.perf_counter()
        case.step(mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(sum(parallel.COLLECTIVE_SECONDS.values()) * 1e3)
        for kind, seconds in parallel.COLLECTIVE_SECONDS.items():
            kind_ms[kind].append(seconds * 1e3)
    return ms, coll_ms, kind_ms


# the sharded turns, in order: the eager step (nr.eager()) and the graphed
# core's (the rank's chain of graphs replayed, the collectives between)
SHARDED_TURNS = ("eager", "graphed", "graphed", "eager")


def sharded_graphed(label, case, mesh, eager, face, rtol=GRAD_RTOL):
    """The graphed core's sharded step at ``case`` on this rank: the first
    call eager, the second capturing the rank's chain, the third and fourth
    replaying it; each held to the eager sharded step ``eager`` (images
    equal, gradients within ``rtol`` of their largest magnitude, the same
    census), the replayed steps launching no kernel eagerly, and at face >
    1 the chain holding K9 and the id/depth resolve.  Returns what the
    parent prints."""
    want_images, want_grads, _, census = eager
    rc.reset_launches()
    graphs.note_eager.cache_clear()
    out = []
    for call in range(4):
        torch.cuda.synchronize()
        parallel.reset_collectives()
        before = dict(rc.GRAPHS)
        counted = EagerOps()
        launched = dict(rc.LAUNCHES)
        # the last call's eager operations counted (a replay dispatches none)
        with counted if call == 3 else contextlib.nullcontext():
            images, grads, forward = case.step(mesh)
        torch.cuda.synchronize()
        launched = {k: n - launched[k] for k, n in rc.LAUNCHES.items() if n > launched[k]}
        replays = rc.GRAPHS["forward_replays"] - before["forward_replays"]
        check_equal(f"{label} graphed call {call + 1} images", images, want_images)
        errs = {k: check_close(f"{label} graphed call {call + 1} {k} grads", grads[k], g, rtol)
                for k, g in want_grads.items()}
        if (forward, dict(parallel.COLLECTIVES)) != census:
            raise AssertionError(f"{label}: graphed call {call + 1} census {forward} "
                                 f"{dict(parallel.COLLECTIVES)}, want {census}")
        if call == 0 and (replays or rc.GRAPHS["captures"]):
            raise AssertionError(f"{label}: the first call {rc.GRAPHS}, want it eager")
        if call >= 1 and replays != 1:
            raise AssertionError(f"{label}: graphed call {call + 1} replayed {replays} chains")
        if call >= 2 and launched:
            raise AssertionError(f"{label}: a replayed step launched {launched} eagerly")
        out.append(dict(grads=grads, errs=errs, eager_ops=dict(counted.ops),
                        eager_views=sum(counted.views.values())))
    (chain,) = graphs.kept_graphs(case.faces)
    held = collections.Counter(chain.launches["forward"])
    held.update(chain.launches.get("backward", {}))
    if face > 1:
        fv, (_, rows), per = case.band(mesh)
        depth_form = ("resolve_binned_depth" if rc.resolve_route(fv.shape[0], rows, case.size, per)
                      == "binned" else "resolve_depth")
        if not chain.launches["forward"].get("gather_rows") or \
                not chain.launches["forward"].get(depth_form):
            raise AssertionError(f"{label}: the replayed chain holds {chain.launches}, want K9 "
                                 f"and {depth_form}")
    eager_ops = out[-1]["eager_ops"]
    return dict(
        segments={k: [dict(n) for n in v] for k, v in chain.segment_launches.items()},
        inline=chain.inline,
        held=dict(held), capture_s=chain.seconds, capacities=chain.capacities,
        graphs=dict(rc.GRAPHS), errs=out[-1]["errs"], eager_ops=eager_ops,
        eager_device_ops=sum(eager_ops.values()), eager_views=out[-1]["eager_views"],
        digests={k: hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()
                 for k, g in out[-1]["grads"].items()})


def sharded_rank(names):
    """One rank's share of a spawn: each run in ``names`` on its mesh, once
    eagerly (``nr.eager()``) with its census and launch counts read around
    the step and held to the single-device step on the same card (which
    this rank also runs), then through the graphed core (the rank's chain
    of graphs, :func:`sharded_graphed`), then SHARDED_STEPS timed steps in
    each of SHARDED_TURNS.  Raises on any disagreement; returns {name: what
    the parent prints}."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {}
    for name in names:
        case = ShardedCase(name, dev)
        mesh = parallel.make_mesh(*case.shape)
        data, tile, face = case.shape
        label = f"{name} {case.shape} rank {rank}"
        with nr.eager():
            want_images, want_grads, _ = case.step()
        dist.barrier()
        torch.cuda.synchronize()
        parallel.reset_collectives()
        rc.reset_launches()
        with nr.eager():
            images, grads, forward = case.step(mesh)
        torch.cuda.synchronize()
        launches, step_census = dict(rc.LAUNCHES), dict(parallel.COLLECTIVES)
        check_equal(f"{label} images", images, want_images)
        errs = {}
        for k, g in want_grads.items():
            if not torch.isfinite(grads[k]).all() or float(grads[k].abs().max()) == 0.0:
                raise AssertionError(f"{label}: {k} gradients not finite or all zero")
            errs[k] = check_close(f"{label} {k} grads", grads[k], g)
        with nr.eager():
            near_ties = check_index_band(label, case, mesh)
        if (forward, step_census) != sharded_census(data, tile, face):
            raise AssertionError(f"{label}: census forward {forward} step {step_census}")
        fv, (_, rows), per = case.band(mesh)
        if face > 1:
            route = rc.resolve_route(fv.shape[0], rows, case.size, per)
            depth_form = "resolve_binned_depth" if route == "binned" else "resolve_depth"
            path = (depth_form, "gather_rows", "gather_faces3", "scatter_pixels_to_faces",
                    "scatter_faces_to_vertices")
            ok = launches["gather_rows"] == 1 and launches[depth_form] == 1 and not any(
                launches[k] for k in LATCH_FORMS)
        else:
            route = rc.resolve_route(fv.shape[0], rows, case.size, fv.shape[1])
            latch = "resolve_xy" if case.entry == "silhouettes" else "resolve_latch"
            path = (latch if route == "tiled" else "resolve_binned_" + latch[8:],
                    "gather_faces3", "scatter_pixels_to_faces", "scatter_faces_to_vertices")
            ok = launches["gather_rows"] == 0
        if route == "binned":
            path += ("bin_faces",)
        check_k1(label, launches)
        if not ok or not all(launches[k] > 0 for k in path):
            raise AssertionError(f"{label}: the step missed a kernel of its path: {launches}")
        graphed = sharded_graphed(label, case, mesh,
                                  (images, grads, forward, (forward, step_census)), face)

        def eager_turn():
            with nr.eager():
                return sharded_turn(case, mesh, SHARDED_STEPS)

        forms = {"eager": eager_turn, "graphed": lambda: sharded_turn(case, mesh, SHARDED_STEPS)}
        turns = {form: ([], [], collections.defaultdict(list)) for form in forms}
        for form in SHARDED_TURNS:
            ms, coll_ms, kind_ms = forms[form]()
            turns[form][0].extend(ms)
            turns[form][1].extend(coll_ms)
            for kind, v in kind_ms.items():
                turns[form][2][kind].extend(v)
        out[name] = dict(
            coords=mesh.coords, route=route, errs=errs, near_ties=near_ties,
            digests={k: hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()
                     for k, g in grads.items()},
            max_g={k: float(g.abs().max()) for k, g in want_grads.items()},
            census=step_census, launches={k: v for k, v in launches.items() if v},
            ms=turns["eager"][0], coll_ms=turns["eager"][1],
            kind_ms={k: float(np.median(v)) for k, v in turns["eager"][2].items() if any(v)},
            graphed_ms=turns["graphed"][0], graphed_coll_ms=turns["graphed"][1],
            graphed_kind_ms={k: float(np.median(v)) for k, v in turns["graphed"][2].items()
                             if any(v)},
            graphed=graphed)
    return out


def sharded_runs(dev, smi):
    """Every SHARDED run: the single-device step alone on the card (median
    of 5), then one spawn of ranks per world size, each rank held to the
    single-device step inside ``sharded_rank`` and here to each other: every
    rank's gradients the same bits, eager and graphed.  Returns ({name:
    [each rank's results]}, the ranks' launch counts of the eager step
    summed)."""
    single_ms = {}
    for name in SHARDED:
        case = ShardedCase(name, dev)
        single_ms[name] = median_ms(case.step, 5, warmup=1)
    spawns = collections.defaultdict(list)
    for name, shape in SHARDED.items():
        spawns[int(np.prod(shape))].append(name)
    runs, launches = {}, collections.Counter()
    for world, names in spawns.items():
        t0 = time.perf_counter()
        ranks = parallel.run_ranks(sharded_rank, world, (names,), device="cuda",
                                   backend="gloo", timeout=SHARDED_TIMEOUT)
        log(f"[sharded] {world} ranks on one card (gloo): {names} in "
            f"{time.perf_counter() - t0:.1f} s, rank start-up included")
        for name in names:
            runs[name] = [r[name] for r in ranks]
            for rank, r in enumerate(runs[name]):
                launches.update(r["launches"])
                if r["digests"] != runs[name][0]["digests"]:
                    raise AssertionError(f"{name}: rank {rank}'s gradients are not rank 0's bits")
                if r["graphed"]["digests"] != runs[name][0]["graphed"]["digests"]:
                    raise AssertionError(f"{name}: rank {rank}'s graphed gradients are not "
                                         f"rank 0's bits")
            log(f"[sharded] {name}: every rank's gradients the same bits "
                f"({len(ranks)} ranks, {len(runs[name][0]['digests'])} leaves)")
    for name, ranks in runs.items():
        for rank, r in enumerate(ranks):
            log(f"[sharded] {name} mesh {SHARDED[name]} rank {rank} {r['coords']}: images equal "
                f"to the single-device step's, index band equal (cross-shard near-tie pixels "
                f"{r['near_ties']}), route {r['route']}, grad max abs err {json.dumps(r['errs'])} "
                f"(max |g| {json.dumps(r['max_g'])}), census {json.dumps(r['census'])}, "
                f"launches {json.dumps(r['launches'])}")
            g = r["graphed"]
            log(f"[sharded] {name} rank {rank} graphed: images equal to the eager sharded "
                f"step's, grad max abs err {json.dumps(g['errs'])}, census unchanged, "
                f"{json.dumps(g['graphs'])}; the chain holds {json.dumps(g['held'])} in "
                f"segments {json.dumps(g['segments'])}, capture {g['capture_s']:.6f} s"
                + (f", K7 capped at {g['capacities']}" if g["capacities"] else "")
                + f"; a replayed step launches no kernel eagerly; it dispatches "
                f"{g['eager_device_ops']} operations that work on the card (the inputs' and "
                f"outputs' copies, the collectives' host staging, the image gather's pad and "
                f"cat, the gradient buffer's cat, the caller's loss and its backward): "
                f"{json.dumps(g['eager_ops'])}, and {g['eager_views']} views")
        log(f"[time] {name} sharded step {SHARDED[name]}, {len(ranks)} ranks sharing one card, "
            f"turns {'/'.join(SHARDED_TURNS)}: "
            + "; ".join(f"rank {i} eager {float(np.median(r['ms'])):.4f} ms (collectives "
                        f"{float(np.median(r['coll_ms'])):.4f} ms), graphed "
                        f"{float(np.median(r['graphed_ms'])):.4f} ms (collectives "
                        f"{float(np.median(r['graphed_coll_ms'])):.4f} ms)"
                        for i, r in enumerate(ranks))
            + f" (medians of {2 * SHARDED_STEPS} each); the single-device step alone "
            f"{single_ms[name]:.4f} ms  ({smi})")
        log(f"[time] {name} collectives by kind, ms (medians): "
            + "; ".join(f"rank {i} eager " + ", ".join(f"{k} {v:.4f}"
                                                      for k, v in r["kind_ms"].items())
                        + " graphed " + ", ".join(f"{k} {v:.4f}"
                                                  for k, v in r["graphed_kind_ms"].items())
                        for i, r in enumerate(ranks)))
    return runs, launches


def face_vertex_meshes():
    """label -> (faces i32 [nf, 3], nv) of the meshes K5 and K4 are timed at
    beside their yardsticks: ``bench``'s (``atlas``'s too: torus(40, 32)),
    ``scale``'s (icosphere(6)) and ``textured-scale``'s (torus(320, 248))."""
    return {label: (f, len(v)) for label, (v, f) in (
        ("bench", torus(40, 32)), ("scale", icosphere(6)), ("textured-scale", torus(320, 248)))}


def in_turns(kernel, library, reps=50):
    """CUDA-event medians taken kernel, library, library, kernel: (the
    kernel's two, the library's two)."""
    k1, l1 = median_ms(kernel, reps), median_ms(library, reps)
    l2, k2 = median_ms(library, reps), median_ms(kernel, reps)
    return [k1, k2], [l1, l2]


def profile_kept(fn, n=20, tries=5):
    """:func:`profile_device` of ``n`` calls of ``fn``, taken again while
    the profiler kept no device record at all (it has dropped a whole
    profile of a short kernel)."""
    for _ in range(tries):
        prof = profile_device(fn, n)
        if prof.ops:
            break
    return prof


def face_vertex_rows(faces, nv, bs, gen):
    """K5 and K4 at one mesh and batch size, each beside its yardstick
    (K5: ``table[:, faces_long]``; K4: ``index_add_`` into a buffer zeroed
    once): the event medians in turns, the device time (every record the
    wrapper's call leaves) and device operations per call under the
    profiler, the bound, and whether two calls give the same bits and the
    bits they must equal: K5's plain version's, and K4's plain version's on
    CPU copies (where its ``index_add_`` sums each vertex in slot order).
    A list of two dicts."""
    dev, nf = faces.device, faces.shape[0]
    faces_long = faces.long()
    table = torch.randn((bs, nv, 3), generator=gen, device=dev)
    g9 = torch.randn((bs, 3, 3, nf), generator=gen, device=dev)
    source = g9.permute(0, 3, 2, 1).reshape(bs, nf * 3, 3).contiguous()
    buffer = torch.zeros((bs, nv, 3), device=dev)
    cases = (
        ("gather_faces3", lambda: rc.gather_faces3(table, faces),
         lambda: table[:, faces_long], lambda got: torch.equal(
             got, rc.gather_faces3_plain(table, faces)),
         gather_faces3_work(bs, nv, nf)[0]),
        ("scatter_faces_to_vertices", lambda: rc.scatter_faces_to_vertices(g9, faces, nv),
         index_add_call(buffer, 1, faces_long.reshape(-1), source), lambda got: torch.equal(
             got.cpu(), rc.scatter_faces_to_vertices_plain(g9.cpu(), faces.cpu(), nv)),
         scatter_vertices_work(bs, nv, nf)[0]),
    )
    rows = []
    for name, kernel, library, exact, nbytes in cases:
        got = kernel()
        ms_turns, library_turns = in_turns(kernel, library)
        prof, lib_prof = profile_kept(kernel), profile_kept(library)
        rows.append(dict(
            kernel=name, bs=bs, nf=nf, nv=nv, ms=float(np.mean(ms_turns)), ms_turns=ms_turns,
            library_ms=float(np.mean(library_turns)), library_turns=library_turns,
            device_ms=prof.busy, device_ops=prof.ops, port_kernels=sorted(prof.per_launch),
            launched=prof.launched, library_device_ms=lib_prof.busy,
            bound_ms=bound(nbytes, 0)[0], bit_equal=bool(exact(got)),
            repeat_equal=bool(torch.equal(got, kernel()))))
    return rows


def per_call_us(fn, calls=1000, repeats=3):
    """Host µs per call of ``fn``: the median over ``repeats`` blocks of
    ``calls`` calls, each block ended by a synchronise."""
    blocks = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / calls * 1e6)
    return float(np.median(blocks))


def host_split(wrapper, tensors, alloc, entry, args, extra=None):
    """Host µs per call (:func:`per_call_us`) of one wrapper call and of each
    part of its launch path alone: the checks (``_use_kernel`` and one
    ``_check`` per input), the output's allocation, the C entry's lookup,
    packing the card and ``args`` into the argument block, the raw stream
    read and the ctypes call that launches the kernel; ``extra``: more
    parts by name."""
    index = tensors[0].get_device()
    fn, pack = cuda_build.ENTRIES[entry], cuda_build.PACKERS[entry].pack
    stream = torch._C._cuda_getCurrentRawStream(index)
    block = pack(index, *args)

    def checks():
        rc._use_kernel(*tensors)
        for t in tensors:
            rc._check(t, "t", t.dtype, t.shape)

    parts = dict(checks=checks, alloc=alloc, lookup=lambda: cuda_build.ENTRIES.get(entry),
                 pack=lambda: pack(index, *args),
                 stream_raw=lambda: torch._C._cuda_getCurrentRawStream(index),
                 ctypes_call=lambda: fn(block, stream), **(extra or {}), wrapper=wrapper)
    return {name: per_call_us(part) for name, part in parts.items()}


def gather_rows_host_split(dev, gen):
    """K9's wrapper at scale's shapes (D = 9 over a 512^2 index map) and
    the parts of its launch path (:func:`host_split`), with the
    alternatives each part was chosen from: the checks as the parent's
    (``_check`` and the id checks) and as the wrapper's one comparison per
    input; the allocation as ``torch.empty`` with the tensor's device, with
    a kept ``torch.device``, and as ``new_empty`` (the wrapper's); the
    ctypes call with ``argtypes`` (the wrapper's), without them (the block
    and a ``c_void_p`` stream as objects), through a ``CFUNCTYPE``
    prototype and through ``ctypes.PyDLL`` (the GIL kept), each launching
    K9 at a tiny shape, where the card keeps up with the host; beside them
    a ctypes call of libc's ``labs`` (the floor of a foreign call) and the
    yardstick ``torch.gather``'s host time at both shapes.  Last, the A/B
    of the launch ABI at the tiny shape, in turns (typed, packed, packed,
    typed, three times): K9 through a typed entry (``tools/launch_abi.cu``:
    one ctypes argument per kernel argument through ``argtypes``, the
    device checked in Python, as the port's entries were before they were
    packed) and through the packed entry, the block packed per call
    (``abi_typed_turns``, ``abi_packed_turns``)."""
    n, D, P = 81920, 9, 512 * 512
    table = torch.randn((1, n, D), generator=gen, device=dev)
    ids = torch.randint(-1, n, (1, P), generator=gen, device=dev, dtype=torch.int32)
    out = torch.empty((1, D, P), device=dev)
    args = (table.data_ptr(), ids.data_ptr(), out.data_ptr(), 1, n, D, P, P, 1)
    pack = cuda_build.PACKERS["gather_rows"].pack
    lib = cuda_build.load()
    bare = lib["nr_gather_rows"]           # a new handle: no argtypes, restype int
    proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)(
        ("nr_gather_rows", lib))
    pydll = ctypes.PyDLL(lib._name)["nr_gather_rows"]
    pydll.argtypes, pydll.restype = (ctypes.c_char_p, ctypes.c_void_p), ctypes.c_int
    labs = ctypes.CDLL(None).labs
    labs.argtypes, labs.restype = (ctypes.c_long,), ctypes.c_long
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    gather_index = ids.clamp(min=0).long()[..., None].expand(1, P, D)

    def parent_checks():
        rc._use_kernel(table, ids)
        rc._check(table, "table", torch.float32, (1, n, D))
        batch_stride = P                   # bs = 1
        if (ids.dtype != torch.int32 or tuple(ids.shape) != (1, P) or ids.stride(1) != 1
                or batch_stride not in (0, P)):
            raise AssertionError("ids")

    def folded_checks():
        rc._use_kernel(table, ids)
        if (table.dtype, table.stride()) != (torch.float32, (n * D, D, 1)) or \
                (ids.dtype, ids.shape, ids.stride()) != (torch.int32, (1, P), (P, 1)):
            raise AssertionError("layout")

    # at a tiny shape the card keeps up with the host, so these time the
    # host's launch and not the card's throughput
    t_table = torch.randn((1, 8, D), generator=gen, device=dev)
    t_ids = torch.randint(-1, 8, (1, 64), generator=gen, device=dev, dtype=torch.int32)
    t_out = torch.empty((1, D, 64), device=dev)
    t_block = pack(dev.index, t_table.data_ptr(), t_ids.data_ptr(), t_out.data_ptr(), 1, 8, D,
                   64, 64, 1)
    t_index = t_ids.long()[..., None].clamp(min=0).expand(1, 64, D)
    fn = cuda_build.ENTRIES["gather_rows"]
    extra = dict(
        tiny_ctypes_call=lambda: fn(t_block, stream),
        tiny_ctypes_no_argtypes=lambda: bare(t_block, ctypes.c_void_p(stream)),
        tiny_ctypes_cfunctype=lambda: proto(t_block, stream),
        tiny_ctypes_pydll=lambda: pydll(t_block, stream),
        tiny_wrapper=lambda: rc.gather_rows(t_table, t_ids, True),
        tiny_library=lambda: torch.gather(t_table, 1, t_index),
        parent_checks=parent_checks, folded_checks=folded_checks,
        alloc_empty_tensor_device=lambda: torch.empty((1, D, P), dtype=torch.float32,
                                                      device=table.device),
        alloc_empty_kept_device=lambda: torch.empty((1, D, P), dtype=torch.float32, device=dev),
        ffi_floor=lambda: labs(-5), library=lambda: torch.gather(table, 1, gather_index))
    split = host_split(lambda: rc.gather_rows(table, ids, True), (table, ids),
                       lambda: table.new_empty((1, D, P)), "gather_rows", args, extra)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    typed = tool_library("launch_abi").nr_typed_gather_rows
    typed.argtypes = (P_, P_, P_, I_, I_, I_, I_, ctypes.c_longlong, I_, P_)
    typed.restype = ctypes.c_int
    t_args = (t_table.data_ptr(), t_ids.data_ptr(), t_out.data_ptr(), 1, 8, D, 64, 64, 1)
    index = dev.index

    def typed_launch():
        if torch._C._cuda_getDevice() != index or typed(*t_args, stream):
            raise AssertionError("typed launch")

    def packed_launch():
        if fn(pack(index, *t_args), stream):
            raise AssertionError("packed launch")

    typed_launch(), packed_launch()
    torch.cuda.synchronize()
    want = rc.gather_rows_plain(t_table, t_ids, True)
    if not torch.equal(t_out, want):
        raise AssertionError("K9 through the typed and packed entries differs from plain")
    turns = {"typed": [], "packed": []}
    for _ in range(3):
        for name in ("typed", "packed", "packed", "typed"):
            turns[name].append(per_call_us(typed_launch if name == "typed" else packed_launch))
    split["abi_typed_turns"], split["abi_packed_turns"] = turns["typed"], turns["packed"]
    return split


def tool_library(name):
    """``tools/<name>.cu`` built into ``build/tools/`` (as the port's kernels
    are: their flags, a file name keyed by a hash of the source, the port's
    sources it may include and the flags, so an unchanged source is loaded
    as it is) and loaded through ctypes."""
    src = os.path.join(ROOT, "tools", name + ".cu")
    h = hashlib.sha256(" ".join(cuda_build.NVCC_FLAGS).encode())
    for path in (src, *sorted(str(p) for p in cuda_build.CSRC_DIR.glob("*.cu*"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    lib = os.path.join(ROOT, "build", "tools", f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        part = f"{lib}.{os.getpid()}"
        cuda_build._run_all([[cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                              str(cuda_build.CSRC_DIR), "-shared", "-o", part, src]])
        os.replace(part, lib)
    return ctypes.CDLL(lib)


def typed_entry(lib, name, argtypes):
    """``lib.nr_<name>`` with ``argtypes`` and the stream, as a function of
    the arguments that launches on the current stream and raises on its
    error code."""
    fn = getattr(lib, "nr_" + name)
    fn.argtypes, fn.restype = (*argtypes, ctypes.c_void_p), ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def parent_bin_design():
    """K7 as the port's parent had it (``tools/bin_faces_designs.cu``): a
    function (consts, S, row_start, rows) -> (cnt, offsets, ids) of K7's
    contract at :data:`resolve_cuda.BIN_TILE`, with its [bs, tiles, chunks]
    count array, scanned by torch, and its host sync."""
    lib = tool_library("bin_faces_designs")
    P, I = ctypes.c_void_p, ctypes.c_int
    count = typed_entry(lib, "parent_bin_count", (P, P, P, I, I, I, I, I, I, I, I))
    fill = typed_entry(lib, "parent_bin_fill", (P, P, P, I, I, I, I, I))

    def parent(consts, S, r0, rows):
        bs, _, nf = consts.shape
        th, tw = rc.BIN_TILE
        tiles_x = -(-S // tw)
        n_tiles = tiles_x * -(-rows // th)
        dev = consts.device
        rects = torch.empty((bs, nf, 4), dtype=torch.int32, device=dev)
        counts = torch.zeros((bs, n_tiles, max(1, -(-nf // 256))), dtype=torch.int32, device=dev)
        count(consts.data_ptr(), rects.data_ptr(), counts.data_ptr(), bs, nf, S, r0, rows, th, tw,
              256)
        ends = torch.cumsum(counts.reshape(-1), 0, dtype=torch.int32)
        cursors = (ends - counts.reshape(-1)).reshape(counts.shape)
        cnt, offsets = counts.sum(-1, dtype=torch.int32), cursors[..., 0].clone()
        ids = torch.empty(int(ends[-1]), dtype=torch.int32, device=dev)      # the host sync
        fill(rects.data_ptr(), cursors.data_ptr(), ids.data_ptr(), bs, nf, tiles_x, n_tiles, 256)
        return cnt, offsets, ids

    return parent


def crowded_fvp(dev):
    """The face vertices of ``textured-scale``'s mesh (torus(320, 248),
    158,720 faces) seen from above in a 3-pixel disc inside one 8x8 tile of a 512^2
    canvas: one bin holds every face K1 keeps (~74K; it kills those whose
    projected area is below its threshold at this size), with ids spanning
    more than K7's bitmap window of 131,072, so its order pass takes the
    block's bitmap in two windows."""
    v, f = torus(320, 248)
    v = v / np.abs(v).max()
    c, r = (2.0 * 59.5 + 1.0 - 512) / 512, 2.0 * 3.0 / 512
    ndc = np.stack([c + r * v[:, 0], c + r * v[:, 2], 2.0 + v[:, 1]], -1).astype(np.float32)
    return torch.tensor(np.ascontiguousarray(ndc[f][None].transpose(0, 3, 2, 1)), device=dev)


def turns_row(kernel, yardstick, nbytes):
    """A kernel and its yardstick (a library call or a parent design) in
    turns: the event medians (kernel, yardstick, yardstick, kernel), the
    device busy time and operations per call of each under the profiler
    (:func:`profile_kept`), the port kernels' own device time, and the
    bound of moving ``nbytes``."""
    ms_turns, yard_turns = in_turns(kernel, yardstick)
    prof, yard = profile_kept(kernel), profile_kept(yardstick)
    return dict(ms=float(np.mean(ms_turns)), ms_turns=ms_turns,
                yardstick_ms=float(np.mean(yard_turns)), yardstick_turns=yard_turns,
                device_ms=prof.busy, device_ops=prof.ops, yardstick_device_ms=yard.busy,
                yardstick_ops=yard.ops, kernel_device_ms=sum(prof.per_launch.values()),
                per_kernel={k.split("::")[-1][:40]: v for k, v in prof.per_launch.items()},
                bound_ms=bound(nbytes, 0)[0])


def redesigned_kernels(binned, gathers, smi):
    """K7 at the four binned configurations and on a crowded tile
    (``binned``: label -> (fvp, S)), in turns with its parent design
    (:func:`parent_bin_design`, over K1's constants made beforehand), both
    held to the plain version's bins and
    K7 to at most four device operations and one readback per call; and K9
    in turns with ``torch.gather`` (``gathers``: label -> its Call).
    Returns {"bin_faces": {label: row}, "gather_rows": {label: row}}."""
    parent = parent_bin_design()
    rows = {"bin_faces": {}, "gather_rows": {}}
    for label, (fvp, S) in binned.items():
        want = rc.bin_faces_plain(fvp, True, S)
        consts = rc.face_setup(fvp, True)

        def shipped(fvp=fvp, S=S):
            return rc.bin_faces(fvp, True, S)

        def design(consts=consts, S=S):
            return parent(consts, S, 0, S)

        check_parts(f"{label} bin_faces", shipped(), want, ("cnt", "offsets", "ids"))
        check_parts(f"{label} bin_faces parent design", design(), want, ("cnt", "offsets", "ids"))
        check_parts(f"{label} bin_faces second call", shipped(), want, ("cnt", "offsets", "ids"))
        nf, pairs = consts.shape[-1], len(want[2])
        row = turns_row(shipped, design, 24 * nf + 8 * want[0].numel() + 4 * pairs)
        # memset, three kernels and the readback; the profiler may drop a
        # record, never add one
        if row["device_ops"] > 5:
            raise AssertionError(f"{label} bin_faces: {row['device_ops']} device operations")
        largest = int(want[0].argmax())
        top = want[2][int(want[1].reshape(-1)[largest]):][:int(want[0].reshape(-1)[largest])]
        row.update(nf=nf, pairs=pairs, largest_bin=len(top),
                   largest_bin_id_span=int(top.max() - top.min()) + 1 if len(top) else 0)
        rows["bin_faces"][label] = row
        log(f"[redesign] {label} K7 bin_faces nf={nf} pairs={pairs} largest bin "
            f"{row['largest_bin']} (ids spanning {row['largest_bin_id_span']}): "
            f"{row['ms']:.4f} ms (turns {row['ms_turns'][0]:.4f}, {row['ms_turns'][1]:.4f}), "
            f"device {row['device_ms']:.5f} ms in {row['device_ops']:.2f} operations (its "
            f"kernels {row['kernel_device_ms']:.5f}); parent design {row['yardstick_ms']:.4f} "
            f"ms (turns {row['yardstick_turns'][0]:.4f}, {row['yardstick_turns'][1]:.4f}), "
            f"device {row['yardstick_device_ms']:.5f} ms in {row['yardstick_ops']:.2f}; bound "
            f"{row['bound_ms']:.6f} ms; both bit-equal to plain  ({smi})")
    # the crowded bin's ids span more than one bitmap window (32 * 4096 ids)
    if rows["bin_faces"]["crowded"]["largest_bin_id_span"] <= 32 * 4096:
        raise AssertionError(f"the crowded bin takes one bitmap window: {rows['bin_faces']}")
    for label, call in gathers.items():
        row = turns_row(call.kernel, call.library, call.bound[0] * HBM_BYTES_PER_S / 1e3)
        rows["gather_rows"][label] = row
        log(f"[redesign] {label} K9 gather_rows: {row['ms']:.4f} ms (turns "
            f"{row['ms_turns'][0]:.4f}, {row['ms_turns'][1]:.4f}), torch.gather "
            f"{row['yardstick_ms']:.4f} ms (turns {row['yardstick_turns'][0]:.4f}, "
            f"{row['yardstick_turns'][1]:.4f}); device {row['device_ms']:.5f} ms in "
            f"{row['device_ops']:.2f} operations (torch.gather {row['yardstick_device_ms']:.5f}), "
            f"bound {row['bound_ms']:.6f} ms  ({smi})")
    return rows


def resolve_outputs(form, bs, rows, S, A, dev):
    """The outputs of a resolve form ("xy", "latch" or "depth") of ``bs``
    images of ``rows`` x ``S`` pixels and ``A`` attribute planes."""
    out = [torch.empty((bs, rows, S), dtype=torch.int32, device=dev),
           torch.empty((bs, rows, S), device=dev)]
    if form == "xy":
        out.append(torch.empty((bs, 6, rows, S), device=dev))
    elif form == "latch":
        out += [torch.empty((bs, 9, rows, S), device=dev), torch.empty((bs, A, rows, S), device=dev)]
    return out


P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the tiled forms' designs timed against the shipped ones (each thread
# loading its own face a batch ahead): the face stream multicast across a
# cluster of CTAs, name -> (cluster, ring stages, runs of the nine through
# the ring) of tools/resolve_designs.cu
TILED_DESIGNS = {
    "cluster of 1": (1, 5, 9),
    "cluster of 2": (2, 5, 9),
    "cluster of 4": (4, 5, 9),
    "cluster of 8": (8, 5, 9),
    "cluster of 2, 2 runs multicast, 16 stages": (2, 16, 2),
}
# form -> the argument types of a tiled form's entry after its leading ones:
# the inputs and outputs' pointers, the sizes and window and draw_backside
TILED_ARGTYPES = {"xy": (P_,) * 4 + (I_,) * 6 + (F_, F_),
                  "latch": (P_,) * 6 + (I_,) * 7 + (F_, F_),
                  "depth": (P_,) * 3 + (I_,) * 6 + (F_, F_)}


def _tiled_call(entry, lead, form, fvp, attrs, S, row_start, rows, draw_backside):
    bs, nf, A = fvp.shape[0], fvp.shape[-1], attrs.shape[-1]
    rows = S if rows is None else rows
    out = resolve_outputs(form, bs, rows, S, A, fvp.device)
    inputs = (fvp, attrs) if form == "latch" else (fvp,)
    sizes = (bs, nf, A, S) if form == "latch" else (bs, nf, S)
    entry(*lead, *(t.data_ptr() for t in (*inputs, *out)), *sizes, row_start, rows,
          int(draw_backside), 0.1, 100.0)
    return tuple(out)


def parent_designs():
    """K3 and the resolve forms as the port's parent had them
    (``tools/resolve_scatter_parents.cu``): ``scatter(g, fim, nf)``, with
    the parent wrapper's ``torch.zeros`` of the output; ``tiled(form, fvp,
    attrs, S, row_start=0, rows=None, draw_backside=True)``, the parent's
    K2, K2L or K2D (form "resolve_xy", "resolve_latch" or
    "resolve_depth"), each CTA loading every face itself; and
    ``binned(form, consts, fvp, attrs, bins, S)``, the parent's K8 (form
    "xy", "latch" or "depth": a 64-thread CTA per bin) over K1's constants
    ``consts`` on the whole canvas."""
    lib = tool_library("resolve_scatter_parents")
    k3 = typed_entry(lib, "parent_scatter_pixels_to_faces", (P_, P_, P_, I_, I_, I_, I_))
    tiled_entries = {form: typed_entry(lib, f"parent_resolve_{form}", types)
                     for form, types in TILED_ARGTYPES.items()}
    binned_entries = {
        "xy": typed_entry(lib, "parent_resolve_binned_xy", (P_,) * 8 + (I_,) * 5 + (F_, F_)),
        "latch": typed_entry(lib, "parent_resolve_binned_latch",
                             (P_,) * 10 + (I_,) * 6 + (F_, F_)),
        "depth": typed_entry(lib, "parent_resolve_binned_depth",
                             (P_,) * 6 + (I_,) * 5 + (F_, F_))}

    def scatter(g, fim, nf):
        bs, D = g.shape[:2]
        out = torch.zeros((bs, D, nf), dtype=torch.float32, device=g.device)
        k3(g.data_ptr(), fim.data_ptr(), out.data_ptr(), bs, D, fim[0].numel(), nf)
        return out

    def tiled(form, fvp, attrs, S, row_start=0, rows=None, draw_backside=True):
        form = form.split("_")[-1]
        return _tiled_call(tiled_entries[form], (), form, fvp, attrs, S, row_start, rows,
                           draw_backside)

    def binned(form, consts, fvp, attrs, bins, S):
        bs, nf, A = fvp.shape[0], fvp.shape[-1], attrs.shape[-1]
        out = resolve_outputs(form, bs, S, S, A, fvp.device)
        inputs = {"xy": (consts, fvp), "latch": (consts, fvp, attrs), "depth": (consts,)}[form]
        sizes = (bs, nf, A, S) if form == "latch" else (bs, nf, S)
        binned_entries[form](*(t.data_ptr() for t in (*inputs, *bins, *out)), *sizes, 0, S,
                             0.1, 100.0)
        return tuple(out)

    return scatter, tiled, binned


def resolve_designs(dev):
    """Other designs of the resolve forms (``tools/resolve_designs.cu``):
    ``tiled(design, form, fvp, attrs, S)``, a tiled form whose face stream
    a cluster shares, :data:`TILED_DESIGNS`; ``binned(kind,
    form, fvp, attrs, bins, S)``, K8 as a warp per bin whose persistent
    warps take bins by a static stride (kind "static") or from an atomic
    counter ("atomic")."""
    lib = tool_library("resolve_designs")
    tiled_entries = {form: typed_entry(lib, f"design_resolve_{form}", (I_,) * 3 + types)
                     for form, types in TILED_ARGTYPES.items()}
    binned_entries = {
        "xy": typed_entry(lib, "design_binned_xy", (P_,) * 8 + (I_,) * 6 + (F_, F_)),
        "latch": typed_entry(lib, "design_binned_latch", (P_,) * 10 + (I_,) * 7 + (F_, F_)),
        "depth": typed_entry(lib, "design_binned_depth", (P_,) * 7 + (I_,) * 6 + (F_, F_))}
    work = torch.zeros((1,), dtype=torch.int32, device=dev)

    def tiled(design, form, fvp, attrs, S):
        form = form.split("_")[-1]
        return _tiled_call(tiled_entries[form], design, form, fvp, attrs, S, 0, S, True)

    def binned(kind, form, fvp, attrs, bins, S):
        bs, nf, A = fvp.shape[0], fvp.shape[-1], attrs.shape[-1]
        out = resolve_outputs(form, bs, S, S, A, fvp.device)
        inputs = (fvp, attrs) if form == "latch" else (fvp,)
        sizes = (bs, nf, A, S) if form == "latch" else (bs, nf, S)
        binned_entries[form](work.data_ptr() if kind == "atomic" else None,
                             *(t.data_ptr() for t in (*inputs, *bins, *out)),
                             *sizes, 0, S, 1, 0.1, 100.0)
        return tuple(out)

    return tiled, binned


def design_row(calls, bound_):
    """The designs of one function in turns: ``calls`` maps a design's name
    to a call, the shipped one first; event medians in the order given and
    back (a, b, c, c, b, a); under the profiler (:func:`profile_kept`),
    each design's device operations per call and its device ms per call,
    each record name's mean record times its records per call rounded (at
    least 1), so that a dropped record does not count as time saved; and
    the bound ``bound_`` = (ms, what bounds it)."""
    names = list(calls)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(median_ms(calls[name], 50))
    profs = {name: profile_kept(calls[name]) for name in names}
    return dict(ms={n: float(np.mean(t)) for n, t in turns.items()}, ms_turns=turns,
                device_ms={n: call_device_ms(p) for n, p in profs.items()},
                device_ops={n: p.ops for n, p in profs.items()},
                bound_ms=bound_[0], bound_by=bound_[1])


def log_design_row(label, name, row, checked, smi):
    def device(ms):
        return "not measured" if ms is None else f"{ms:.5f} ms"

    log(f"[redesign] {label} {name}: " + "; ".join(
        f"{n} {row['ms'][n]:.4f} ms (turns {', '.join(f'{t:.4f}' for t in row['ms_turns'][n])}), "
        f"device {device(row['device_ms'][n])} in {row['device_ops'][n]:.2f} operations"
        for n in row["ms"]) + f"; bound {row['bound_ms']:.6f} ms by {row['bound_by']}; "
        f"{checked}  ({smi})")


def tile_order(t, tile_w=32, tile_h=8):
    """``t`` [..., H, W] as [..., 1, H * W] with its pixels re-laid so that
    each run of 256 is a ``tile_w`` x ``tile_h`` tile, row by row: K3 over
    it groups pixels as a 32 x 8 block would (warp w on the tile's row w),
    each warp reading the same 128 bytes, from one 1 KiB run, not 8 rows."""
    *lead, H, W = t.shape
    if H % tile_h or W % tile_w:
        raise ValueError(f"{H} x {W} is not a whole number of {tile_w} x {tile_h} tiles")
    t = t.reshape(*lead, H // tile_h, tile_h, W // tile_w, tile_w).transpose(-3, -2)
    return t.contiguous().reshape(*lead, 1, H * W)


def scatter_designs(cases, parent, gen, smi):
    """K3 in turns with a 32 x 8-pixel block (maps with rows: K3 over
    :func:`tile_order`'s re-laid map and planes, made before the timing),
    its parent design and ``index_add_`` (over the covered pixels), on
    random gradients over ``cases``: label -> (index map i32
    [1, H, W], nf, D).  Each design within GRAD_RTOL of the plain
    version; the shipped one at most two device operations a call (the
    zero fill and the kernel; the profiler may drop a record, never add
    one).  Returns {label: row}."""
    rows = {}
    for label, (index, nf, D) in cases.items():
        g = torch.randn((1, D, *index.shape[1:]), generator=gen, device=index.device)
        calls = {"shipped": lambda g=g, index=index, nf=nf: rc.scatter_pixels_to_faces(
            g, index, nf)}
        if index.shape[1] > 1:
            calls["32 x 8 tile"] = lambda g=tile_order(g), index=tile_order(index), nf=nf: \
                rc.scatter_pixels_to_faces(g, index, nf)
        calls["parent"] = lambda g=g, index=index, nf=nf: parent(g, index, nf)
        want = rc.scatter_pixels_to_faces_plain(g, index, nf)
        errs = {name: check_close(f"{label} K3 {name} D={D}", call(), want)
                for name, call in calls.items()}
        calls["index_add_"] = covered_index_add(
            torch.zeros((D, nf), device=index.device), 1, index.reshape(-1), g.reshape(D, -1))
        P, covered = index.numel(), int((index >= 0).sum())
        row = design_row(calls, bound(*scatter_pixels_work(index, D, nf)))
        if row["device_ops"]["shipped"] > 2:
            raise AssertionError(f"{label} K3: {row['device_ops']['shipped']} device operations")
        row.update(D=D, nf=nf, P=P, covered=covered, max_abs_err=errs)
        rows[label] = row
        log_design_row(label, f"K3 D={D} (P={P}, covered {covered}, nf={nf})", row,
                       f"max abs err vs plain {json.dumps(errs)}", smi)
    return rows


def atlas_grad_designs(g12, anchors, tw, T, smi):
    """K6 in turns with its designs (``tools/atlas_taps_designs.cu``: float
    atomics only; warp aggregation of equal anchors before the atomics,
    with and without float2 pairs), the parent's K6 with what followed it
    (the [1, T, 12] table, the three folds and autograd's copy into the
    atlas's layout) and the library call (``roofline.atlas_taps_library``),
    on ``g12`` [1, 12, P] over ``anchors`` [1, P]; each within GRAD_RTOL of
    the plain version, the shipped one at most two device operations a call
    (the zero fill and the kernel).  Returns the row."""
    lib = tool_library("atlas_taps_designs")
    design = typed_entry(lib, "design_atlas_taps_grad", (I_, I_, P_, P_, P_, I_, I_, I_, I_))
    parent_k6 = typed_entry(lib, "parent_scatter_rows", (P_, P_, P_, I_, I_, I_, I_))
    P = anchors.shape[1]

    def designed(pair, match):
        out = torch.zeros((1, 3, T), device=g12.device)
        design(pair, match, g12.data_ptr(), anchors.data_ptr(), out.data_ptr(), 1, P, tw, T)
        return out

    def parent():
        quad = torch.zeros((1, T, 12), device=g12.device)
        parent_k6(g12.data_ptr(), anchors.data_ptr(), quad.data_ptr(), 1, 12, P, T)
        return rc.fold_taps(quad, tw)

    calls = {"shipped": lambda: rc.atlas_taps_grad(g12, anchors, tw, T),
             "scalar": lambda: designed(0, 0),
             "match": lambda: designed(0, 1),
             "match + pair": lambda: designed(1, 1),
             "parent + folds": parent}
    want = rc.atlas_taps_grad_plain(g12, anchors, tw, T)
    errs = {name: check_close(f"atlas K6 {name}", call(), want) for name, call in calls.items()}
    calls["zeros + index_add_"] = atlas_taps_library(g12, anchors, tw, T)
    row = design_row(calls, bound(*atlas_taps_work(anchors, T)))
    if row["device_ops"]["shipped"] > 2:
        raise AssertionError(f"atlas K6: {row['device_ops']['shipped']} device operations")
    covered = int((anchors >= 0).sum())
    even = int(((anchors >= 0) & (anchors % 2 == 0)).sum())
    row.update(P=P, T=T, tw=tw, covered=covered, even_anchors=even, max_abs_err=errs)
    log_design_row("atlas", f"K6 (P={P}, covered {covered}, {even} at even texels, T={T})",
                   row, f"max abs err vs plain {json.dumps(errs)}", smi)
    return row


def tiled_designs(cases, parent, designs, smi):
    """The tiled forms (every CTA loading every face itself, the next batch
    into registers) in turns with the parent's forms (the same feed, in the
    parent's template) and with :data:`TILED_DESIGNS` (the face stream
    multicast across a cluster, :func:`resolve_designs`), on ``cases``:
    label -> (form, fvp, face attributes, S); all bit-equal.  Returns
    {label: row}."""
    rows = {}
    for label, (form, fvp, attrs, S) in cases.items():
        consts = rc.face_setup(fvp, True)
        shipped = {"resolve_xy": lambda: rc.resolve_xy(fvp, True, S, 0.1, 100.0),
                   "resolve_latch": lambda: rc.resolve_latch(fvp, attrs, True, S, 0.1, 100.0),
                   "resolve_depth": lambda: rc.resolve_depth(fvp, True, S, 0.1, 100.0)}[form]
        calls = {"shipped": shipped,
                 "parent form": lambda form=form, fvp=fvp, attrs=attrs, S=S: parent(
                     form, fvp, attrs, S)}
        for name, d in TILED_DESIGNS.items():
            calls[name] = lambda d=d, form=form, fvp=fvp, attrs=attrs, S=S: designs(
                d, form, fvp, attrs, S)
        want = shipped()
        for name, call in calls.items():
            check_parts(f"{label} {form} vs {name}", call(), want)
        A = attrs.shape[-1]
        planes, face_bytes = {"resolve_xy": (8, 36), "resolve_latch": (11 + A, 36 + 4 * A),
                              "resolve_depth": (2, 36)}[form]
        row = design_row(calls, resolve_bound(consts, S, planes, face_bytes))
        tiles = (-(-S // 16)) ** 2
        # the face stream from L2: 36 bytes a face for every CTA, or for
        # every cluster of the multicast designs
        stream_mb = {"shipped": 36e-6 * tiles * fvp.shape[-1]}
        stream_mb.update({name: stream_mb["shipped"] / d[0] for name, d in TILED_DESIGNS.items()})
        row.update(form=form, nf=fvp.shape[-1], A=A, S=S, stream_mb=stream_mb)
        rows[label] = row
        log_design_row(label, f"{form} nf={fvp.shape[-1]} A={A} {S}^2", row,
                       "all bit-equal", smi)
    return rows


def binned_designs(cases, parent, designs, smi):
    """Each K8 form (a 64-thread CTA per bin, from the face vertices) in
    turns with the parent's K8 alone (a 64-thread CTA per bin over K1's
    constants, made beforehand), with the warp-per-bin design, its bins by
    a static stride or an atomic counter (:func:`resolve_designs`), and the
    chains: K7 + K8 beside the parent's
    K1 + K7 + K8 (its K7 the shipped one: the parent's read K1's bbox, the
    shipped one forms it), on ``cases``: label -> (form, fvp, face
    attributes, S); all bit-equal.  Returns {label: row}."""
    rows = {}
    for label, (form, fvp, attrs, S) in cases.items():
        consts = rc.face_setup(fvp, True)
        bins = rc.bin_faces(fvp, True, S)
        shipped = {"xy": lambda b: rc.resolve_binned_xy(fvp, True, b, S, 0.1, 100.0),
                   "latch": lambda b: rc.resolve_binned_latch(fvp, attrs, True, b, S, 0.1, 100.0),
                   "depth": lambda b: rc.resolve_binned_depth(fvp, True, b, S, 0.1, 100.0)}[form]
        calls = {
            "shipped K8": lambda shipped=shipped, bins=bins: shipped(bins),
            "parent K8": lambda form=form, consts=consts, fvp=fvp, attrs=attrs, bins=bins, S=S:
                parent(form, consts, fvp, attrs, bins, S),
            "warp per bin": lambda form=form, fvp=fvp, attrs=attrs, bins=bins, S=S:
                designs("static", form, fvp, attrs, bins, S),
            "warp per bin, atomic counter": lambda form=form, fvp=fvp, attrs=attrs, bins=bins,
                S=S: designs("atomic", form, fvp, attrs, bins, S),
            "K7 + K8": lambda shipped=shipped, fvp=fvp, S=S: shipped(rc.bin_faces(fvp, True, S)),
            "parent K1 + K7 + K8": lambda form=form, fvp=fvp, attrs=attrs, S=S: parent(
                form, rc.face_setup(fvp, True), fvp, attrs, rc.bin_faces(fvp, True, S), S),
        }
        want = calls["shipped K8"]()
        for name, call in calls.items():
            check_parts(f"{label} K8 {form} vs {name}", call(), want)
        A = attrs.shape[-1]
        planes, face_bytes = {"xy": (8, 36), "latch": (11 + A, 36 + 4 * A), "depth": (2, 36)}[form]
        pairs = int(bins[0].sum())
        row = design_row(calls, resolve_bound(consts, S, planes, face_bytes,
                                              8 * bins[0].numel() + 4 * pairs))
        row.update(form=form, nf=fvp.shape[-1], A=A, S=S, pairs=pairs,
                   largest_bin=int(bins[0].max()))
        rows[label] = row
        log_design_row(label, f"K8 {form} nf={fvp.shape[-1]} A={A} {S}^2 pairs={pairs} largest "
                       f"bin {row['largest_bin']}", row, "all bit-equal", smi)
    return rows


def face_vertex_kernels(dev, gen, smi):
    """K5 and K4 at :func:`face_vertex_meshes`, batch 1 and 8
    (:func:`face_vertex_rows`): K5 bit-equal to its plain version, K4 to
    the plain version on CPU copies (at batch 2 too), each the same bits on
    a second call and its own kernel the wrapper's one device operation;
    each printed beside its yardstick, device time and bound.  Then the
    host-time split of one K4 and one K5 call at ``bench``, batch 1
    (:func:`host_split`)."""
    profiled = collections.Counter()
    for label, (f, nv) in face_vertex_meshes().items():
        faces = torch.tensor(f, device=dev)
        g2 = torch.randn((2, 3, 3, len(f)), generator=gen, device=dev)
        check_equal(f"{label} scatter_faces_to_vertices bs=2 vs plain on CPU copies",
                    rc.scatter_faces_to_vertices(g2, faces, nv).cpu(),
                    rc.scatter_faces_to_vertices_plain(g2.cpu(), faces.cpu(), nv))
        for bs in (1, 8):
            for row in face_vertex_rows(faces, nv, bs, gen):
                name = row["kernel"]
                # the profiler may drop records, never add one; a profile
                # that kept none (after profile_kept's tries) shows nothing
                seen = row["device_ops"] > 0
                alone = row["device_ops"] <= 1 and row["launched"] == {name: 1.0} and \
                    len(row["port_kernels"]) == seen
                if not (row["bit_equal"] and row["repeat_equal"] and alone):
                    raise AssertionError(f"{label} bs={bs} {name}: {row}")
                profiled[name] += seen
                log(f"[face-vertex] {label} bs={bs} {name} (nf={row['nf']}, nv={nv}): kernel "
                    f"{row['ms']:.4f} ms (turns {row['ms_turns'][0]:.4f}, "
                    f"{row['ms_turns'][1]:.4f}), library {row['library_ms']:.4f} ms (turns "
                    f"{row['library_turns'][0]:.4f}, {row['library_turns'][1]:.4f}); device "
                    f"{row['device_ms']:.5f} ms in {row['device_ops']:.2f} operations (library "
                    f"{row['library_device_ms']:.5f} ms), bound {row['bound_ms']:.5f} ms "
                    f"({row['device_ms'] / row['bound_ms']:.2f}x); bit-equal"
                    f"{' on CPU copies' if name != 'gather_faces3' else ''}, repeats its bits"
                    f"  ({smi})")
    if not all(profiled[name] for name in ("gather_faces3", "scatter_faces_to_vertices")):
        raise AssertionError(f"the profiler kept no record of K4 or K5 at any shape: {profiled}")
    f, nv = face_vertex_meshes()["bench"]
    faces, nf = torch.tensor(f, device=dev), len(f)
    g9 = torch.randn((1, 3, 3, nf), generator=gen, device=dev)
    table = torch.randn((1, nv, 3), generator=gen, device=dev)
    offsets, slots = rc.vertex_slots(faces, nv)
    vertex_grad, fvp = torch.empty((1, nv, 3), device=dev), torch.empty((1, 3, 3, nf), device=dev)
    split = {
        "gather_rows": gather_rows_host_split(dev, gen),
        "scatter_faces_to_vertices": host_split(
            lambda: rc.scatter_faces_to_vertices(g9, faces, nv), (g9, faces),
            lambda: torch.empty((1, nv, 3), device=dev), "scatter_faces_to_vertices",
            (g9.data_ptr(), offsets.data_ptr(), slots.data_ptr(), vertex_grad.data_ptr(), 1, nf,
             nv), extra={"slot_table_lookup": lambda: rc.vertex_slots(faces, nv)}),
        "gather_faces3": host_split(
            lambda: rc.gather_faces3(table, faces), (table, faces),
            lambda: torch.empty((1, 3, 3, nf), device=dev), "gather_faces3",
            (table.data_ptr(), faces.data_ptr(), fvp.data_ptr(), 1, nv, 3, nf)),
    }
    log(f"[host split] one wrapper call (K4 and K5 at bench, batch 1; K9 at scale, D = 9), "
        f"host us per call (median of 3 blocks of 1000 calls): {json.dumps(split)}; the event "
        f"median of a call that does nothing {median_ms(lambda: None, 50):.4f} ms  ({smi})")
    return split


# the examples phase: fits of EXAMPLE_STEPS steps at 256^2 with
# anti-aliasing (the examples' defaults) on write_example_data's torus OBJ,
# example 5 at 64^2 on two ranks sharing the card, and the convergence fit
EXAMPLE_SIZE = 256
EXAMPLE_STEPS = 30
EXAMPLE5_SIZE = 64
EXAMPLE5_STEPS = 10
CONVERGENCE_STEPS = 350      # the JAX package's test: below 0.01 within 350 steps
CONVERGENCE_LOSS = 0.01


def example_fit_checks(label, fit, forward, fim, smi):
    """A fit's first step (``forward(fit, param)`` -> (images, loss) from
    ``fit.param``, then backward) with the kernels and with their plain
    versions (``steps_vs_plain``), then its median step ms (CUDA events,
    after warm-up) and its device operations per step (profiler).  Returns
    the printed numbers."""
    def step():
        p = fit.param.clone().requires_grad_(True)
        images, loss = forward(fit, p)
        loss.backward()
        return images.detach(), {"param": p.grad}

    steps_vs_plain(label, step, fim)
    ms = median_ms(step, 20, warmup=3)
    prof = profile_device(step)
    rel = "=" if prof.complete else ">="
    out = dict(step_ms=ms, busy_ms=prof.busy, busy_share=prof.busy / ms, ops=prof.ops,
               complete=prof.complete)
    log(f"[examples] {label} step: {ms:.4f} ms (median of 20, CUDA events), device busy "
        f"{rel} {prof.busy:.4f} ms ({rel} {100 * prof.busy / ms:.1f}%) in {rel} "
        f"{prof.ops:.1f} device operations per step  ({smi})")
    return out


def check_fit_launches(label, launches, kernels, slot_tables):
    """The kernels of a fit's path launched, no K1, and at most one vertex ->
    slot table built over the whole fit (K4's, kept across its steps)."""
    if slot_tables > 1:
        raise AssertionError(f"{label}: {slot_tables} vertex -> slot table builds in one fit")
    if not all(launches[name] > 0 for name in kernels):
        raise AssertionError(f"{label} missed a kernel of its path {kernels}: {launches}")
    check_k1(label, launches)


def check_falls(label, losses):
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")


def check_camera_nears(cameras):
    """Example 4's camera, after each step, nearer at the end to the view
    its target was rendered from than where it started."""
    from neural_renderer_v2_pytorch_tpu_torch.examples import example4
    from neural_renderer_v2_pytorch_tpu_torch.utils import scenes

    target = np.asarray(nr.get_points_from_angles(*scenes.EXAMPLE4_VIEW), np.float64)
    start, end = (float(np.linalg.norm(np.asarray(c) - target))
                  for c in (example4.START, cameras[-1]))
    if not end < start:
        raise AssertionError(f"example4: the camera {cameras[-1]} is no nearer to "
                             f"{target.tolist()} than its start ({end} >= {start})")
    log(f"[examples] example4: the camera's distance to the target view "
        f"{scenes.EXAMPLE4_VIEW} went {start:.4f} -> {end:.4f} in {len(cameras)} steps "
        f"(at {[round(x, 4) for x in cameras[-1]]})")


def parser_times(directory):
    """Host seconds of ``load_obj``'s two geometry parsers (the C++ one of
    ``native_loader`` and the Python one), median of 3, on the examples'
    torus OBJ and on a 256,000-face one; the two must agree.  Returns
    {faces: (native s, python s)}."""
    from neural_renderer_v2_pytorch_tpu_torch.utils import native_loader, obj_io, scenes

    times = {}
    for n_major, n_minor in ((40, 32), (400, 320)):
        path = os.path.join(directory, f"torus_{n_major}_{n_minor}.obj")
        scenes.write_torus_obj(path, n_major, n_minor)
        row, parsed = [], []
        for parse in (native_loader.parse_obj_native, obj_io._parse_geometry_python):
            seconds = []
            for _ in range(3):
                t0 = time.perf_counter()
                geometry = parse(path)
                seconds.append(time.perf_counter() - t0)
            if geometry is None:
                raise AssertionError("the C++ OBJ parser did not build or load")
            row.append(float(np.median(seconds)))
            parsed.append(geometry[:2])
        if not all(np.array_equal(a, b) for a, b in zip(*parsed)):
            raise AssertionError(f"{path}: the C++ and Python parsers disagree")
        times[2 * n_major * n_minor] = tuple(row)
    log("[examples] OBJ geometry parse, host s (median of 3) {faces: [C++, Python]}: "
        + json.dumps(times))
    return times


def examples_phase(dev, smi):
    """The user-facing path at full width: write_example_data at 256^2, the
    torus OBJ through load_obj (int32 faces on the card), examples 1-4
    through their run() (EXAMPLE_STEPS steps each), example 5 on two ranks
    sharing the card, and the convergence fit at 256^2 without
    anti-aliasing.  Each fit's first step is held to the plain versions and
    timed; each run's launches are read around it.  Returns ({label:
    launches}, {label: step numbers})."""
    import tempfile

    from neural_renderer_v2_pytorch_tpu_torch.examples import (
        example1,
        example2,
        example3,
        example4,
        example5_sharded,
    )
    from neural_renderer_v2_pytorch_tpu_torch.utils import scenes

    launches, numbers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = scenes.write_example_data(os.path.join(tmp, "data"), EXAMPLE_SIZE, device=dev)
        vertices, faces = nr.load_obj(data["torus.obj"], device=dev)
        want = scenes.fan_triangles(scenes.torus_quads(40, 32))
        if faces.dtype != torch.int32 or faces.device.type != dev.type or \
                not np.array_equal(faces.cpu().numpy(), want) or \
                sorted(map(tuple, want)) != sorted(map(tuple, torus(40, 32)[1])):
            raise AssertionError(f"load_obj: faces {faces.dtype} on {faces.device}, not the "
                                 f"torus's int32 faces on the card")
        log(f"[examples] write_example_data at {EXAMPLE_SIZE}^2 and load_obj: {len(vertices)} "
            f"vertices, {len(faces)} int32 faces on {faces.device}, the fan triangulation of "
            f"the torus's quads; {time.perf_counter() - t0:.1f} s")
        parser_times(tmp)
        out = os.path.join(tmp, "out")
        common = ["-s", str(EXAMPLE_SIZE), "--device", dev.type]
        size = 2 * EXAMPLE_SIZE           # anti-aliasing on

        # example 1: three batches of 30 views, forward only; its first
        # batch held to the plain versions through the same renderer
        argv1 = ["-i", data["torus.obj"], "-o", f"{out}/ex1.gif"] + common
        args1 = example1.parse_arguments(argv1)
        sweep = example1.setup(args1)
        first = sweep.azimuths[:args1.batch]

        def sweep_step():
            with torch.no_grad():
                return example1.render_batch(sweep, first), {}

        t0 = time.perf_counter()
        steps_vs_plain("example1", sweep_step, lambda: index_map(
            sweep.renderer, sweep.vertices[None].expand(len(first), -1, -1), sweep.faces,
            False))
        log(f"[examples] example1: its first batch of {len(first)} views held to the plain "
            f"versions in {time.perf_counter() - t0:.1f} s")
        rc.reset_launches()
        views = example1.run(argv1)
        torch.cuda.synchronize()
        launches["example1"] = dict(rc.LAUNCHES)
        route = rc.resolve_route(30, size, size, len(faces))
        ex1_kernels = ("gather_faces3", "resolve_xy") if route == "tiled" else \
            ("gather_faces3", "bin_faces", "resolve_binned_xy")
        check_fit_launches("example1", launches["example1"], ex1_kernels, rc.SLOT_TABLE_BUILDS)
        if views != 90 or not os.path.getsize(f"{out}/ex1.gif"):
            raise AssertionError(f"example1: {views} views, or no GIF")
        log(f"[examples] example1: {views} views in batches of 30 ({route} route), GIF "
            f"written; launches {json.dumps(launches['example1'])}")

        fits = (
            ("example2", example2, ["-io", data["torus.obj"], "-ir", data["example2_ref.png"],
                                    "-oo", f"{out}/ex2_opt.gif", "-or", f"{out}/ex2_res.gif",
                                    "-n", str(EXAMPLE_STEPS)], SILHOUETTE_KERNELS),
            ("example3", example3, ["-io", data["torus.obj"], "-ir", data["example3_ref.png"],
                                    "-or", f"{out}/ex3_res.gif", "-n", str(EXAMPLE_STEPS)],
             ("gather_faces3", "resolve_latch", "scatter_pixels_to_faces")),
            ("example4", example4, ["-io", data["torus.obj"], "-ir", data["example4_ref.png"],
                                    "-or", f"{out}/ex4_res.gif", "-n", str(EXAMPLE_STEPS)],
             SILHOUETTE_KERNELS),
        )
        for label, module, argv, kernels in fits:
            argv = argv + common
            fit = module.setup(module.parse_arguments(argv))
            batch = fit.vertices if fit.vertices.ndim == 3 else fit.vertices[None]
            numbers[label] = example_fit_checks(
                label, fit, module.forward,
                lambda fit=fit, batch=batch, label=label: index_map(
                    fit.renderer, batch, fit.faces, label == "example3"), smi)
            torch.cuda.synchronize()
            rc.reset_launches()
            t0 = time.perf_counter()
            cameras = []
            losses = module.run(argv, cameras) if module is example4 else module.run(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[label] = dict(rc.LAUNCHES)
            check_fit_launches(label, launches[label], kernels, rc.SLOT_TABLE_BUILDS)
            check_falls(label, losses)
            if module is example4:
                check_camera_nears(cameras)
            gifs = [a for a in argv if a.endswith(".gif")]
            if not all(os.path.getsize(g) for g in gifs):
                raise AssertionError(f"{label}: a GIF was not written: {gifs}")
            log(f"[examples] {label}: {len(losses)} losses {losses[0]:.3f} -> {losses[-1]:.3f} "
                f"(run() with its frames and GIFs {seconds:.1f} s), slot tables built "
                f"{rc.SLOT_TABLE_BUILDS}; launches {json.dumps(launches[label])}")

        # example 5: the sharded fit on two ranks sharing the card (gloo)
        args5 = example5_sharded.parse_args(
            ["-i", data["torus.obj"], "-o", f"{out}/ex5.gif", "-s", str(EXAMPLE5_SIZE),
             "-n", str(EXAMPLE5_STEPS), "--ranks", "2", "--device", dev.type])
        t0 = time.perf_counter()
        ranks = example5_sharded.fit(args5, vs_plain=True)
        example5_sharded.write_turntable(args5, ranks[0]["vertices"])
        seconds = time.perf_counter() - t0
        summed = collections.Counter()
        for r in ranks:
            summed.update(r["launches"])
        launches["example5"] = dict(summed)
        check_falls("example5", ranks[0]["losses"])
        mesh5 = ranks[0]["mesh"]
        # each rank renders 2 views (the batch is 2 per data rank), a band of
        # the rows without anti-aliasing
        route5 = rc.resolve_route(2, -(-EXAMPLE5_SIZE // mesh5[1]), EXAMPLE5_SIZE, len(faces))
        ex5_kernels = ("gather_faces3", "scatter_pixels_to_faces", "scatter_faces_to_vertices",
                       "resolve_xy" if route5 == "tiled" else "resolve_binned_xy")
        errs5 = []
        for rank, r in enumerate(ranks):
            check_fit_launches(f"example5 rank {rank}", collections.Counter(r["launches"]),
                               ex5_kernels, r["slot_tables"])
            (ik, gk), (ip, gp) = r["first_step"]["kernels"], r["first_step"]["plain"]
            check_equal(f"example5 rank {rank} images", ik, ip)
            if not torch.isfinite(gk).all() or float(gk.abs().max()) == 0.0:
                raise AssertionError(f"example5 rank {rank}: gradients not finite or all zero")
            errs5.append(check_close(f"example5 rank {rank} vertex grads", gk, gp))
        log(f"[examples] example5 first step, kernels vs plain on each rank: images equal, "
            f"vertex grad max abs err {errs5} (max |g| {float(gp.abs().max())})")
        if not os.path.getsize(args5.output_file):
            raise AssertionError("example5: no GIF")
        log(f"[examples] example5: mesh {mesh5} on 2 ranks sharing the card (gloo), "
            f"{EXAMPLE5_SIZE}^2, losses {ranks[0]['losses'][0]:.6f} -> "
            f"{ranks[0]['losses'][-1]:.6f}, every rank's vertices rank 0's bits, GIF written, "
            f"{seconds:.1f} s with rank start-up; launches (ranks summed) "
            f"{json.dumps(launches['example5'])}")

    # the convergence fit (JAX tests/test_rasterize.py:165-204): the 0.1
    # square of two faces at z = 1 to a larger, moved square's silhouette,
    # IoU loss, the port's Adam(lr=0.005), 256^2 without anti-aliasing
    hp = nr.RasterizeHyperparam(image_size=EXAMPLE_SIZE, anti_aliasing=False)
    tv, tf = scenes.square(**scenes.CONVERGENCE_TARGET)
    sq_faces = torch.tensor(tf, device=dev)
    with torch.no_grad():
        ref = nr.rasterize_silhouettes(torch.tensor(tv, device=dev)[None], sq_faces, None, hp)[0]
    v0 = torch.tensor(scenes.square(0.1)[0], device=dev)

    def forward(fit, v):
        image = nr.rasterize_silhouettes(v[None], sq_faces, None, hp)
        return image, 1.0 - torch.sum(image[0] * ref) / torch.sum(
            image[0] + ref - image[0] * ref)

    def fim():
        with torch.no_grad():
            return resolve_and_gather(gather_face_vertices(v0[None], sq_faces), EXAMPLE_SIZE,
                                      hp.near, hp.far, hp.draw_backside, None, False)[0]

    fit = types.SimpleNamespace(param=v0)
    numbers["convergence"] = example_fit_checks("convergence", fit, forward, fim, smi)
    v = v0.clone().requires_grad_(True)
    opt = nr.Adam([v], lr=0.005)
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(CONVERGENCE_STEPS):
        opt.zero_grad()
        loss = forward(fit, v)[1]
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if losses[-1] < CONVERGENCE_LOSS:
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches["convergence"] = dict(rc.LAUNCHES)
    check_fit_launches("convergence", launches["convergence"], SILHOUETTE_KERNELS,
                       rc.SLOT_TABLE_BUILDS)
    log(f"[examples] convergence: IoU loss {losses[0]:.6f} -> {losses[-1]:.6f} in "
        f"{len(losses)} steps ({seconds:.2f} s); launches {json.dumps(launches['convergence'])}")
    if not losses[-1] < CONVERGENCE_LOSS:
        raise AssertionError(f"convergence: the loss stayed above {CONVERGENCE_LOSS} for "
                             f"{CONVERGENCE_STEPS} steps: last {losses[-5:]}")
    log("[examples] step numbers: " + json.dumps(numbers))
    return launches, numbers


# phase 20: the compiled core (ops/graphs.py) at bench, atlas and lit (the
# tiled route) and at scale and hires (the binned route: K7 capped), in
# three forms timed in turns: eager (nr.eager()), the graphed core (each
# render replays its graph; camera, loss and backward's rest eager) and the
# whole step captured by its caller
GRAPH_STEPS = 20
TWO_VIEWS_AZIMUTH = 90.0


class LogLines(logging.Handler):
    """Prints the package's log records as ``[graphs]`` lines and keeps
    their messages."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())
        log(f"[graphs] log: {self.messages[-1]}")


def graph_case(case, smi):
    """The checks and the timed turns of one GraphCase; returns its
    numbers."""
    rc.reset_launches()
    with nr.eager():
        want = case.step()
    eager_launches = {k: n for k, n in rc.LAUNCHES.items() if n}

    # the graphed core: the first call runs eagerly, the second captures,
    # every call from the second replays
    rc.reset_launches()
    check_against(f"{case.label} first call", case.step(), want)
    if any(rc.GRAPHS.values()):
        raise AssertionError(f"{case.label}: first call {rc.GRAPHS}, want it eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = case.step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph = case_graph(case)
    if rc.GRAPHS["captures"] != 1 or rc.GRAPHS["forward_replays"] != 1 or \
            rc.GRAPHS["backward_replays"] != 1:
        raise AssertionError(f"{case.label}: second call {rc.GRAPHS}, want 1 capture, 1 replay")
    errs = {"core": check_against(f"{case.label} graphed core", first, want)}
    second = case.step()
    if rc.GRAPHS["captures"] != 1 or rc.GRAPHS["forward_replays"] != 2:
        raise AssertionError(f"{case.label}: third call {rc.GRAPHS}, want a replay")
    check_against(f"{case.label} graphed core, third call", second, want)
    held = collections.Counter(graph.launches["forward"])
    held.update(graph.launches["backward"])
    if dict(held) != eager_launches:
        raise AssertionError(f"{case.label}: the graphs hold {dict(held)}, the eager step "
                             f"launches {eager_launches}")

    # fresh outputs: step t's images and gradients survive step t + 1, which
    # sees its own vertex values; none is a buffer of the graph
    kept = (first[0].clone(), [g.clone() for g in first[1]])
    moved = [case.values[0] * 1.02] + list(case.values[1:])
    third = case.step(moved)
    check_equal(f"{case.label} step t images after step t + 1", first[0], kept[0])
    for g, k in zip(first[1], kept[1]):
        check_equal(f"{case.label} step t gradient after step t + 1", g, k)
    with nr.eager():
        want_moved = case.step(moved)
    check_against(f"{case.label} graphed core, moved vertices", third, want_moved)
    if torch.equal(third[0], first[0]):
        raise AssertionError(f"{case.label}: moved vertices gave the same images")
    buffers = {graph.output.data_ptr(), *(g.data_ptr() for g in graph.grads if g is not None)}
    if any(t.data_ptr() in buffers for t in (first[0], third[0], *first[1], *third[1])):
        raise AssertionError(f"{case.label}: an output or gradient is a graph's buffer")

    # the whole step, captured by the caller
    rc.reset_launches()
    whole = CallerGraph(case)
    if rc.GRAPHS["captures"]:
        raise AssertionError(f"{case.label}: the caller's capture captured the core itself")
    got_images, got_grads = whole()
    errs["whole"] = check_against(f"{case.label} whole step", (got_images, got_grads), want)
    for i, (t, v, g) in enumerate(zip(whole.leaves, case.values, got_grads)):
        check_equal(f"{case.label} whole step update {i}", t.detach(), v - UPDATE * g)
    if dict(whole.launches) != eager_launches:
        raise AssertionError(f"{case.label}: the caller's graph holds {whole.launches}, "
                             f"the eager step launches {eager_launches}")

    out = dict(capture_s=graph.seconds, capturing_call_s=first_s, caller_capture_s=whole.seconds,
               launches=dict(held), max_abs_err=errs)
    for name, form in time_forms(case, whole, GRAPH_STEPS).items():
        out[name] = form
        ms, busy = form["ms"], form["busy_ms"]
        rel = "=" if form["complete"] else ">="
        log(f"[graphs] {case.label} {name}: {ms:.4f} ms (median of the turns' medians of "
            f"{GRAPH_STEPS}: {', '.join(f'{t:.4f}' for t in form['turns_ms'])}), device busy "
            + (f"{rel} {busy:.4f} ms ({rel} {100 * busy / ms:.1f}%) in {rel} "
               f"{form['ops']:.1f} device operations per step" if busy else
               "not measured (the profiler saw no device time)")
            + f"  ({smi})")
    log(f"[graphs] {case.label}: capture {graph.seconds:.6f} s (the capturing call "
        f"{first_s:.6f} s), the caller's capture {whole.seconds:.6f} s; graphed images equal "
        f"to eager, gradient max abs err {json.dumps(errs)}; the graphs hold "
        f"{json.dumps(dict(held))}")
    return out


def two_views(case, x):
    """The images of ``case``'s renderer from its viewpoint and from
    TWO_VIEWS_AZIMUTH beside it, stacked on channels: two renders of one
    signature before the one backward of their loss."""
    r = case.renderer
    saved = r.viewpoints
    try:
        views = [r.render_silhouettes(x, case.faces)]
        r.viewpoints = nr.get_points_from_angles(2.732, 30, TWO_VIEWS_AZIMUTH)
        views.append(r.render_silhouettes(x, case.faces))
    finally:
        r.viewpoints = saved
    return torch.stack(views, 1)


def overflow_times(fvp, size, smi):
    """K7 and K8's XY form at ``fvp``'s shapes over exact bins, over capped
    bins with half the pair total's slots and with none (every bin from the
    first that holds a face overflows), each bit-equal to the exact bins'
    resolve: event medians in turns (exact, half, zero, zero, half, exact)
    and device ms and operations per call."""
    exact = rc.bin_faces(fvp, True, size)
    total = exact[2].shape[0]
    want = rc.resolve_binned_xy(fvp, True, exact, size, 0.1, 100.0)
    calls, out = {}, {}
    for name, capacity in (("exact", None), ("half", total // 2), ("zero", 0)):
        def call(capacity=capacity):
            bins = rc.bin_faces(fvp, True, size, capacity=capacity)
            return rc.resolve_binned_xy(fvp, True, bins[:3], size, 0.1, 100.0)
        for part, got, w in zip(("index", "depth", "coords"), call(), want):
            check_equal(f"scale K8 over {name} bins {part}", got, w)
        overflow = 0 if capacity is None else int(
            rc.bin_faces(fvp, True, size, capacity=capacity)[3])
        calls[name] = call
        out[name] = dict(capacity=total if capacity is None else capacity, overflow_bins=overflow,
                         turns_ms=[])
    for name in ("exact", "half", "zero", "zero", "half", "exact"):
        out[name]["turns_ms"].append(median_ms(calls[name], 20))
    for name, call in calls.items():
        prof = profile_device(call)
        row = out[name]
        row.update(ms=float(np.mean(row["turns_ms"])), device_ms=prof.busy, device_ops=prof.ops)
        log(f"[graphs] scale K7 + K8 XY, {name} capacity ({row['capacity']} pair slots of "
            f"{total}, {row['overflow_bins']} overflow bins): {row['ms']:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in row['turns_ms'])}), device {prof.busy:.4f} ms in "
            f"{prof.ops:.1f} operations per call  ({smi})")
    return out


def forced_overflow(case, handler):
    """A graph of ``case`` captured with half its pair total's slots: its
    replay is bit-equal to the eager step though bins overflow, it reports
    them (no sync), and the next call captures anew at twice the capacity,
    which fits and stays."""
    with nr.eager():
        want = case.step()
    rc.reset_launches()
    case.step()                      # the signature's first call: eager, keeps the total
    (total,) = graphs.faces_record(case.faces).bin_totals.values()
    with graphs.forced_capacity(total // 2):
        got = case.step()            # captures at total // 2 and replays
    check_against(f"{case.label}: the overflowed replay", got, want)
    torch.cuda.synchronize()
    graph = case_graph(case)
    overflow = graph.overflowed()
    if not overflow or graph.capacities != [total // 2] or rc.GRAPHS["captures"] != 1:
        raise AssertionError(f"{case.label}: capacities {graph.capacities} of {total} pairs, "
                             f"{overflow} overflow bins, {rc.GRAPHS}; want overflow bins")
    check_against(f"{case.label}: the recapturing call", case.step(), want)
    recaptured = case_graph(case)
    check_against(f"{case.label}: after the recapture", case.step(), want)
    torch.cuda.synchronize()
    if rc.GRAPHS["overflow_recaptures"] != 1 or rc.GRAPHS["captures"] != 2 or \
            recaptured.overflowed() or recaptured.capacities[0] < 2 * (total // 2):
        raise AssertionError(f"{case.label}: {rc.GRAPHS}, capacities {recaptured.capacities}, "
                             f"{recaptured.overflowed()} overflow bins after the recapture")
    if not any("overflow bins" in m for m in handler.messages):
        raise AssertionError(f"{case.label}: no log line names the overflow bins")
    log(f"[graphs] {case.label}: the replay captured with {total // 2} pair slots of {total} "
        f"had {overflow} overflow bins, bit-equal images; the next call recaptured at "
        f"{recaptured.capacities} slots, with no overflow bin")
    return dict(total=total, capacity=total // 2, overflow_bins=overflow,
                recaptured_capacity=recaptured.capacities)


def caller_overflow(case):
    """A whole step of ``case`` (binned) captured by its caller with half
    its pair total's slots (``graphs.forced_capacity``): each replay is
    bit-equal to the eager step though bins overflow, and K7's counts
    (``graphs.bin_counters``, which K7 adds into on the card) grow at each
    replay by one binning, the pair total, the slots and exactly the
    overflow words that K7 wrote in that replay, which the port keeps for
    its own graphs only."""
    with nr.eager():
        want = case.step()
    words, bin_faces = [], rc.bin_faces

    def keep_words(*args, capacity=None, **kwargs):
        out = bin_faces(*args, capacity=capacity, **kwargs)
        if capacity is not None:
            words.append(out[3])
        return out

    (total,) = graphs.faces_record(case.faces).bin_totals.values()
    rc.bin_faces = keep_words
    try:
        with graphs.forced_capacity(total // 2):
            whole = CallerGraph(case)
    finally:
        rc.bin_faces = bin_faces
    if len(words) != 1:
        raise AssertionError(f"{case.label}: {len(words)} capped binnings captured, want 1")
    counts = graphs.bin_counters()
    for replay in range(3):
        check_against(f"{case.label}: the caller's overflowed replay {replay + 1}", whole(), want)
        torch.cuda.synchronize()
        overflow = sum(int(w) for w in words)
        now = graphs.bin_counters()
        added = {k: now[k] - counts[k] for k in now}
        counts = now
        if overflow <= 0 or added != dict(binnings=1, pairs=total, slots=total // 2,
                                          overflow_bins=overflow):
            raise AssertionError(f"{case.label}: replay {replay + 1} added {added} to K7's "
                                 f"counts; its overflow word reads {overflow}, the total "
                                 f"{total}, the slots {total // 2}")
    log(f"[graphs] {case.label}: a caller's graph captured with {total // 2} pair slots of "
        f"{total}: each replay bit-equal, {overflow} overflow bins, counted by K7's counts "
        f"as its overflow word reads")
    return dict(total=total, capacity=total // 2, overflow_bins=overflow)


def index_map_forms(cases, smi):
    """``compute_face_index_map`` at each (label, face vertices, size) of
    ``cases`` (phase 15's), eager (``nr.eager()``) and graphed in turns
    (eager, graphed, graphed, eager; CUDA-event medians of GRAPH_STEPS
    calls after 3), with the device busy time and operations per call."""
    out = {}
    for label, fv, S in cases:
        def graphed():
            return nr.compute_face_index_map(fv, S, return_depth=True)

        def eager():
            with nr.eager():
                return graphed()

        forms = {"eager": eager, "graphed": graphed}
        turns = {name: [] for name in forms}
        for name in ("eager", "graphed", "graphed", "eager"):
            turns[name].append(median_ms(forms[name], GRAPH_STEPS, warmup=3))
        out[label] = {}
        for name, fn in forms.items():
            prof = profile_device(fn)
            ms = float(np.median(turns[name]))
            out[label][name] = dict(turns_ms=turns[name], ms=ms, busy_ms=prof.busy, ops=prof.ops)
            log(f"[graphs] compute_face_index_map {label} {name}: {ms:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns[name])}), device busy "
                + (f"{prof.busy:.4f} ms in {prof.ops:.1f} device operations per call"
                   if prof.busy else "not measured (the profiler saw no device time)")
                + f"  ({smi})")
    return out


def sharded_forms(runs, smi):
    """Phase 16's sharded steps in the graphed core's terms: each run's
    per-rank eager and graphed step ms and collective ms (medians over the
    turns), its chain's capture seconds and the operations that stay eager
    in a replayed step."""
    out = {}
    for name, ranks in runs.items():
        out[name] = [dict(eager_ms=float(np.median(r["ms"])),
                          graphed_ms=float(np.median(r["graphed_ms"])),
                          eager_collective_ms=float(np.median(r["coll_ms"])),
                          graphed_collective_ms=float(np.median(r["graphed_coll_ms"])),
                          capture_s=r["graphed"]["capture_s"],
                          eager_device_ops=r["graphed"]["eager_device_ops"])
                     for r in ranks]
        log(f"[graphs] sharded {name} {SHARDED[name]}, per rank (eager / graphed ms, their "
            f"collectives' ms; ops left eager in a replayed step): "
            + "; ".join(f"rank {i} {r['eager_ms']:.4f} / {r['graphed_ms']:.4f} "
                        f"({r['eager_collective_ms']:.4f} / {r['graphed_collective_ms']:.4f}; "
                        f"{r['eager_device_ops']})" for i, r in enumerate(out[name]))
            + f"  ({smi})")
    return out


def graphs_phase(cases, scale, index_cases, sharded, smi):
    """Phase 20: the compiled core at ``cases`` (bench, atlas, lit: tiled;
    scale, hires: binned), and at bench: int64 faces over 10 steps (one
    capture, one K4 table), an in-place faces edit (a new capture), a fresh
    faces tensor each step (no capture), two views under one loss (a graph
    each), a no_grad render; at ``scale`` = (renderer, vertices, faces): a
    forced overflow (:func:`forced_overflow`), one in a caller's graph
    (:func:`caller_overflow`) and K7 + K8 over overflow bins timed
    (:func:`overflow_times`); ``compute_face_index_map`` at
    phase 15's ``index_cases`` (:func:`index_map_forms`) and phase 16's
    ``sharded`` runs (:func:`sharded_forms`)."""
    handler = LogLines()
    logger = logging.getLogger(PKG)
    saved = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        numbers = {case.label: graph_case(case, smi) for case in cases}
        bench = cases[0]

        faces64 = bench.faces.long()
        case64 = GraphCase("bench int64 faces", bench.renderer, faces64,
                           lambda x: bench.renderer.render_silhouettes(x, faces64),
                           bench.values)
        rc.reset_launches()
        for _ in range(10):
            case64.step()
        if rc.GRAPHS["captures"] != 1 or rc.SLOT_TABLE_BUILDS != 1 or \
                rc.GRAPHS["forward_replays"] != 9:
            raise AssertionError(f"int64 faces over 10 steps: {rc.GRAPHS}, "
                                 f"{rc.SLOT_TABLE_BUILDS} K4 tables; want 1 capture, 1 table")
        nf = faces64.shape[0]
        faces64[: nf // 2] = faces64[nf // 2:nf // 2 * 2].clone()     # in place
        edited = [case64.step() for _ in range(2)]
        if rc.GRAPHS["captures"] != 2:
            raise AssertionError(f"an in-place faces edit did not recapture: {rc.GRAPHS}")
        with nr.eager():
            want = case64.step()
        for i, e in enumerate(edited):
            check_against(f"bench after an in-place faces edit, call {i + 1}", e, want)

        # a fresh faces tensor at each step: every call its tensor's first,
        # run eagerly, no capture
        with nr.eager():
            want_bench = bench.step()
        fresh = GraphCase("bench fresh faces", bench.renderer, None,
                          lambda x: bench.renderer.render_silhouettes(x, bench.faces.clone()),
                          bench.values)
        rc.reset_launches()
        for _ in range(5):
            check_against("bench, fresh faces each step", fresh.step(), want_bench)
        if any(rc.GRAPHS.values()) or rc.LAUNCHES["resolve_xy"] != 5:
            raise AssertionError(f"fresh faces tensors over 5 steps: {rc.GRAPHS}, "
                                 f"{rc.LAUNCHES['resolve_xy']} K2 launches; want 5 eager steps")

        # two views under one loss: each render replays a graph of its own
        two = GraphCase("bench two views", bench.renderer, bench.faces,
                        lambda x: two_views(bench, x), bench.values)
        with nr.eager():
            want_two = two.step()
        rc.reset_launches()
        for step in range(3):
            check_against(f"bench two views, step {step + 1}", two.step(), want_two)
        kept = len(graphs.kept_graphs(bench.faces))
        if rc.GRAPHS["captures"] != 1 or kept != 2 or rc.GRAPHS["backward_replays"] != 6:
            raise AssertionError(f"two views: {rc.GRAPHS}, {kept} graphs kept; want one "
                                 f"more capture, two graphs, six backward replays")

        renderer = bench.renderer
        with torch.no_grad():
            got = renderer.render_silhouettes(bench.values[0], bench.faces)
        with torch.no_grad(), nr.eager():
            check_equal("bench no_grad render", got,
                        renderer.render_silhouettes(bench.values[0], bench.faces))

        if any(m.startswith("eager, binned route") for m in handler.messages):
            raise AssertionError("a binned render ran eagerly for its route")
        r, v, f = scale
        over_faces = f.clone()
        numbers["scale forced overflow"] = forced_overflow(
            GraphCase("scale forced overflow", r, over_faces,
                      lambda x: r.render_silhouettes(x, over_faces), [v]), handler)
        caller_faces = f.clone()
        numbers["scale caller overflow"] = caller_overflow(
            GraphCase("scale caller overflow", r, caller_faces,
                      lambda x: r.render_silhouettes(x, caller_faces), [v]))
        with torch.no_grad():
            fvp = gather_face_vertices(r.transform_vertices(v), f)
        numbers["scale overflow times"] = overflow_times(fvp, r.image_size, smi)
        numbers["compute_face_index_map"] = index_map_forms(index_cases, smi)
        numbers["sharded"] = sharded_forms(sharded, smi)
        numbers["checks"] = ("int64 faces: 1 capture, 1 K4 table over 10 steps; an in-place "
                             "edit recaptured; fresh faces each step: eager; two views "
                             "under one loss: 2 graphs; no_grad equal; scale and hires "
                             "graphed (K7 capped); a forced overflow at scale: exact, "
                             "counted, recaptured once; in a caller's graph: exact, each "
                             "replay's overflow word added to K7's counts")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(saved)
    log("[graphs] " + json.dumps(numbers))
    return numbers


# phase 21: the measurement modules (neural_renderer_v2_pytorch_tpu_torch/
# benchmarks/) through their run() functions, at short lengths
BENCH_ITERS, BENCH_CYCLES = 20, 2
MEASURE_AZIMUTHS = 4
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "device", "power_limit", "forms",
              "faces")


def check_positive(label, values):
    """Each of ``values`` a finite number above 0."""
    bad = {k: v for k, v in values.items() if not (isinstance(v, float) and 0 < v < np.inf)}
    if bad:
        raise AssertionError(f"{label}: not a finite positive number: {bad}")


def benchmarks_phase(dev, smi):
    """Phase 21: ``benchmarks.bench`` (BENCH_ITERS, BENCH_CYCLES cycles; its
    chained step held to the eager step inside), ``measure_time`` over
    MEASURE_AZIMUTHS azimuths, ``scaling --quick``, ``kernel_census`` and
    ``roofline`` (bench and hires, K9, K6); each module's JSON line printed and
    its numbers checked.  Returns the seconds it took."""
    t0 = time.perf_counter()
    name, power_limit = (part.strip() for part in smi.rsplit(",", 1))
    out = {"bench": bench.run(dev, iters=BENCH_ITERS, cycles=BENCH_CYCLES)}
    b = out["bench"]
    log(json.dumps(b))
    if tuple(b) != BENCH_KEYS or b["unit"] != "pixels/s" or \
            (b["device"], b["power_limit"]) != (name, power_limit):
        raise AssertionError(f"bench: malformed line {b}")
    check_positive("bench", {k: b["forms"][k] for k in ("eager_ms", "core_ms", "whole_ms")}
                   | {"value": b["value"]})
    out["measure_time"] = m = measure_time.run(dev, iters=MEASURE_AZIMUTHS)
    log(json.dumps(m))
    check_positive("measure_time", m["ms"])
    out["scaling"] = sc = scaling.run(dev, quick=True)
    log(json.dumps(sc))
    quick = [r.label for r in scaling.ROWS if r.label in scaling.QUICK]
    if [r["label"] for r in sc["rows"]] != quick:
        raise AssertionError(f"scaling --quick: rows {[r['label'] for r in sc['rows']]}")
    for r in sc["rows"]:
        check_positive(f"scaling {r['label']}", {f: r[f]["ms"] for f in ("eager", "core", "whole")})
    out["kernel_census"] = c = kernel_census.run(dev)
    log(json.dumps(c))
    for form in ("eager", "core", "whole"):
        if c["forms"][form]["launches"] != c["forms"]["eager"]["launches"] or not all(
                c["forms"][form]["launches"].get(k) for k in SILHOUETTE_KERNELS):
            raise AssertionError(f"kernel_census: {form} launches {c['forms'][form]['launches']}")
    out["roofline"] = rf = roofline.run(dev)
    log(json.dumps(rf))
    if len(rf["rows"]) != 2 * len(roofline.FUNCTIONS) + 2:
        raise AssertionError(f"roofline: {len(rf['rows'])} rows")
    check_positive("roofline bounds", {f"{r['config']} {r['function']}": r["bound_ms"]
                                       for r in rf["rows"]})
    seconds = time.perf_counter() - t0
    log(f"[benchmarks] bench, measure_time, scaling --quick, kernel_census and roofline: "
        f"{seconds:.1f} s")
    return seconds


# phase 22: the JAX package's pipeline edge cases (utils.scenes.edge_scenes)
# on both routes; each graphed step is called this many times: the first
# runs eagerly, the second captures, every call from the second replays
EDGE_GRAPH_CALLS = 3
# K1 and K6 run on no render path (K14 adds the atlas taps as K6 does)
EDGE_KERNELS = tuple(name for name in rc.KERNELS if name not in ("face_setup",
                                                                  "atlas_taps_grad"))


def _silhouettes_forward(faces, hp):
    return lambda x: nr.rasterize_silhouettes(x, faces, None, hp)


def _rgba_forward(faces, params, hp):
    return lambda x, t: nr.rasterize_rgba(x, faces, params.replace(textures=t), hp)


def edge_cases(dev):
    """The edge phase's steps, on tensors made anew (so that no graph kept
    over another route's faces tensor replays): [(GraphCase, the index
    map's face vertices [bs, nf, 3, 3], its size)], each scene's silhouettes
    and, for the soups, its RGBA with the ``create_textures`` atlas
    (``texture_size`` 2) and as a loaded atlas (``texture_size`` None: K6
    in the backward), the atlas taking gradients."""
    out = []
    for name, scene in edge_scenes().items():
        x = torch.tensor(scene["vertices"], device=dev)
        faces = torch.tensor(scene["faces"], device=dev)
        size = EDGE_SIZE * (2 if scene["anti_aliasing"] else 1)
        fv = x[:, faces.long()]
        hp = nr.RasterizeHyperparam(image_size=EDGE_SIZE, anti_aliasing=scene["anti_aliasing"])
        out.append((GraphCase(name, None, faces, _silhouettes_forward(faces, hp), [x]), fv, size))
        if "textures" not in scene:
            continue
        vt, ft, tex = (torch.tensor(scene[k], device=dev)
                       for k in ("vertices_t", "faces_t", "textures"))
        for form, ts in (("texel", EDGE_TEXTURE_SIZE), ("atlas", None)):
            params = nr.RasterizeParam(vertices_textures=vt, faces_textures=ft, texture_size=ts)
            out.append((GraphCase(f"{name} rgba {form}", None, faces,
                                  _rgba_forward(faces, params, hp), [x, tex]), fv, size))
    return out


def edge_step(case):
    """``case``'s forward and backward under the JAX edge tests' loss,
    sum(images^2) (on a binary silhouette bench_loss's NMR gradients
    cancel): (images, [gradient of each value])."""
    leaves = [v.clone().requires_grad_(True) for v in case.values]
    images = case.forward(*leaves)
    torch.sum(images ** 2).backward()
    return images.detach(), [t.grad for t in leaves]


def edge_case_forms(case, fv, size, route):
    """One edge step (:func:`edge_step`) on ``route``: eager
    (``nr.eager()``) and graphed (EDGE_GRAPH_CALLS calls: one capture,
    replays from the second), its index map eager and graphed, and the
    winners' face vertices through ``to_map`` (K9), each held to the plain
    versions on the card: images, index maps and rows equal, gradients
    within GRAD_RTOL of their largest magnitude and finite; the plain
    gradients all zero where nothing is drawn, none all zero elsewhere.
    Returns ({form: largest gradient error}, each plain gradient's largest
    magnitude, the coverage)."""
    label = f"[edge] {route} {case.label}"
    rows = fv.reshape(fv.shape[0], fv.shape[1], 9)
    with rc.forced_route(route):
        with nr.eager(), rc.plain_versions():
            want = edge_step(case)
            want_fim = nr.compute_face_index_map(fv, size)
            want_rows = nr.to_map(rows, want_fim)
        with nr.eager():
            got = {"eager": edge_step(case)}
            fims = [nr.compute_face_index_map(fv, size)]
            check_equal(f"{label} to_map", nr.to_map(rows, fims[0]), want_rows)
        before = dict(rc.GRAPHS)
        for call in range(EDGE_GRAPH_CALLS):
            got[f"graphed {call}"] = edge_step(case)
        graphed = {k: rc.GRAPHS[k] - before[k] for k in before}
        want_graphed = dict(captures=1, forward_replays=EDGE_GRAPH_CALLS - 1,
                            backward_replays=EDGE_GRAPH_CALLS - 1)
        if {k: graphed[k] for k in want_graphed} != want_graphed:
            raise AssertionError(f"{label}: graphed calls {graphed}")
        before = rc.GRAPHS["forward_replays"]
        fims += [nr.compute_face_index_map(fv, size) for _ in range(EDGE_GRAPH_CALLS)]
        if rc.GRAPHS["forward_replays"] - before < EDGE_GRAPH_CALLS - 1:
            raise AssertionError(f"{label}: index map replays {rc.GRAPHS}")
    for i, fim in enumerate(fims):
        check_equal(f"{label} index map {i}", fim, want_fim)
    largest = [float(g.abs().max()) for g in want[1]]
    drawn = bool((want_fim >= 0).any())
    if drawn != all(largest) or drawn != bool(want[0].any()):
        raise AssertionError(f"{label}: coverage {drawn}, largest plain gradients {largest}")
    errs = {}
    for form, (images, grads) in got.items():
        for g in grads:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{label} {form}: gradients not finite")
        errs[form] = check_against(f"{label} {form}", (images, grads), want)
    return errs, largest, float((want_fim >= 0).float().mean())


def edge_whole_step(case, route):
    """``case``'s whole step (render, bench_loss, backward, update) captured
    by its caller in one ``torch.cuda.graph`` on ``route`` (the binned one
    capped at the warm-up's pair total), replayed once and held to the
    plain versions: images equal, gradients within GRAD_RTOL.  Returns the
    largest gradient error and the kernels the graph holds."""
    with rc.forced_route(route):
        whole = CallerGraph(case)
        with nr.eager(), rc.plain_versions():
            want = case.step()
    images, grads = whole()
    err = check_against(f"[edge] {route} {case.label} whole step", (images, grads), want)
    resolve = "resolve_xy" if route == "tiled" else "resolve_binned_xy"
    if whole.launches.get(resolve) != 1 or whole.launches.get("bin_faces", 0) != (
            route == "binned"):
        raise AssertionError(f"[edge] {route} {case.label} whole step holds {whole.launches}")
    return err, whole.launches


def edge_phase(dev, smi):
    """Phase 22: every edge case on the tiled and the binned route (forced
    through ``resolve_cuda.forced_route``), eager and graphed, against the
    plain versions on the card (:func:`edge_case_forms`), and the mixed
    batch's whole step captured by its caller on each route. The
    launches are counted from 0 over the phase: every kernel but K1.
    Returns (the launches, the seconds)."""
    t0 = time.perf_counter()
    rc.reset_launches()
    for route in rc.ROUTES:
        for case, fv, size in edge_cases(dev):
            errs, largest, coverage = edge_case_forms(case, fv, size, route)
            log(f"[edge] {route} {case.label}: images, index maps and to_map rows equal to "
                f"the plain versions; grad max abs err {json.dumps(errs)} (largest plain |g| "
                f"{json.dumps(largest)}), coverage {coverage:.4f}  ({smi})")
        mixed = next(case for case, _, _ in edge_cases(dev) if case.label == "mixed")
        err, held = edge_whole_step(mixed, route)
        log(f"[edge] {route} mixed whole step captured by its caller: images equal, grad max "
            f"abs err {err}; the graph holds {json.dumps(held)}  ({smi})")
    torch.cuda.synchronize()
    launches = dict(rc.LAUNCHES)
    seconds = time.perf_counter() - t0
    log(f"[edge] {seconds:.1f} s, launches {json.dumps(launches)}  ({smi})")
    missed = [name for name in EDGE_KERNELS if not launches[name]]
    if missed:
        raise AssertionError(f"[edge] kernels never launched: {missed}")
    check_k1("edge phase", launches)
    return launches, seconds


# phase 23: the sharded entry across cards, one rank per card over NCCL
# (parallel.run_ranks with no backend named), each rank's step replayed as
# one forward and one backward CUDA graph with its collectives inside.  It
# runs only where the machine has two cards or more; a run that needs more
# ranks than there are cards is left out.  name -> (ShardedCase scene, mesh):
# SHARDED's runs on 2 cards, and in the place of all-axes (2, 2, 2), which
# needs 8, its lit two-view scene at (1, 2, 2) and (2, 2, 1) on 4
CARDS = {
    "scale-face2": ("scale-face2", (1, 1, 2)),
    "textured-scale-face2": ("textured-scale-face2", (1, 1, 2)),
    "bench-tile2": ("bench-tile2", (1, 2, 1)),
    "atlas-tile2-backgrounds": ("atlas-tile2-backgrounds", (1, 2, 1)),
    "lit-tile2-face2": ("all-axes", (1, 2, 2)),
    "lit-data2-tile2": ("all-axes", (2, 2, 1)),
}
# the scaling run: scale's 81,920-face mesh at 512^2 over tile on each count
# of cards (one card: the single-device entry point)
SCALING_CARDS = (1, 2, 4)
CARDS_RTOL = 1e-5          # tests/test_torch_parallel.py's bound
CARDS_TIMEOUT = 300.0      # seconds for one spawn of ranks, every collective included


def nccl_kind_ms(step, order, steps=SHARDED_STEPS):
    """{kind: device ms per step} of the NCCL kernels of ``steps`` graphed
    steps under torch.profiler: the records in time order, the i-th of a
    step taken as the i-th collective the chain holds (``order``, its kinds
    forward then backward); None where the records are not ``steps`` times
    ``order`` (a record dropped: not measured)."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    records = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower())
    if len(records) != steps * len(order):
        return None
    out = collections.defaultdict(float)
    for i, (_, us) in enumerate(records):
        out[order[i % len(order)]] += us / 1e3 / steps
    return dict(out)


def cards_turns(case, mesh):
    """SHARDED_STEPS steps of ``case`` in each of SHARDED_TURNS (eager under
    ``nr.eager()`` with CUDA events around each collective, graphed), then
    the graphed step's NCCL kernels profiled.  Returns {form: [step ms]},
    the eager collectives' device ms by kind and the graphed ones'."""
    ms = collections.defaultdict(list)
    eager_kind = collections.defaultdict(list)
    for form in SHARDED_TURNS:
        with nr.eager() if form == "eager" else contextlib.nullcontext():
            with parallel.collectives.device_timing() as records:
                ms[form].extend(sharded_turn(case, mesh, SHARDED_STEPS)[0])
        if form == "eager":
            per = parallel.collectives.device_ms(records)
            for kind, v in per.items():
                if v:
                    eager_kind[kind].append(v / SHARDED_STEPS)
    (chain,) = graphs.kept_graphs(case.faces)
    order = chain.inline["forward"] + chain.inline["backward"]
    return dict(ms), {k: float(np.mean(v)) for k, v in eager_kind.items()}, \
        nccl_kind_ms(lambda: case.step(mesh), order)


def capture_alone(label, case, mesh, want):
    """The last rank forgets its chain: its next call runs eagerly and the
    one after captures while every other rank replays; each of three calls
    on every rank equal to the eager sharded step ``want`` (images equal,
    gradients within CARDS_RTOL).  Returns whether this rank's chain is a
    new one (the last rank's only)."""
    import torch.distributed as dist

    alone = dist.get_rank() == dist.get_world_size() - 1
    (before,) = graphs.kept_graphs(case.faces)
    if alone:
        graphs._drop(graphs.faces_record(case.faces))
    for call in range(3):
        images, grads, _ = case.step(mesh)
        check_equal(f"{label} call {call + 1} beside a rank that captures alone, images",
                    images, want[0])
        for k, g in want[1].items():
            check_close(f"{label} call {call + 1} beside a rank that captures alone, {k} grads",
                        grads[k], g, CARDS_RTOL)
    (after,) = graphs.kept_graphs(case.faces)
    if (after is not before) != alone:
        raise AssertionError(f"{label}: the chain {'kept' if alone else 'captured anew'} beside "
                             f"a rank that captures alone")
    return alone


def cards_rank(runs):
    """One rank's share of a spawn of phase 23: each (name, scene, shape) of
    ``runs``, on this rank's card, held to the single-device step on the
    same card (images and the index band equal, gradients within
    CARDS_RTOL), eager (launches and census read around it) and through the
    graphed core (:func:`sharded_graphed`: its chain one forward and one
    backward graph holding every collective), then timed in turns
    (:func:`cards_turns`) and run beside a rank that captures alone.
    Raises on any disagreement; returns {name: what the parent prints}."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {}
    t0 = time.perf_counter()

    def progress(what):
        print(f"[cards] rank {rank} {name}: {what} at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    for name, scene, shape in runs:
        progress("start")
        case = ShardedCase(scene, dev, shape)
        mesh = parallel.make_mesh(*shape)
        label = f"{name} {shape} rank {rank} ({torch.cuda.get_device_name(dev)} cuda:{dev.index})"
        with nr.eager():
            want_images, want_grads, _ = case.step()
        dist.barrier()
        torch.cuda.synchronize()
        parallel.reset_collectives()
        rc.reset_launches()
        with nr.eager():
            images, grads, forward = case.step(mesh)
        torch.cuda.synchronize()
        launches, census = dict(rc.LAUNCHES), dict(parallel.COLLECTIVES)
        check_equal(f"{label} images", images, want_images)
        errs = {k: check_close(f"{label} {k} grads", grads[k], g, CARDS_RTOL)
                for k, g in want_grads.items()}
        if not all(float(g.abs().max()) > 0 for g in grads.values()):
            raise AssertionError(f"{label}: a gradient is all zero")
        with nr.eager():
            near_ties = check_index_band(label, case, mesh)
        if (forward, census) != sharded_census(*shape):
            raise AssertionError(f"{label}: census forward {forward} step {census}")
        check_k1(label, launches)
        progress("eager step checked")
        graphed = sharded_graphed(label, case, mesh, (images, grads, forward, (forward, census)),
                                  shape[2], CARDS_RTOL)
        progress("graphed steps checked")
        if [len(graphed["segments"][k]) for k in ("forward", "backward")] != [1, 1]:
            raise AssertionError(f"{label}: the chain has segments {graphed['segments']}, "
                                 f"want one forward and one backward graph")
        ms, eager_kind, graphed_kind = cards_turns(case, mesh)
        progress("timed")
        alone = capture_alone(label, case, mesh, (images, grads))
        progress("beside a rank that captures alone")
        out[name] = dict(
            coords=mesh.coords, errs=errs, near_ties=near_ties, census=census,
            launches={k: v for k, v in launches.items() if v}, graphed=graphed, ms=ms,
            eager_kind=eager_kind, graphed_kind=graphed_kind, alone=alone,
            digests={k: hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest()
                     for k, g in grads.items()})
    return out


def cards_phase(dev, smi):
    """Phase 23 on every run of CARDS and SCALING_CARDS that the cards
    hold: one spawn per world size, one rank per card over NCCL
    (:func:`cards_rank`), every rank's gradients then held to rank 0's
    bits, eager and graphed; each run's per-rank step ms (eager and graphed
    in turns) and NCCL device ms by kind, and the scaling run's Mpx/s and
    efficiency against one card, logged with the cards' name, power limit
    and count.  Returns the ranks' launch counts of the eager steps
    summed (empty on one card, where it logs that it did not run)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[cards] {cards} card: NCCL phase not run")
        return collections.Counter()
    where = f"{smi}, {cards} cards"
    torch.cuda.empty_cache()          # the ranks share card 0 with this process
    spawns = collections.defaultdict(list)
    for name, (scene, shape) in CARDS.items():
        if int(np.prod(shape)) <= cards:
            spawns[int(np.prod(shape))].append((name, scene, shape))
    for n in SCALING_CARDS[1:]:
        if n <= cards:
            spawns[n].append((f"scale-tile{n}", "scale-face2", (1, n, 1)))
    launches, runs = collections.Counter(), {}
    for world, names in spawns.items():
        t0 = time.perf_counter()
        ranks = parallel.run_ranks(cards_rank, world, (names,), device="cuda",
                                   timeout=CARDS_TIMEOUT)
        log(f"[cards] {world} ranks, one per card (nccl): {[n for n, _, _ in names]} in "
            f"{time.perf_counter() - t0:.1f} s, rank start-up included")
        for name, _, shape in names:
            runs[name] = shape, [r[name] for r in ranks]
            first = runs[name][1][0]
            for rank, r in enumerate(runs[name][1]):
                launches.update(r["launches"])
                if r["digests"] != first["digests"] or \
                        r["graphed"]["digests"] != first["graphed"]["digests"]:
                    raise AssertionError(f"{name}: rank {rank}'s gradients are not rank 0's "
                                         f"bits")
    for name, (shape, ranks) in runs.items():
        for rank, r in enumerate(ranks):
            g = r["graphed"]
            log(f"[cards] {name} mesh {shape} rank {rank} {r['coords']}: images and index "
                f"band equal to the single-device step's (cross-shard near-tie pixels "
                f"{r['near_ties']}), grad max abs err {json.dumps(r['errs'])} (bound "
                f"{CARDS_RTOL} of max), census {json.dumps(r['census'])} eager and graphed, "
                f"every rank's gradients the same bits eager and graphed; the chain holds "
                f"{json.dumps(g['held'])} in one forward and one backward graph with its "
                f"collectives {json.dumps(g['inline'])} inside, capture {g['capture_s']:.6f} s; "
                f"beside a rank that captures alone: equal"
                + (" (this rank captured alone)" if r["alone"] else "") + f"  ({where})")
        log(f"[cards] {name} step {shape} on {len(ranks)} cards, ms, turns "
            f"{'/'.join(SHARDED_TURNS)}: "
            + "; ".join(f"rank {i} eager {float(np.median(r['ms']['eager'])):.4f}, graphed "
                        f"{float(np.median(r['ms']['graphed'])):.4f}" for i, r in enumerate(ranks))
            + f" (medians of {2 * SHARDED_STEPS} each)  ({where})")
        log(f"[cards] {name} NCCL device ms per step by kind: "
            + "; ".join(f"rank {i} eager (CUDA events) "
                        + json.dumps({k: round(v, 4) for k, v in r["eager_kind"].items()})
                        + ", graphed (profiler) "
                        + (json.dumps({k: round(v, 4) for k, v in r["graphed_kind"].items()})
                           if r["graphed_kind"] is not None else "not measured")
                        for i, r in enumerate(ranks)) + f"  ({where})")
    # the scaling run on one card: the single-device graphed step, timed as
    # sharded_turn times a rank's (the host's clock around a synchronised step)
    case = ShardedCase("scale-face2", dev, (1, 1, 1))
    for _ in range(3):
        case.step()
    ms = []
    for _ in range(2 * SHARDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        case.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    one = float(np.median(ms))
    scaling = {1: one}
    for n in SCALING_CARDS[1:]:
        if f"scale-tile{n}" in runs:
            scaling[n] = max(float(np.median(r["ms"]["graphed"]))
                             for r in runs[f"scale-tile{n}"][1])
    pixels = case.image_size ** 2
    log("[cards] scaling, scale's 81,920 faces at 512^2 over tile, graphed step (slowest "
        "rank's median): " + "; ".join(
            f"{n} card{'s' * (n > 1)} {t:.4f} ms = {pixels / t / 1e3:.3f} Mpx/s, efficiency "
            f"{one / (n * t):.3f}" for n, t in scaling.items()) + f"  ({where})")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    path, seconds, compiler_log = cuda_build.build()
    cuda_build.load()
    log(f"[build] {seconds:.1f} s -> {os.path.relpath(path, ROOT)}")
    for line in compiler_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # phases 2-19 run eagerly, op by op, as before the compiled core: each
    # launch check counts its steps' launches as they run, and each time
    # compares with earlier runs of this script; phase 20 runs the graphs
    eagerly = nr.eager()
    eagerly.__enter__()

    # 2. each silhouette kernel vs its plain version at the slice's shapes
    tv, tf = torus(40, 32)
    ndc, faces = ndc_scene(tv, tf, dev)
    all_errs = {}
    bench_errs, bench_calls = kernels_vs_plain("bench", ndc, faces, 512, gen)
    all_errs.update(bench_errs)
    # the NMR passes at the benchmark cells' shapes
    nmr_calls = {}
    for label, (bs, S) in NMR_SHAPES.items():
        _, nmr_calls[label] = nmr_kernels_vs_plain(label, *nmr_inputs(bs, S, gen), gen)
    # the loaded-atlas sampler at the atlas cell's shapes, timed here
    sampler_errs, _, sampler_times = sampler_phase(dev, gen)
    all_errs.update(sampler_errs)

    # 3. the silhouette slice, kernels vs plain versions, through Renderer
    renderer = nr.Renderer(dev)
    renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
    torus_v = torch.tensor(tv[None], device=dev)
    slice_vs_plain("bench", renderer, torus_v, faces, bench_loss)

    # 4. against the JAX package's golden (stored NDC: the camera is bypassed)
    gold = np.load(GOLDEN)
    x = torch.tensor(gold["ndc"], device=dev, requires_grad=True)
    gfaces = torch.tensor(gold["faces"], device=dev)
    images = nr.rasterize_silhouettes(x, gfaces, None, nr.RasterizeHyperparam(image_size=64))
    torch.sum((images - torch.tensor(gold["target"], device=dev)) ** 2).backward()
    with torch.no_grad():
        fim = resolve_and_gather(gather_face_vertices(x, gfaces), 128, 0.1, 100.0, True)[0]
    check_equal("golden image", images.detach().cpu(), torch.tensor(gold["image"]))
    check_equal("golden index map", fim.cpu(), torch.tensor(gold["fim"]))
    err = check_close("golden vertex grads", x.grad.cpu(), torch.tensor(gold["grads"]))
    log(f"[golden] image and index map equal to JAX, grad max abs err {err}")

    # 5. the silhouette main path: five Adam steps of a vertex fit
    target = renderer.render_silhouettes(torus_v, faces).detach()
    sv, sf = icosphere(3)
    sphere_faces = torch.tensor(sf, device=dev)
    x = torch.tensor(sv[None], device=dev, requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.01)
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        opt.zero_grad()
        loss = torch.sum((renderer.render_silhouettes(x, sphere_faces) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sil_launches = dict(rc.LAUNCHES)
    check_one_slot_table("silhouette fit")
    log(f"[fit] icosphere(3) -> torus silhouette, 256^2 AA, losses {losses}, "
        f"{fit_s:.3f} s, launches {json.dumps(sil_launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fit loss did not fall: {losses}")
    if not all(sil_launches[name] > 0 for name in SILHOUETTE_KERNELS):
        raise AssertionError(f"a kernel of the silhouette path never launched: {sil_launches}")
    check_k1("silhouette fit", sil_launches)
    if sil_launches["bin_faces"]:
        raise AssertionError(f"the silhouette fit took the binned route: {sil_launches}")
    nmr_launches = {name: sil_launches[name] for name in NMR_KERNELS + (rc.NMR_PLAIN,)}
    log(f"[nmr] the silhouette fit's NMR passes over its 5 steps (K10, K11, K12, and the "
        f"calls that took a plain version): {json.dumps(nmr_launches)}")
    if any(sil_launches[name] != 5 for name in NMR_KERNELS) or sil_launches[rc.NMR_PLAIN]:
        raise AssertionError(f"the silhouette fit's NMR passes: {nmr_launches}; want one "
                             "launch of each a step and no plain version")

    # 6. scale: 81,920 faces at 512^2 without anti-aliasing
    iv, ifc = icosphere(6)
    ndc6, faces6 = ndc_scene(iv, ifc, dev, azimuth=30.0)
    _, scale_calls = kernels_vs_plain("scale", ndc6, faces6, 512, gen)
    scale_renderer = nr.Renderer(dev)
    scale_renderer.image_size = 512
    scale_renderer.anti_aliasing = False
    scale_renderer.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
    sphere_v = torch.tensor(iv[None], device=dev)
    slice_vs_plain("scale", scale_renderer, sphere_v, faces6, pattern_loss)

    # 7. the textured kernels vs their plain versions at the three
    # configurations (one plain resolve call each)
    cfgs = {name: Textured(name, dev) for name in TEXTURED}
    tex_calls, plain_resolve_ms = {}, {}
    for name in ("atlas", "lit", "textured-scale"):
        errs, tex_calls[name], plain_resolve_ms[name] = textured_kernels_vs_plain(cfgs[name], gen)
        for k, e in errs.items():
            all_errs[k] = max(all_errs.get(k, 0.0), e)
    # its one call of seconds is the time of the plain version there
    tex_calls["textured-scale"]["resolve_latch"] = tex_calls["textured-scale"][
        "resolve_latch"]._replace(plain=plain_resolve_ms["textured-scale"])

    # K9 at the face-sharded path's shapes: the winner rows of scale (D = 9,
    # the coordinates) and of textured-scale (D = 27: coordinates, UV,
    # texels) over their index maps, as the winner gather reads them
    with torch.no_grad():
        fvp6 = gather_face_vertices(ndc6, faces6)
        scale_calls["gather_rows"] = gather_rows_check(
            "scale", fvp6.permute(0, 3, 2, 1).reshape(1, -1, 9).contiguous(),
            index_map(scale_renderer, sphere_v, faces6, False))
        ts = cfgs["textured-scale"]
        _, fvp, _, attrs = ts.latch_inputs()
        table = torch.cat([fvp.permute(0, 3, 2, 1).reshape(1, -1, 9), attrs], -1).contiguous()
        tex_calls["textured-scale"]["gather_rows"] = gather_rows_check("textured-scale", table,
                                                                       ts.fim())
    all_errs["gather_rows"] = 0.0     # bit-equal, or the checks raised

    # 8. the textured steps, kernels vs plain versions
    steps_vs_plain("atlas", cfgs["atlas"].step, cfgs["atlas"].fim)
    steps_vs_plain("lit", cfgs["lit"].step, cfgs["lit"].fim)
    steps_vs_plain("atlas depth", lambda: cfgs["atlas"].step("depth"), cfgs["atlas"].fim)
    steps_vs_plain("atlas all", lambda: cfgs["atlas"].step("all"), cfgs["atlas"].fim)

    # 9. against the JAX package's RGB golden
    rgb_golden(dev)

    # 10. the textured main path: five Adam steps of an atlas + vertex fit
    atlas = cfgs["atlas"]
    with torch.no_grad():
        target = atlas.renderer.render(atlas.vertices, atlas.faces, atlas.vt, atlas.ft,
                                       atlas.textures)
    x = (1.05 * atlas.vertices).requires_grad_(True)
    tex = torch.full_like(atlas.textures, 0.5).requires_grad_(True)
    opt = torch.optim.Adam([{"params": [x], "lr": 0.005}, {"params": [tex], "lr": 0.05}])
    fit_faces = atlas.faces.clone()        # a fit's own faces: its one slot table
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        opt.zero_grad()
        images = atlas.renderer.render(x, fit_faces, atlas.vt, atlas.ft, tex)
        loss = torch.sum((images - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tex_launches = dict(rc.LAUNCHES)
    check_one_slot_table("textured fit")
    log(f"[fit] atlas + vertices of torus(40, 32), 1190x1920 atlas, 256^2 AA, losses "
        f"{losses}, {fit_s:.3f} s, launches {json.dumps(tex_launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"textured fit loss did not fall: {losses}")
    if not all(tex_launches[name] > 0 for name in TEXTURED_KERNELS):
        raise AssertionError(f"a kernel of the textured path never launched: {tex_launches}")
    check_k1("textured fit", tex_launches)
    if tex_launches["bin_faces"]:
        raise AssertionError(f"the textured fit took the binned route: {tex_launches}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # 11. high resolution: K7 and K8 against K2/K2L/K2D and their plain
    # versions at full size, and against the plain resolve at bench and S=100
    hires = nr.Renderer(dev)
    hires.image_size = 1024
    hires.viewpoints = nr.get_points_from_angles(2.732, 30, 30.0)
    hl = cfgs["hires-lit"]
    with torch.no_grad():
        fvp = gather_face_vertices(hires.transform_vertices(sphere_v), faces6)
        errs, hires_calls = binned_kernels("hires", fvp, rc.face_setup(fvp, True),
                                           fvp.new_empty((1, faces6.shape[0], 0)), 2048, gen)
        _, fvp, consts, attrs = hl.latch_inputs()
        hl_errs, hl_calls = binned_kernels("hires-lit", fvp, consts, attrs, hl.size, gen)
    for e in (errs, hl_errs):
        all_errs["scatter_pixels_to_faces"] = max(all_errs["scatter_pixels_to_faces"],
                                                  e["scatter_pixels_to_faces"])
    bench_calls.update(binned_vs_plain_resolve("bench", ndc, faces, 512, gen))
    binned_vs_plain_resolve("S=100", ndc, faces, 100, gen)
    for name in ("resolve_depth", "bin_faces", "resolve_binned_xy", "resolve_binned_latch",
                 "resolve_binned_depth"):
        all_errs[name] = 0.0      # bit-equal, or the checks above raised

    # 12. both routes at all seven configurations, through the entry points
    def sil_resolve(r, v, f):
        with torch.no_grad():
            fvp = gather_face_vertices(r.transform_vertices(v), f)
        size = r.image_size * (2 if r.anti_aliasing else 1)
        return (lambda route: resolve_and_gather(fvp, size, r.near, r.far, True, None, False,
                                                 mode=route),
                (1, size, size, f.shape[0]))

    def tex_resolve(cfg):
        _, fvp, _, attrs = cfg.latch_inputs()
        r = cfg.renderer
        return (lambda route: resolve_and_gather(fvp, cfg.size, r.near, r.far, True, attrs,
                                                 True, mode=route),
                (1, cfg.size, cfg.size, fvp.shape[-1]))

    sil = {"bench": (renderer, torus_v, faces, bench_loss),
           "scale": (scale_renderer, sphere_v, faces6, pattern_loss),
           "hires": (hires, sphere_v, faces6, bench_loss)}
    route_ms, route_rule = {}, {}
    for label in ("bench", "scale", "atlas", "lit", "textured-scale", "hires", "hires-lit"):
        if label in sil:
            r, v, f, loss_fn = sil[label]
            step, fim = sil_step(r, v, f, loss_fn), (lambda r=r, v=v, f=f: index_map(r, v, f, False))
            resolve, shape = sil_resolve(r, v, f)
        else:
            step, fim = cfgs[label].step, cfgs[label].fim
            resolve, shape = tex_resolve(cfgs[label])
        route_ms[label], route_rule[label] = routes_agree(label, step, fim, resolve, shape, smi)

    # the two high-resolution steps, kernels vs plain versions (on the
    # binned route those are K7's pair sort and the bin-by-bin fold)
    steps_vs_plain("hires", sil_step(hires, sphere_v, faces6, bench_loss),
                   lambda: index_map(hires, sphere_v, faces6, False))
    steps_vs_plain("hires-lit", hl.step, hl.fim)

    # the route threshold: both routes' resolve at 512^2 silhouettes of tori
    # between bench's 2.6M and scale's 84M (image, 16x16 tile, face)
    # products, among them the perf matrix's 9K- and 39K-face rows
    # (README.md:119-136; the teapot is not in the repo)
    sweep = {}
    for n_major, n_minor in SWEEP_TORI:
        sv_, sf_ = torus(n_major, n_minor)
        ndc_s, faces_s = ndc_scene(sv_, sf_, dev)
        with torch.no_grad():
            fvp_s = gather_face_vertices(ndc_s, faces_s)
        nf_s = faces_s.shape[0]
        maps_s = {route: resolve_and_gather(fvp_s, 512, 0.1, 100.0, True, mode=route)[0]
                  for route in rc.ROUTES}
        check_equal(f"sweep nf={nf_s} index map, binned vs tiled", maps_s["binned"],
                    maps_s["tiled"])
        with torch.no_grad():
            ms = {route: median_ms(lambda route=route: resolve_and_gather(
                fvp_s, 512, 0.1, 100.0, True, mode=route), 50) for route in rc.ROUTES}
        shape = (1, 512, 512, nf_s)
        sweep[nf_s] = (ms["tiled"], ms["binned"], rc.resolve_route(*shape))
        log(f"[routes] sweep torus({n_major}, {n_minor}) nf={nf_s} at 512^2 "
            f"({nf_s * 1024 / 1e6:.1f}M products): index maps equal; resolve ms tiled "
            f"{ms['tiled']:.4f} binned {ms['binned']:.4f}; the rule picks {sweep[nf_s][2]}, "
            f"measured faster {min(ms, key=ms.get)}  ({smi})")

    # 13. the hires main path: five Adam steps of a vertex fit, icosphere(6)
    # to the torus's silhouette at 1024^2 AA (resolve at 2048^2)
    target = hires.render_silhouettes(torus_v, faces).detach()
    x = sphere_v.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.01)
    fit_faces = faces6.clone()
    losses = []
    torch.cuda.synchronize()
    rc.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        opt.zero_grad()
        loss = torch.sum((hires.render_silhouettes(x, fit_faces) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    hires_launches = dict(rc.LAUNCHES)
    check_one_slot_table("hires fit")
    log(f"[fit] icosphere(6) -> torus silhouette, 1024^2 AA, the rule's route "
        f"{route_rule['hires']}, losses {losses}, {fit_s:.3f} s, launches "
        f"{json.dumps(hires_launches)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"hires fit loss did not fall: {losses}")
    if route_rule["hires"] != "binned" or not all(
            hires_launches[name] > 0 for name in HIRES_KERNELS):
        raise AssertionError(f"the hires fit missed a kernel of its path: {hires_launches}")
    if hires_launches["bin_faces"] != 5 or hires_launches["resolve_binned_xy"] != 5 or \
            hires_launches["resolve_xy"] != 0:
        raise AssertionError(f"the hires fit took the tiled route: {hires_launches}")
    check_k1("hires fit", hires_launches)

    # 14. the hires-lit main path: one step into the vertices and the light
    # colours through Renderer.render
    torch.cuda.synchronize()
    rc.reset_launches()
    images, grads = hl.step()
    torch.cuda.synchronize()
    hl_launches = dict(rc.LAUNCHES)
    log(f"[step] hires-lit, the rule's route {route_rule['hires-lit']}: image mean "
        f"{float(images.mean()):.6f}, max |g| "
        f"{json.dumps({k: float(g.abs().max()) for k, g in grads.items()})}, launches "
        f"{json.dumps(hl_launches)}")
    if not torch.isfinite(images).all() or not all(
            torch.isfinite(g).all() and float(g.abs().max()) > 0 for g in grads.values()):
        raise AssertionError("hires-lit: images or gradients not finite, or all zero")
    if not all(hl_launches[name] > 0 for name in HIRES_LIT_KERNELS) or \
            hl_launches["resolve_latch"] != 0:
        raise AssertionError(f"the hires-lit step missed a kernel of its path: {hl_launches}")
    check_k1("hires-lit step", hl_launches)

    # 15. the id/depth entry: compute_face_index_map at lit (the rule's tiled
    # route) and hires-lit (binned), whole and windowed, and render_depth at
    # hires-lit; the index maps against resolve_and_gather's, made first
    entry = []
    for cfg in (cfgs["lit"], hl):
        with torch.no_grad():
            ndc_c = cfg.renderer.transform_vertices(cfg.vertices)
            entry.append((cfg, ndc_c[:, cfg.faces.long()], cfg.fim()))
    lit_fvp = cfgs["lit"].latch_inputs()[1]
    want_lit_depth = rc.resolve_depth_plain(lit_fvp, True, cfgs["lit"].size, 0.1, 100.0)[1]
    torch.cuda.synchronize()
    rc.reset_launches()
    maps = []
    for cfg, fv, _ in entry:
        S = cfg.size
        maps.append((nr.compute_face_index_map(fv, S, return_depth=True),
                     nr.compute_face_index_map(fv, S, row_start=S // 2, num_rows=S // 4,
                                               return_depth=True)))
    depth_image = hl.renderer.render_depth(hl.vertices, hl.faces)
    torch.cuda.synchronize()
    index_launches = dict(rc.LAUNCHES)
    for (cfg, _, want), ((index, depth), (w_index, w_depth)) in zip(entry, maps):
        S = cfg.size
        check_equal(f"{cfg.name} compute_face_index_map", index, want)
        check_equal(f"{cfg.name} compute_face_index_map window index", w_index,
                    index[:, S // 2:S // 2 + S // 4])
        check_equal(f"{cfg.name} compute_face_index_map window depth", w_depth,
                    depth[:, S // 2:S // 2 + S // 4])
    check_equal("lit compute_face_index_map depth vs plain", maps[0][0][1], want_lit_depth)
    if depth_image.shape != (1, 512, 512) or not torch.isfinite(depth_image).all() or \
            not float(depth_image.max()) > 0:
        raise AssertionError(f"hires-lit render_depth: bad image {tuple(depth_image.shape)}")
    log(f"[index map] compute_face_index_map at lit and hires-lit equal to the resolve's "
        f"index maps (windows too), hires-lit render_depth max {float(depth_image.max()):.4f}; "
        f"launches {json.dumps(index_launches)}")
    if not all(index_launches[name] > 0 for name in INDEX_MAP_KERNELS):
        raise AssertionError(f"the id/depth entry missed a kernel: {index_launches}")
    check_k1("id/depth entry", index_launches)
    # the same calls through the compiled core (out of nr.eager() for it)
    eagerly.__exit__(None, None, None)
    index_cases = [(cfg.name, fv, cfg.size) for cfg, fv, _ in entry]
    index_map_graphed(index_cases, maps)
    eagerly = nr.eager()
    eagerly.__enter__()

    # 16. sharded rendering (parallel/) on ranks that share this card
    sharded, sharded_launches = sharded_runs(dev, smi)

    # 16b. the user-facing path: OBJ I/O, examples 1-5 and the convergence
    # fit through their entry points
    example_launches, _ = examples_phase(dev, smi)

    # 17. K5 and K4 at four meshes and two batch sizes, in turns with their
    # yardsticks, and the host-time split of a wrapper call
    face_vertex_kernels(dev, gen, smi)

    # 18. times
    # per call: the CUDA-event median (what a caller waits, launch gaps
    # included), the kernel's own device time (its mean profiler record
    # times its launches per call), the plain version's and the library
    # call's time
    times = {(SAMPLER_LABEL, name): t for name, t in sampler_times.items()}
    all_calls = [("bench", bench_calls), ("scale", scale_calls)] + list(tex_calls.items()) + [
        ("hires", hires_calls), ("hires-lit", hl_calls)] + list(nmr_calls.items())
    for label, calls in all_calls:
        for name, call in calls.items():
            k_ms = median_ms(call.kernel, 50)
            prof = profile_kept(call.kernel)
            k_dev = kernel_device_ms(prof, name)
            if name == "atlas_taps_grad":
                # its bound counts the gradient written once, which is the
                # wrapper's zero fill: its device time counts every record
                # of the call, the fill's too
                k_dev = call_device_ms(prof)
            p_ms = None
            if (label, name) == ("scale", "resolve_xy"):
                p_ms = host_ms(call.plain)[1]      # one call of seconds
            elif callable(call.plain):
                p_ms = median_ms(call.plain, 10, warmup=1)
            elif call.plain is not None:
                p_ms = call.plain                    # measured once above
            lib_ms = None if call.library is None else median_ms(call.library, 20)
            times[label, name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=call.bound[0],
                                      bound_by=call.bound[1], library_ms=lib_ms,
                                      device_ms=k_dev)

            def fmt(v):
                return "not measured" if v is None else f"{v:.4f} ms"

            log(f"[time] {label} {name}: kernel {k_ms:.4f} ms (device {fmt(k_dev)}), "
                f"plain {fmt(p_ms)}, library {fmt(lib_ms)}, bound {call.bound[0]:.4f} ms by "
                f"{call.bound[1]}  ({smi})")

    steps = [
        ("bench", renderer, sil_step(renderer, torus_v, faces, bench_loss), True),
        ("scale", scale_renderer, sil_step(scale_renderer, sphere_v, faces6, pattern_loss), False),
    ] + [(name, cfg.renderer, cfg.step, name in ("atlas", "lit"))
         for name, cfg in cfgs.items() if name != "hires-lit"] + [
        ("hires", hires, sil_step(hires, sphere_v, faces6, bench_loss), False),
        ("hires-lit", hl.renderer, hl.step, False),
    ]
    for label, r, step, with_plain in steps:
        ms = median_ms(step, 20, warmup=3)
        plain = float("nan")
        if with_plain:
            with rc.plain_versions():
                plain = median_ms(step, 5, warmup=1)
        mpx = r.image_size ** 2 / ms / 1e3
        log(f"[time] {label} fwd+bwd step ({r.image_size}^2, AA {r.anti_aliasing}): "
            f"{ms:.4f} ms = {mpx:.3f} Mpx/s; plain versions {plain:.4f} ms  ({smi})")
        prof = profile_device(step)
        if not prof.busy:
            log(f"[profile] {label}: the profiler saw no device time (not measured)")
        else:
            # with records dropped the kept ones bound the busy time from below
            rel = "=" if prof.complete else ">="
            log(f"[profile] {label} step under torch.profiler: wall {prof.wall:.4f} ms, "
                f"device busy {rel} {prof.busy:.4f} ms ({rel} {100 * prof.busy / ms:.1f}% of "
                f"the unprofiled step) in {rel} {prof.ops:.1f} device operations, "
                + ("every record kept" if prof.complete else
                   f"records dropped: names off a multiple of the calls "
                   f"{prof.dropped}, port kernels {prof.port_records:.1f} records per step "
                   f"against {prof.port_launches:.1f} launches")
                + "; top (per kernel name, kept records summed over the step) "
                + ", ".join(f"{k} {t:.4f} ms" for k, t in prof.top))
    # 19. the kernels the port's slices redesigned: K7 in turns with its
    # parent design at the four binned configurations and a crowded tile
    # (the order pass's bitmap in two windows), K9 in turns with
    # torch.gather at the face-sharded path's two shapes
    with torch.no_grad():
        binned = {}
        for label, (r, v, f) in (("scale", (scale_renderer, sphere_v, faces6)),
                                 ("hires", (hires, sphere_v, faces6))):
            fvp = gather_face_vertices(r.transform_vertices(v), f)
            binned[label] = (fvp, r.image_size * (2 if r.anti_aliasing else 1))
        for label in ("textured-scale", "hires-lit"):
            binned[label] = (cfgs[label].latch_inputs()[1], cfgs[label].size)
        binned["crowded"] = (crowded_fvp(dev), 512)
        redesigned = redesigned_kernels(
            binned, {"scale": scale_calls["gather_rows"],
                     "textured-scale": tex_calls["textured-scale"]["gather_rows"]}, smi)
        # K3 and the resolve forms, in turns with the parent designs
        parent_scatter, parent_tiled, parent_binned = parent_designs()
        design_tiled, design_binned = resolve_designs(dev)
        ts = cfgs["textured-scale"]
        redesigned["scatter_pixels_to_faces"] = scatter_designs({
            "bench": (index_map(renderer, torus_v, faces, False), faces.shape[0], 6),
            "atlas": (cfgs["atlas"].fim(), cfgs["atlas"].faces.shape[0], 15),
            "lit": (cfgs["lit"].fim(), cfgs["lit"].faces.shape[0], 36),
            # K9's transpose on the face-sharded path: one row of P pixels
            "textured-scale K9 transpose": (ts.fim().reshape(1, 1, -1).contiguous(),
                                            ts.faces.shape[0], 27),
        }, parent_scatter, gen, smi)
        # K6 in turns with its designs, its parent and the library call
        redesigned["atlas_taps_grad"] = atlas_grad_designs(
            *atlas_grad_inputs(cfgs["atlas"], gen), smi)
        bench_fvp = rc.gather_faces3(ndc.detach().contiguous(), faces)
        no_attrs = bench_fvp.new_empty((1, faces.shape[0], 0))
        redesigned["tiled_resolve"] = tiled_designs({
            "bench": ("resolve_xy", bench_fvp, no_attrs, 512),
            "atlas": ("resolve_latch", *cfgs["atlas"].latch_inputs()[1::2], cfgs["atlas"].size),
            "lit": ("resolve_latch", *cfgs["lit"].latch_inputs()[1::2], cfgs["lit"].size),
            "bench id/depth": ("resolve_depth", bench_fvp, no_attrs, 512),
            # 81,920 faces: the face stream through every tile dominates
            "scale": ("resolve_xy", rc.gather_faces3(ndc6.detach().contiguous(), faces6),
                      ndc6.new_empty((1, faces6.shape[0], 0)), 512),
        }, parent_tiled, design_tiled, smi)
        # K8, a CTA per bin from the face vertices, in turns with the
        # parent's K8 and chain and the warp-per-bin design
        hl_fvp, hl_attrs = cfgs["hires-lit"].latch_inputs()[1::2]
        hl_size = cfgs["hires-lit"].size
        redesigned["binned_resolve"] = binned_designs({
            "hires": ("xy", binned["hires"][0], no_attrs.new_empty((1, faces6.shape[0], 0)),
                      2048),
            "hires-lit": ("latch", hl_fvp, hl_attrs, hl_size),
            "hires-lit id/depth": ("depth", hl_fvp, hl_attrs[..., :0].contiguous(), hl_size),
            "crowded": ("xy", binned["crowded"][0],
                        no_attrs.new_empty((1, binned["crowded"][0].shape[-1], 0)), 512),
        }, parent_binned, design_binned, smi)
    log("[redesign] " + json.dumps(redesigned))

    eagerly.__exit__(None, None, None)

    # 20. the compiled core: bench, atlas and lit graphed, eager and captured
    # whole by the caller, in turns
    atlas, lit = cfgs["atlas"], cfgs["lit"]
    light_kinds = {"ambient": nr.AmbientLight, "directional": nr.DirectionalLight,
                   "specular": nr.SpecularLight}
    fixed = [(light_kinds[kind], {k: torch.tensor(a, device=dev) for k, a in arrays.items()
                                  if k != "color"})
             for kind, arrays in lit.light_arrays]
    colors = [torch.tensor(arrays["color"], device=dev) for _, arrays in lit.light_arrays]

    def lit_forward(x, *light_colors):
        lights = tuple(cls(color=c, **rest) for (cls, rest), c in zip(fixed, light_colors))
        return lit.renderer.render(x, lit.faces, lit.vt, lit.ft, lit.textures, lights=lights)

    hires_faces = faces6.clone()       # its own faces tensor: one graph over each
    graphs_phase([
        GraphCase("bench", renderer, faces, lambda x: renderer.render_silhouettes(x, faces),
                  [torus_v]),
        GraphCase("atlas", atlas.renderer, atlas.faces,
                  lambda x, t: atlas.renderer.render(x, atlas.faces, atlas.vt, atlas.ft, t),
                  [atlas.vertices, atlas.textures]),
        GraphCase("lit", lit.renderer, lit.faces, lit_forward, [lit.vertices, *colors]),
        GraphCase("scale", scale_renderer, faces6,
                  lambda x: scale_renderer.render_silhouettes(x, faces6), [sphere_v]),
        GraphCase("hires", hires, hires_faces, lambda x: hires.render_silhouettes(x, hires_faces),
                  [sphere_v]),
    ], (scale_renderer, sphere_v, faces6), index_cases, sharded, smi)

    # 21. the measurement modules
    benchmarks_phase(dev, smi)

    # 22. the JAX package's pipeline edge cases on both routes
    edge_launches, _ = edge_phase(dev, smi)

    # 23. the sharded entry across cards, one rank per card over NCCL
    cards_launches = cards_phase(dev, smi)

    log("[routes] resolve ms (tiled, binned) and the rule's route: " + json.dumps(
        {label: [route_ms[label]["tiled"], route_ms[label]["binned"], route_rule[label]]
         for label in route_ms}))
    log("[routes] sweep at 512^2, nf: (tiled ms, binned ms, the rule's route): "
        + json.dumps(sweep))

    launches = collections.Counter()
    for path in (sil_launches, tex_launches, hires_launches, hl_launches, index_launches,
                 sharded_launches, *example_launches.values(), edge_launches, cards_launches):
        launches.update(path)
    log(f"[run] {time.perf_counter() - started:.1f} s, the build included")
    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": all_errs[name], "config": at,
         **times[at, name]}
        for name, (src, replaces, at) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
