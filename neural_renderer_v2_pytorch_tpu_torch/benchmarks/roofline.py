"""Roofline of the port's kernels in the steps they run in (the port's
counterpart of the JAX package's ``benchmarks/roofline.py``).

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.roofline

For each function the silhouette step runs on the card (the face-vertex
gather K5, the resolve K2 or K7 + K8, the pixel -> face scatter K3, the
vertex gradient sum K4) it counts the bytes and operations from the step's
shapes and data: each input byte read once, each output byte written once,
TEST_OPS operations for each (pixel, face) test whose pixel centre lies in
the face's bounding box, and nothing that depends on a kernel's own
schedule (tiles, bins, staging, atomics).  So the count is the same for
any implementation of the function, tiled or binned, kernel or plain
version, and a redesign is judged against the same bound.  The bound is
the larger of the bytes at the card's memory rate and the operations at
its float32 rate (``bound``).

At ``bench`` (``bench.py``'s step) and ``hires`` (81,920 faces at 1024^2
with anti-aliasing, the resolve at 2048^2 on the binned route) it prints,
for each function: the bound and what bounds it, the kernels' device time
inside a replayed whole step (the profiler's records of ten replays of the
caller's graph), the bound's share of it and, where one PyTorch call
computes the same function, that call's device time in a replayed graph of
its own, its inputs prepared outside the graph (``index_add_`` for K3, over the
covered pixels only as K3 adds them, and K4, advanced indexing for K5).  The resolve's row also gives each of its
kernels' device time (K7's three passes and K8 on the binned route).  K9,
which the face-sharded path runs and these steps do not, gets a row of its
own at that path's shapes (``textured-scale``: 158,720 faces at 512^2, 27
planes) against ``torch.gather``, each in a replayed graph over copies of
its inputs that do not fit in L2 together.  K14, the sampler's backward
that the atlas's gradient step runs (``scaling``'s row "atlas
3x1190x1920 256^2 AA, atlas gradients"), gets a row at that step: its
function's bound from the pixels and the anchors the step adds at
(:func:`atlas_sample_vjp_work`), the device time of ``prof``'s stage
``atlas.vjp`` in the replayed whole step (the port's span around the
zero fill and the kernel) and the kernel's own, and the library call's
for the part of its work that one PyTorch call does, K6's adds
(:func:`atlas_taps_library`), in a replayed graph of its own.  A share above 100% is flagged
(``above_bound``) as no valid reading.  The last line is one JSON
object."""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from ..ops import graphs
from ..ops import resolve_cuda as rc
from ..ops.gather_resolve import compute_face_index_map
from ..ops.resolve import pixel_centres
from ..utils.scenes import icosphere, torus
from . import prof, scaling, steps

# H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations of one (pixel, face) test of the resolve: face_candidate's
# bbox compares, three affine weights, two sign products, the depth
# quotient, the near/far and accept compares
TEST_OPS = 30
# the silhouette step's functions in the order it runs them: name -> (the
# kernels (their __global__ names) that implement it on either route, the
# library call that computes the same function)
FUNCTIONS = {
    "face-vertex gather (K5)": (("gather_faces3_kernel",), "advanced indexing"),
    "resolve (K2, or K7 + K8)": (("tiled_kernel", "bin_count_kernel", "bin_fill_kernel",
                                  "bin_order_kernel", "binned_kernel"), None),
    "pixel -> face scatter (K3)": (("scatter_pixels_to_faces_kernel",), "index_add_"),
    "vertex gradient sum (K4)": (("scatter_faces_to_vertices_kernel",), "index_add_"),
}
# the silhouette resolve writes the index and depth planes and the winner's
# six x/y coordinates; the scatter reads their gradient back
SILHOUETTE_PLANES = 8
SILHOUETTE_GRAD_PLANES = 6
# textured-scale: torus(320, 248) at 512^2 without anti-aliasing, and the 27
# planes (9 coordinates, 18 attributes) its face-sharded winner gather reads
K9_SCENE, K9_SIZE, K9_PLANES = (320, 248), 512, 27
K9_COPIES = 4
# replays profiled for each device time
REPLAYS = 10
# profiles taken at most, until one keeps any record (a graph of one
# function)
STAGE_ATTEMPTS = 3


def bound(nbytes, ops):
    """(ms, what bounds it): the larger of moving ``nbytes`` at the HBM rate
    and ``ops`` float32 operations at the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pixel_face_tests(consts, size, row_start=0, rows=None):
    """The (pixel, face) tests this run's data needs: for each face, the
    pixels of the window whose centre lies in its bbox (none for a killed
    face), summed."""
    rows = size if rows is None else rows
    dev = consts.device
    xc = pixel_centres(torch.arange(size), size).to(dev)
    yc = pixel_centres(torch.arange(row_start, row_start + rows), size).to(dev)

    def inside(centres, lo, hi):
        return (torch.searchsorted(centres, hi.contiguous(), right=True)
                - torch.searchsorted(centres, lo.contiguous())).clamp(min=0)

    nx = inside(xc, consts[:, 13], consts[:, 14])
    ny = inside(yc, consts[:, 15], consts[:, 16])
    return int((nx * ny).sum())


def resolve_work(consts, size, out_planes, face_bytes, row_start=0, rows=None):
    """(bytes, operations) of a resolve form: ``face_bytes`` of every face's
    inputs read once (the face vertices, 36 bytes, + 4 A of attributes),
    ``out_planes`` 4-byte planes written once, and TEST_OPS per (pixel,
    face) test of K1's constants ``consts`` [bs, 17, nf]."""
    bs, _, nf = consts.shape
    rows = size if rows is None else rows
    return (bs * nf * face_bytes + 4 * out_planes * bs * rows * size,
            TEST_OPS * pixel_face_tests(consts, size, row_start, rows))


def resolve_bound(consts, size, out_planes, face_bytes, extra_bytes=0, row_start=0,
                  rows=None):
    """Bound of a resolve form (:func:`resolve_work`), plus ``extra_bytes``
    read (the binned forms' bins)."""
    nbytes, ops = resolve_work(consts, size, out_planes, face_bytes, row_start, rows)
    return bound(nbytes + extra_bytes, ops)


def gather_faces3_work(bs, nv, nf):
    """K5: the vertex table and the faces read, the planar face vertices
    written."""
    return 12 * bs * nv + 12 * nf + 36 * bs * nf, 0


def scatter_pixels_work(index, planes, nf):
    """K3 over ``index`` [bs, rows, S]: the index map and the ``planes``
    gradient planes of its covered pixels read, one sum per (face, plane)
    written, one add per covered pixel and plane."""
    covered = int((index >= 0).sum())
    return (4 * index.numel() + 4 * planes * covered + 4 * planes * nf * index.shape[0],
            planes * covered)


def scatter_vertices_work(bs, nv, nf):
    """K4: the face-vertex gradients and the faces read, the vertex
    gradients written, one add per face-vertex coordinate."""
    return 36 * bs * nf + 12 * nf + 12 * bs * nv, 9 * bs * nf


def gather_rows_work(ids, planes):
    """K9 over ``ids`` [bs, P]: the ids, the output and the rows they name,
    each once."""
    named = int(torch.unique(ids[ids >= 0]).numel())
    return 4 * ids.numel() + 4 * ids.numel() * planes + 4 * planes * named, 0


def atlas_taps_work(anchors, num_texels):
    """K6 over ``anchors`` [bs, P] into [bs, 3, T] (T = ``num_texels``):
    the anchors and the 12 gradient planes of the covered pixels (anchors
    in [0, T)) read, the gradient written once; one add per covered pixel
    and plane."""
    covered = int(((anchors >= 0) & (anchors < num_texels)).sum())
    return (4 * anchors.numel() + 48 * covered + 12 * anchors.shape[0] * num_texels,
            12 * covered)


def atlas_sample_vjp_work(anchors, num_texels):
    """K14 over ``anchors`` [bs, P] (-1 on background) into [bs, 3, T]:
    per pixel the index map and RGB's gradient read and the nine depth and
    texel-coordinate gradient planes written (52 bytes); per covered pixel
    its three depths, six texel coordinates and three weights read (48
    bytes); the atlas read once and its gradient written once (12 bytes a
    texel each; the gradient per image).  Operations: K6's adds, one per
    covered pixel and tap channel."""
    covered = int((anchors >= 0).sum())
    bs, P = anchors.shape
    return 52 * bs * P + 48 * covered + 12 * num_texels + 12 * bs * num_texels, 12 * covered


def atlas_sample_inputs(images):
    """(z planes, texel-coordinate planes, atlas, index map, weight planes,
    eps) that the ``shading._AtlasSample`` node in the autograd graph of
    ``images`` saved: the atlas sampler's inputs as the render passed
    them."""
    todo, seen = [images.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_AtlasSampleBackward":
            return (*node.saved_tensors, node.eps)
        todo.extend(next_node for next_node, _ in node.next_functions)
    raise ValueError("no atlas sampler in the graph of these images")


def atlas_taps_inputs(images):
    """(anchors i32 [bs, P], tw, T) that the atlas sampler's backward adds
    its taps at (-1 on background), recomputed from its inputs in the
    graph of ``images`` (:func:`atlas_sample_inputs`)."""
    z, uv, textures, index, weights, eps = atlas_sample_inputs(images)
    with torch.no_grad():
        fg, *_, anchors, _ = rc._atlas_parts(z, uv, textures, index, weights, eps)
    bs, _, th, tw = textures.shape
    marked = torch.where(fg.reshape(bs, -1), anchors[:, 0], -1)
    return marked.to(torch.int32), tw, th * tw


def atlas_taps_library(grad, anchors, tw, num_texels):
    """K6's function as one PyTorch call, for one image: a zero [3, T] and
    one ``index_add_`` of the four taps of the covered pixels, their texels
    (a tap past T dropped, as K6 drops it) and gradients gathered here,
    outside the call.  Returns the call."""
    if anchors.shape[0] != 1:
        raise ValueError(f"one image, got {anchors.shape[0]}")
    T = num_texels
    keep = ((anchors[0] >= 0) & (anchors[0] < T)).nonzero()[:, 0]
    a = anchors[0, keep].long()
    texels = torch.cat([a + k for k in (0, 1, tw, tw + 1)])
    # grad [1, 12, P], tap i's channel c on plane 3 i + c -> [3, 4 covered]
    source = grad[0][:, keep].reshape(4, 3, -1).transpose(0, 1).reshape(3, -1)
    inside = (texels < T).nonzero()[:, 0]
    texels, source = texels[inside], source[:, inside].contiguous()
    return lambda: torch.zeros((3, T), device=grad.device).index_add_(1, texels, source)


def step_work(ndc, faces, size, near=0.1, far=100.0, draw_backside=True):
    """Each function of a silhouette step over NDC vertices ``ndc`` [bs, nv,
    3] and ``faces`` at resolve size ``size``: {name (as FUNCTIONS): (bytes,
    operations)}.  The face constants come from the plain version and the
    index map from ``compute_face_index_map`` (the same bits on every route
    and on the plain versions), so no count depends on which kernel runs."""
    bs, nv = ndc.shape[:2]
    nf = faces.shape[0]
    with torch.no_grad():
        fvp = rc.gather_faces3_plain(ndc.contiguous(), faces)
        consts = rc.face_setup_plain(fvp, draw_backside)
        index = compute_face_index_map(ndc[:, faces.long()], size, near, far, draw_backside)
    return dict(zip(FUNCTIONS, (
        gather_faces3_work(bs, nv, nf),
        resolve_work(consts, size, SILHOUETTE_PLANES, 36),
        scatter_pixels_work(index, SILHOUETTE_GRAD_PLANES, nf),
        scatter_vertices_work(bs, nv, nf),
    )))


def configs(device):
    """name -> ``steps.Silhouettes``: ``bench`` (bench.py's step on its
    mesh) and ``hires`` (icosphere(6), 81,920 faces, at 1024^2 with
    anti-aliasing from azimuth 30: the binned route)."""
    v, f = steps.bench_mesh()
    iv, ifc = icosphere(6)
    return {"bench": steps.Silhouettes(v, f, 256, device=device),
            "hires": steps.Silhouettes(iv, ifc, 1024, azimuths=[30.0], device=device)}


def graphed(calls):
    """``calls`` captured one after another in a CUDA graph of their own
    (after a warm-up of each on a side stream), each output kept until the
    capture ends, so that no two calls write the same memory; returns the
    replay."""
    def run():
        return [call() for call in calls]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return graph.replay


def graph_device_ms(calls, n):
    """Device ms per call of ``calls`` (a list of calls of one function,
    each on inputs of its own) in one graph: every record of ``n``
    replays, over the calls; profiled again, up to STAGE_ATTEMPTS times,
    while the profiler kept no record, then None (not measured)."""
    replay = graphed(calls)
    for _ in range(STAGE_ATTEMPTS):
        ms = steps.call_device_ms(steps.profile_device(replay, n))
        if ms is not None:
            return ms / len(calls)
    return None


def kernels_device_ms(prof):
    """{kernel (its __global__ name): device ms per step}: each of its
    record names' mean record times its records per step rounded (at least
    1), so that a dropped record does not count as time saved."""
    pattern = steps.port_kernel_pattern()
    out = {}
    for key, (per_call, ms) in prof.records.items():
        m = pattern.match(key)
        if m:
            out[m.group(2)] = out.get(m.group(2), 0.0) + ms * max(1, round(per_call))
    return out


def function_device_ms(kernels_ms):
    """{function: the device ms per step of its kernels}, None for a
    function none of whose kernels left a record."""
    out = dict.fromkeys(FUNCTIONS)
    for kernel, ms in kernels_ms.items():
        for name, (kernels, _) in FUNCTIONS.items():
            if kernel in kernels:
                out[name] = (out[name] or 0.0) + ms
    return out


def library_calls(scene, gen):
    """{function: the one PyTorch call that computes it on the step's
    inputs}, the inputs prepared here, outside any graph."""
    with torch.no_grad():
        ndc = scene.camera(scene.values[0]).contiguous()
        index = compute_face_index_map(ndc[:, scene.faces.long()], scene.size)
    bs, nv = ndc.shape[:2]
    nf = scene.faces.shape[0]
    faces_long = scene.faces.long()
    # K3's function over the covered pixels only, as K3 and
    # scatter_pixels_work count it: their (image, face) columns and
    # gradients gathered here (index_add_ does not read the index map)
    image = torch.arange(bs, device=ndc.device)[:, None, None].expand_as(index)
    covered = index >= 0
    pixel_ids = (index + nf * image)[covered].long()
    g = torch.randn((SILHOUETTE_GRAD_PLANES, pixel_ids.numel()), generator=gen,
                    device=ndc.device)
    per_face = torch.zeros((SILHOUETTE_GRAD_PLANES, bs * nf), device=ndc.device)
    g9 = torch.randn((bs, nf * 3, 3), generator=gen, device=ndc.device)
    per_vertex = torch.zeros((bs, nv, 3), device=ndc.device)
    return {
        "face-vertex gather (K5)": lambda: ndc[:, faces_long],
        "pixel -> face scatter (K3)": lambda: per_face.index_add_(1, pixel_ids, g),
        "vertex gradient sum (K4)": lambda: per_vertex.index_add_(1, faces_long.reshape(-1), g9),
    }


def rows(name, scene, n, gen):
    """The roofline rows of ``scene``'s step (:func:`step_work`, the device
    times in a replayed whole step, the library calls')."""
    case = scene.case(name)
    whole = steps.CallerGraph(case)
    prof = steps.profile_device(whole, n, launched=whole.launches)
    kernels_ms = kernels_device_ms(prof)
    device_ms = function_device_ms(kernels_ms)
    with torch.no_grad():
        ndc = scene.camera(scene.values[0])
    work = step_work(ndc, scene.faces, scene.size)
    library = {fn: graph_device_ms([call], n)
               for fn, call in library_calls(scene, gen).items()}
    out = []
    for fn, (nbytes, ops) in work.items():
        ms, by = bound(nbytes, ops)
        dev = device_ms[fn]
        out.append(dict(config=name, function=fn, bytes=nbytes, operations=ops, bound_ms=ms,
                        bound_by=by, device_ms=dev, share=None if not dev else ms / dev,
                        kernels_ms={k: t for k, t in kernels_ms.items() if k in FUNCTIONS[fn][0]},
                        library=FUNCTIONS[fn][1], library_device_ms=library.get(fn),
                        launches=whole.launches, every_record_kept=prof.complete))
    return out


def k9_row(device, n, gen):
    """K9 at the face-sharded path's shapes (``textured-scale``: the index
    map of torus(320, 248) at 512^2 and 27 planes of random rows), K9's
    planar form and ``torch.gather`` each in a replayed graph of its own.
    One call's ids, rows and output (~46 MB) would stay in the card's 50 MB
    L2 from one replay to the next, which a step that does other work
    between two calls does not give: each graph rotates through
    K9_COPIES copies of the inputs (~185 MB in all), so that each call reads
    them from HBM."""
    v, f = torus(*K9_SCENE)
    scene = steps.Silhouettes(v, f, K9_SIZE, anti_aliasing=False, device=device)
    with torch.no_grad():
        ndc = scene.camera(scene.values[0])
        ids = compute_face_index_map(ndc[:, scene.faces.long()], K9_SIZE).reshape(1, -1)
    ids = ids.contiguous()
    tables = [torch.randn((1, f.shape[0], K9_PLANES), generator=gen, device=device)
              for _ in range(K9_COPIES)]
    id_copies = [ids.clone() for _ in range(K9_COPIES)]
    gather_indexes = [i.clamp(min=0).long()[..., None].expand(1, ids.shape[1], K9_PLANES)
                      for i in id_copies]
    steps.check_equal("K9 at textured-scale", rc.gather_rows(tables[0], ids, True),
                      rc.gather_rows_plain(tables[0], ids, True))
    nbytes, ops = gather_rows_work(ids, K9_PLANES)
    ms, by = bound(nbytes, ops)
    dev = graph_device_ms([functools.partial(rc.gather_rows, t, i, True)
                           for t, i in zip(tables, id_copies)], n)
    library = graph_device_ms([functools.partial(torch.gather, t, 1, i)
                               for t, i in zip(tables, gather_indexes)], n)
    return dict(config="textured-scale", function="winner-row gather (K9)", bytes=nbytes,
                operations=ops, bound_ms=ms, bound_by=by, device_ms=dev,
                share=ms / dev if dev else None, kernels_ms=None, library="torch.gather",
                library_device_ms=library)


def k14_row(device, n, gen):
    """K14 in the atlas's gradient step (``prof.ATLAS_ROW``): the bound of
    its function over the step's pixels and anchors; the device ms of
    ``prof``'s stage ``atlas.vjp`` (the port's span around K14 and its zero
    fill) in ``n`` replays of the whole step captured by its caller (not
    measured unless every replay's spans were read), and the kernel's own
    records in that profile; the library call's device time in a replayed
    graph of its own for K6's adds, on random gradients over the same
    anchors (K6 held to its plain version on them)."""
    case = scaling.case(next(r for r in scaling.ROWS if r.label == prof.ATLAS_ROW), device)
    with graphs.eager():
        images = case.forward(*(v.clone().requires_grad_(True) for v in case.values))
    anchors, tw, T = atlas_taps_inputs(images)
    del images
    grad = torch.randn((anchors.shape[0], 12, anchors.shape[1]), generator=gen, device=device)
    steps.check_close("K6 at atlas", rc.atlas_taps_grad(grad, anchors, tw, T),
                      rc.atlas_taps_grad_plain(grad, anchors, tw, T))
    nbytes, ops = atlas_sample_vjp_work(anchors, T)
    ms, by = bound(nbytes, ops)
    times = prof.stage_times(case, n)
    pattern = steps.port_kernel_pattern()
    kernels = {m.group(2): t for k, t in times["kernels"].items()
               if (m := pattern.match(k)) and m.group(2) == "atlas_sample_vjp_kernel"}
    dev = times["stages"].get(prof.ATLAS_STAGE) if times["every_span_read"] else None
    library = graph_device_ms([atlas_taps_library(grad, anchors, tw, T)], n)
    return dict(config="atlas", function=prof.ATLAS_STAGE, bytes=nbytes, operations=ops,
                bound_ms=ms, bound_by=by, device_ms=dev, share=ms / dev if dev else None,
                kernels_ms=kernels if dev else None, library="zeros + index_add_ (K6's adds)",
                library_device_ms=library, launches=times["launches"],
                every_span_read=times["every_span_read"])


def run(device, n=REPLAYS):
    """Every row: bench and hires, then K9 and K14; each printed as it
    comes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    name, power_limit = steps.card()
    out = []
    for label, scene in configs(device).items():
        out += rows(label, scene, n, gen)
    out.append(k9_row(device, n, gen))
    out.append(k14_row(device, n, gen))

    def ms(v):
        return "not measured" if v is None else f"{v:.6f} ms"

    for r in out:
        # faster than the bound: the count or the reading is wrong (the
        # inputs were in L2, a record was lost), not a result
        r["above_bound"] = r["share"] is not None and r["share"] > 1
        share = "not measured" if r["share"] is None else f"{100 * r['share']:.1f}%"
        if r["above_bound"]:
            share += ", ABOVE THE BOUND: not a valid reading"
        print(f"[roofline] {r['config']} {r['function']}: bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']}, device {ms(r['device_ms'])} ({share} of its bound's pace), "
              + (f"{r['library']} {ms(r['library_device_ms'])}" if r["library"] else
                 "no library call")
              + f"  ({name}, {power_limit})", flush=True)
    return dict(module="roofline", device=name, power_limit=power_limit, replays=n, rows=out)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if steps.needs_card("roofline"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
