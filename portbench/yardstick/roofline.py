"""Frozen work counts of the silhouette step's functions and the chip's
peaks: the least time the chip could take for a function, whatever
kernel computes it.

Each input byte is read once and each output byte written once; the
resolve does TEST_OPS float operations for each (pixel, face) test whose
pixel centre lies in the face's bounding box.  Nothing depends on a
kernel's schedule (tiles, bins, staging, atomics), so the count is the
same for the tiled and the binned route and for any later design.  The
bound is the larger of the bytes at the HBM rate and the operations at the
float32 rate.
"""

from __future__ import annotations

import torch

from ..reference import silhouette_fit as ref

# NVIDIA H100 SXM data sheet (dense, no sparsity) at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, f32_ops_per_s=67e12),
}
# float operations of one (pixel, face) test: the bbox compares, three
# affine weights, two sign products, the depth quotient, the near/far and
# accept compares
TEST_OPS = 30
# the silhouette resolve writes the index and depth planes and the
# winner's six screen coordinates; the pixel -> face scatter reads the six
# coordinates' gradient back
SILHOUETTE_PLANES = 8
SILHOUETTE_GRAD_PLANES = 6
# bytes of one face's inputs to the resolve: three vertices of three floats
FACE_BYTES = 36


def peaks(kind):
    """(HBM bytes/s, float32 ops/s) of the card named ``kind``; the H100's
    for a card not in the table."""
    p = PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])
    return p["hbm_bytes_per_s"], p["f32_ops_per_s"]


def bound_ms(nbytes, ops, kind="NVIDIA H100 80GB HBM3"):
    """(ms, "bytes" or "operations"): the larger of moving ``nbytes`` at
    the HBM rate and ``ops`` float32 operations at the peak rate."""
    bw, fl = peaks(kind)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pixel_face_tests(fv, size):
    """(pixel, face) tests of NDC face vertices ``fv`` [B, nf, 3, 3] at
    ``size`` x ``size``: for each face that can win, the pixels whose
    centre lies in its bounding box, summed."""
    with torch.no_grad():
        _, _, det, bbox = ref.face_constants(fv)
        centres = ref.pixel_centres(size, fv.dtype, fv.device)
        valid = torch.abs(det) >= ref.DEGENERATE_EPS
        _, nx = ref.bbox_spans(bbox[0:2], valid, centres)
        _, ny = ref.bbox_spans(bbox[2:4], valid, centres)
        return int((nx * ny).sum())


def resolve_work(bs, nf, size, tests):
    """(bytes, ops) of the silhouette resolve of ``bs`` images over ``nf``
    faces at ``size`` x ``size`` with ``tests`` (pixel, face) tests."""
    return bs * nf * FACE_BYTES + 4 * SILHOUETTE_PLANES * bs * size * size, TEST_OPS * tests


def gather_faces_work(bs, nv, nf):
    """The face-vertex gather (K5): vertices and faces read, the face
    vertices written."""
    return 12 * bs * nv + 12 * nf + 36 * bs * nf, 0


def scatter_pixels_work(bs, nf, pixels, covered):
    """The pixel -> face scatter (K3) over ``pixels`` index-map entries, of
    which ``covered`` are foreground: the index map and the six gradient
    planes of the covered pixels read, one sum per (face, plane) written,
    one add per covered pixel and plane."""
    g = SILHOUETTE_GRAD_PLANES
    return 4 * pixels + 4 * g * covered + 4 * g * nf * bs, g * covered


def scatter_vertices_work(bs, nv, nf):
    """The vertex gradient sum (K4): face-vertex gradients and faces read,
    vertex gradients written, one add per face-vertex coordinate."""
    return 36 * bs * nf + 12 * nf + 12 * bs * nv, 9 * bs * nf


def step_work(ndc, faces, size):
    """{function: (bytes, ops)} of one silhouette step over NDC vertices
    ``ndc`` [B, nv, 3] and ``faces`` [nf, 3] at resolve size ``size``,
    counted from these inputs (the index map from the reference's
    z-buffer)."""
    bs, nv = ndc.shape[:2]
    nf = faces.shape[0]
    with torch.no_grad():
        fv = ndc[:, faces.long()]
        tests = pixel_face_tests(fv, size)
        covered = int((ref.zbuffer(fv, size) >= 0).sum())
    return {
        "gather": gather_faces_work(bs, nv, nf),
        "resolve": resolve_work(bs, nf, size, tests),
        "pixel_scatter": scatter_pixels_work(bs, nf, bs * size * size, covered),
        "vertex_scatter": scatter_vertices_work(bs, nv, nf),
    }
