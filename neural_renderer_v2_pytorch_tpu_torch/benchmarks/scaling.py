"""The JAX package's perf matrix on the port (its ``benchmarks/scaling.py``
and the table at ``README.md:119-136``): thirteen rows, each an
optimisation step timed in its three forms on one CUDA card.

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.scaling [--quick]

The rows, on in-repo meshes (the matrix's teapot and loaded model are not
in the repository): ``torus(40, 32)`` (2,560 faces) stands in for the
teapot and ``scenes.atlas_scene``'s seeded 3 x 1190 x 1920 atlas for the
loaded one; the cameras are at distance 2.732, elevation 30 (batched
views at azimuths spread over 360 degrees, as the matrix places them):

- silhouettes at 256^2 with anti-aliasing, batch 1, 8 and 30;
- textured (``create_textures``, texture size 2, seeded texels) at 256^2
  with anti-aliasing, without and with the matrix's three lights;
- the atlas at 256^2 with anti-aliasing: the vertices' step with the atlas
  fixed, and the atlas's step with the vertices fixed (its gradients);
- silhouettes at 512^2 without anti-aliasing on ``torus(40, 32)``
  subdivided 0 to 4 times by ``scenes.subdivide`` (2,560 to 655,360
  faces), and textured at 512^2 on the 163,840 faces of level 3.

Each row is a step of the matrix's kind (``GraphCase``: camera, the render
through ``rasterize_silhouettes`` as ``bench`` calls it, or ``Renderer.
render``, ``bench.py``'s loss, the backward) in three forms,
eager, the graphed core and the whole step captured by its caller; each
form's images must equal the eager step's and its gradients lie within
1e-4 of them.  The forms are timed in turns (eager, core, whole, whole,
core, eager), each a median of 20 CUDA-event steps after 3 warm-up, and
profiled (device busy time and operations per step): ``steps.time_forms``.  A row
gives each form's ms, Mpx/s, busy share and device operations, and the
resolve route its shapes take.  ``--quick`` runs three rows (256^2 batch 1,
163,840 faces, the atlas's gradients).  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from ..models.lights import AmbientLight, DirectionalLight, SpecularLight
from ..models.renderer import Renderer
from ..ops import graphs
from ..ops import resolve_cuda as rc
from ..utils.helpers import create_textures
from ..utils.scenes import atlas_scene, lit_light_arrays, subdivide, torus
from . import steps

TORUS = (40, 32)
BASE_FACES = 2 * TORUS[0] * TORUS[1]
TEXTURE_SIZE = 2

# kind: "silhouette", "textured" (create_textures texels) or "atlas";
# level: subdivisions of the torus; grad: the leaf that takes gradients
Row = collections.namedtuple("Row", "label kind image_size anti_aliasing batch level lights grad")
ROWS = (
    Row("silhouette 256^2 AA bs=1", "silhouette", 256, True, 1, 0, False, "vertices"),
    Row("silhouette 256^2 AA bs=8", "silhouette", 256, True, 8, 0, False, "vertices"),
    Row("silhouette 256^2 AA bs=30", "silhouette", 256, True, 30, 0, False, "vertices"),
    Row("textured ts=2 256^2 AA", "textured", 256, True, 1, 0, False, "vertices"),
    Row("textured ts=2 + 3 lights 256^2 AA", "textured", 256, True, 1, 0, True, "vertices"),
    Row("atlas 3x1190x1920 256^2 AA", "atlas", 256, True, 1, 0, False, "vertices"),
    Row("atlas 3x1190x1920 256^2 AA, atlas gradients", "atlas", 256, True, 1, 0, False,
        "textures"),
    Row("silhouette 512^2 level 0", "silhouette", 512, False, 1, 0, False, "vertices"),
    Row("silhouette 512^2 level 1", "silhouette", 512, False, 1, 1, False, "vertices"),
    Row("silhouette 512^2 level 2", "silhouette", 512, False, 1, 2, False, "vertices"),
    Row("silhouette 512^2 level 3", "silhouette", 512, False, 1, 3, False, "vertices"),
    Row("silhouette 512^2 level 4", "silhouette", 512, False, 1, 4, False, "vertices"),
    Row("textured ts=2 512^2 level 3", "textured", 512, False, 1, 3, False, "vertices"),
)
QUICK = ("silhouette 256^2 AA bs=1", "silhouette 512^2 level 3",
         "atlas 3x1190x1920 256^2 AA, atlas gradients")


def num_faces(row):
    return BASE_FACES * 4 ** row.level


def resolve_size(row):
    return row.image_size * (2 if row.anti_aliasing else 1)


def route(row):
    """The resolve route the row's shapes take."""
    S = resolve_size(row)
    return rc.resolve_route(row.batch, S, S, num_faces(row))


def mesh(level):
    """``torus(40, 32)`` subdivided ``level`` times."""
    v, f = torus(*TORUS)
    for _ in range(level):
        v, f = subdivide(v, f)
    return v, f


def case(row, device, seed=0):
    """The row's GraphCase on ``device``."""
    v, f = mesh(row.level)
    azimuths = np.linspace(0, 360, row.batch, endpoint=False)
    if row.kind == "silhouette":
        return steps.Silhouettes(v, f, row.image_size, row.anti_aliasing, row.batch, azimuths,
                                 device).case(row.label)
    r = Renderer(device)
    r.image_size, r.anti_aliasing = row.image_size, row.anti_aliasing
    r.viewpoints = torch.tensor(steps.eyes(azimuths), device=device)
    vertices = torch.tensor(np.tile(v[None], (row.batch, 1, 1)), device=device)
    faces = torch.tensor(f, device=device)
    if row.kind == "atlas":
        _, _, vt, ft, tex = atlas_scene(*TORUS)
    else:
        vt, ft, tex = (t.numpy() for t in create_textures(len(f), TEXTURE_SIZE, device="cpu"))
        vt, tex = vt[None], np.random.RandomState(seed).rand(*tex.shape).astype(np.float32)[None]
        r.texture_size = TEXTURE_SIZE
    vt, ft, tex = (torch.tensor(a, device=device) for a in (vt, ft, tex))
    lights = None
    if row.lights:
        cls = {"ambient": AmbientLight, "directional": DirectionalLight,
               "specular": SpecularLight}
        lights = [cls[kind](**{k: torch.tensor(a, device=device) for k, a in arrays.items()})
                  for kind, arrays in lit_light_arrays()]
    if row.grad == "textures":
        return steps.GraphCase(row.label, r, faces,
                               lambda t: r.render(vertices, faces, vt, ft, t), [tex])
    return steps.GraphCase(row.label, r, faces,
                           lambda x: r.render(x, faces, vt, ft, tex, lights=lights), [vertices])


def time_row(row, device, card):
    """The checks, the turns and the profiles of one row."""
    c = case(row, device)
    with graphs.eager():
        want = c.step()
    rc.reset_launches()
    for call in ("first (eager)", "capturing", "replaying"):
        steps.check_against(f"{row.label} graphed core, {call} call", c.step(), want)
    graph = steps.case_graph(c)
    whole = steps.CallerGraph(c)
    steps.check_against(f"{row.label} whole step", whole(), want)
    forms = steps.time_forms(c, whole)
    px = row.batch * row.image_size ** 2
    out = dict(label=row.label, batch=row.batch, faces=num_faces(row),
               resolve_size=resolve_size(row), route=route(row), capture_s=graph.seconds,
               caller_capture_s=whole.seconds, bin_capacity=graph.capacities,
               overflow_recaptures=rc.GRAPHS["overflow_recaptures"],
               launches=steps.core_launches(c))
    for name, form in forms.items():
        out[name] = dict(form, mpx_per_s=px / form["ms"] / 1e3)
    print(f"[scaling] {row.label} ({out['faces']} faces), {out['route']} route: eager / core / "
          "whole " + " / ".join(f"{out[n]['ms']:.6f}" for n in forms) + " ms, "
          + " / ".join(f"{out[n]['mpx_per_s']:.3f}" for n in forms) + " Mpx/s; busy "
          + " / ".join("not measured" if out[n]["busy_share"] is None else
                       f"{'=' if out[n]['complete'] else '>='} "
                       f"{100 * out[n]['busy_share']:.1f}%" for n in forms)
          + "; ops " + " / ".join(f"{out[n]['ops']:.1f}" for n in forms)
          + f"  ({card[0]}, {card[1]})", flush=True)
    return out


def run(device, quick=False):
    card = steps.card()
    rows = [r for r in ROWS if not quick or r.label in QUICK]
    return dict(module="scaling", device=card[0], power_limit=card[1], steps=steps.FORM_STEPS,
                rows=[time_row(r, device, card) for r in rows])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="three rows")
    args = parser.parse_args(argv)
    if steps.needs_card("scaling"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0"), args.quick))
    return 0


if __name__ == "__main__":
    sys.exit(main())
