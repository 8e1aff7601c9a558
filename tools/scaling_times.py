#!/usr/bin/env python3
"""Time the port on the silhouette rows of the JAX package's perf-matrix
sweep (``benchmarks/scaling.py``) on one CUDA card, in the compiled core's
three forms.

    python3 tools/scaling_times.py [--steps N] [--out FILE]

Rows, on in-repo meshes (the sweep's teapot is not in the repository):

- batched cameras: ``torus(40, 32)`` (2,560 faces) at 256^2 with
  anti-aliasing (the resolve at 512^2), batch 1, 8 and 30, the cameras at
  distance 2.732, elevation 30 and azimuths spread over 360 degrees, as
  the sweep places them;
- face count: ``torus(40, 32)`` subdivided 0 to 4 times by
  ``scenes.subdivide`` (the sweep's midpoint subdivision: 2,560, 10,240,
  40,960, 163,840 and 655,360 faces) at 512^2 without anti-aliasing,
  batch 1.

A step is camera, ``Renderer.render_silhouettes``, ``bench.py``'s loss and
the backward (``chip_smoke.GraphCase``), in three forms: eager
(``nr.eager()``), the graphed core (each render replays its CUDA graph)
and the whole step captured by its caller (``chip_smoke.CallerGraph``,
with ``bench.py``'s update).  Each form's images are held bit-equal to the
eager step's and its gradients within 1e-4; the forms are timed in turns
(eager, core, whole, whole, core, eager), each a median of ``--steps``
CUDA-event steps after 3 warm-up, and profiled (device busy time and
operations per step).  Each row gives the resolve route the shapes take
(``resolve_cuda.resolve_route``).  The last line of the output is one
JSON object, also written to FILE when given.  Without CUDA the script
fails.
"""

import argparse
import collections
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from neural_renderer_v2_pytorch_tpu_torch.utils.scenes import subdivide  # noqa: E402

TURNS = ("eager", "core", "whole", "whole", "core", "eager")
BATCHES = (1, 8, 30)
SUBDIVISIONS = (0, 1, 2, 3, 4)


def rows(cs, dev):
    """(label, renderer, vertices [bs, nv, 3] on the card, faces on the
    card) of every row."""
    nr = cs.nr
    v, f = cs.torus(40, 32)
    out = []
    for bs in BATCHES:
        r = nr.Renderer(dev)
        r.image_size = 256
        azimuths = np.linspace(0, 360, bs, endpoint=False)
        r.viewpoints = torch.tensor(np.array([nr.get_points_from_angles(2.732, 30, float(a))
                                              for a in azimuths], np.float32), device=dev)
        out.append((f"silhouette 256^2 AA bs={bs} ({f.shape[0]} faces)", r,
                    torch.tensor(np.tile(v[None], (bs, 1, 1)), device=dev),
                    torch.tensor(f, device=dev)))
    sv, sf = v, f
    for level in SUBDIVISIONS:
        if level:
            sv, sf = subdivide(sv, sf)
        r = nr.Renderer(dev)
        r.image_size, r.anti_aliasing = 512, False
        r.viewpoints = nr.get_points_from_angles(2.732, 30, 0)
        out.append((f"silhouette 512^2 bs=1 ({sf.shape[0]} faces)", r,
                    torch.tensor(sv[None], device=dev), torch.tensor(sf, device=dev)))
    return out


def time_row(cs, label, r, vertices, faces, steps, smi):
    nr, rc = cs.nr, cs.rc
    case = cs.GraphCase(label, r, faces, lambda x: r.render_silhouettes(x, faces), [vertices])
    with nr.eager():
        want = case.step()
    rc.reset_launches()
    for call in ("first (eager)", "capturing", "replaying"):
        cs.check_against(f"{label} graphed core, {call} call", case.step(), want)
    graph = cs.case_graph(case)
    held = collections.Counter(graph.launches["forward"])
    held.update(graph.launches.get("backward", {}))
    whole = cs.CallerGraph(case)
    cs.check_against(f"{label} whole step", whole(), want)

    def eager_step():
        with nr.eager():
            return case.step()

    forms = {"eager": (eager_step, None), "core": (case.step, dict(held)),
             "whole": (whole, whole.launches)}
    turns = {name: [] for name in forms}
    for name in TURNS:
        turns[name].append(cs.median_ms(forms[name][0], steps, warmup=3))
    bs, S = vertices.shape[0], r.image_size * (2 if r.anti_aliasing else 1)
    out = dict(label=label, bs=bs, faces=faces.shape[0], resolve_size=S,
               route=rc.resolve_route(bs, S, S, faces.shape[0]),
               capture_s=graph.seconds, caller_capture_s=whole.seconds,
               bin_capacity=graph.capacities, overflow_recaptures=rc.GRAPHS["overflow_recaptures"],
               launches=dict(held))
    for name, (fn, launched) in forms.items():
        prof = cs.profile_device(fn, launched=launched)
        ms = float(np.median(turns[name]))
        out[name] = dict(ms=ms, turns_ms=turns[name], busy_ms=prof.busy,
                         busy_share=prof.busy / ms if prof.busy else None, ops=prof.ops,
                         every_record_kept=prof.complete)
    cs.log(f"[scaling] {label}, {out['route']} route: eager / core / whole "
           + " / ".join(f"{out[n]['ms']:.4f}" for n in forms) + " ms; busy "
           + " / ".join("not measured" if out[n]["busy_ms"] is None else
                        f"{'=' if out[n]['every_record_kept'] else '>='} "
                        f"{out[n]['busy_ms']:.4f}" for n in forms)
           + " ms; ops " + " / ".join(f"{out[n]['ops']:.1f}" for n in forms)
           + f"  ({smi})")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=20, help="timed steps per turn")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("scaling_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cs.cuda_build.build()
    cs.cuda_build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = dict(smi=smi, torch=torch.__version__, steps=args.steps,
                  rows=[time_row(cs, *row, args.steps, smi) for row in rows(cs, dev)])
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
