"""Where the device time of a step goes, stage by stage (the port's
counterpart of the JAX package's ``benchmarks/prof.py``, with
``prof_batch.py`` and ``prof_faces.py`` as options).

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.prof \
        [--batch 1 8 30] [--levels 0 1 2 3 4]

The steps are ``bench``'s (``bench.py``'s silhouette step on its mesh) and
the atlas's gradient step (``scaling``'s row "atlas 3x1190x1920 256^2 AA,
atlas gradients"), and, with ``--batch``, ``torus(40, 32)`` at 256^2 with
anti-aliasing over that many views (azimuths spread over 360 degrees), or,
with ``--levels``, ``torus(40, 32)`` subdivided that many times at 512^2
without anti-aliasing.  Each is captured whole by its caller
(``steps.CallerGraph``) with the port's spans on (``utils/trace.py``),
whose device marks the graph holds; ten replays run under the profiler,
each read by ``trace.sample``.  A stage is a span, named by the port:

- forward: ``camera``, ``gather`` (K5), ``resolve`` (K2, or K7 + K8),
  ``planes`` (weight planes + NMR forward), ``pool``, and the step's
  ``loss`` (``steps.bench_loss``);
- backward: ``loss.vjp``, ``pool.vjp``, ``nmr.grad`` (K12; on the plain
  versions its two passes ``nmr.grad.y`` and ``nmr.grad.x`` inside it),
  ``resolve.vjp`` (K3), ``gather.vjp`` (K4), ``camera.vjp``; the atlas's
  gradient ``atlas.vjp`` (K6 with its zero fill); then the ``update``.

The atlas's step has no stage of its own for its sampler, which runs in
``planes``.  It prints each stage's device ms per step, and the kernels'
device ms per step from the profile.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from ..utils import trace
from . import bench, scaling, steps

ATLAS_ROW = "atlas 3x1190x1920 256^2 AA, atlas gradients"
ATLAS_STAGE = "atlas.vjp"
LEVEL_SIZE, BATCH_SIZE = 512, 256
REPLAYS = 10


def stage_ops(case):
    """The stages of one eager whole step of ``case`` (on any device): {span
    name: spans recorded}, in the order the first of each began."""
    leaves = [v.clone().requires_grad_(True) for v in case.values]
    trace.enable()
    try:
        steps.whole_step(case, leaves)
    finally:
        trace.disable()
    spans = sorted(trace.spans(), key=lambda r: r["start_ns"])
    return dict(collections.Counter(r["name"] for r in spans))


def stage_times(case, n):
    """The whole step of ``case`` captured with the port's spans on and
    ``n`` replays profiled, each read by ``trace.sample``: {stages: {span
    name: device ms per step}, total_ms (the outermost spans'), kernels:
    {record name: device ms per step}, every_span_read, launches}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    try:
        whole = steps.CallerGraph(case)
        trace.clear()                      # the warm-up's eager spans
        whole.graph.replay()
        torch.cuda.synchronize()
        read = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                whole.graph.replay()
                read.append(len(trace.sample()))
        stages = trace.device_ms()
        total = sum(trace.device_ms(outermost=True).values())
    finally:
        trace.disable()
    kernels = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / n
    return dict(stages=stages, total_ms=total,
                kernels=dict(kernels), every_span_read=len(set(read)) == 1 and read[0] > 0,
                launches=whole.launches)


def cases(device, batches=(), levels=()):
    """label -> GraphCase: bench's step, the atlas's gradient step, then
    each batch and each level."""
    out = {"bench": bench.scene(device).case("bench"),
           ATLAS_ROW: scaling.case(next(r for r in scaling.ROWS if r.label == ATLAS_ROW),
                                   device)}
    for bs in batches:
        scene = steps.Silhouettes(*scaling.mesh(0), BATCH_SIZE, batch=bs,
                                  azimuths=np.linspace(0, 360, bs, endpoint=False), device=device)
        out[f"{BATCH_SIZE}^2 AA bs={bs}"] = scene.case(f"bs={bs}")
    for level in levels:
        v, f = scaling.mesh(level)
        scene = steps.Silhouettes(v, f, LEVEL_SIZE, anti_aliasing=False, device=device)
        out[f"{LEVEL_SIZE}^2 {f.shape[0]} faces"] = scene.case(f"level {level}")
    return out


def run(device, batches=(), levels=(), n=REPLAYS):
    name, power_limit = steps.card()
    out = {}
    for label, case in cases(device, batches, levels).items():
        out[label] = t = stage_times(case, n)
        print(f"[prof] {label}: device {t['total_ms']:.6f} ms per step in its outermost "
              f"stages (every span read: {t['every_span_read']})  ({name}, {power_limit})",
              flush=True)
        for stage, ms in t["stages"].items():
            print("  %-34s %10.6f ms" % (stage, ms), flush=True)
    return dict(module="prof", device=name, power_limit=power_limit, replays=n, steps=out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, nargs="*", default=[],
                        help="views at 256^2 AA (prof_batch.py)")
    parser.add_argument("--levels", type=int, nargs="*", default=[],
                        help="subdivision levels at 512^2 (prof_faces.py)")
    args = parser.parse_args(argv)
    if steps.needs_card("prof"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0"), args.batch, args.levels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
