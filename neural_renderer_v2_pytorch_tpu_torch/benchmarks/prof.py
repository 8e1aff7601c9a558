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
(``steps.CallerGraph``) under :class:`Stages`, which names the stage each
operation belongs to from the function that dispatches it and, at every
change of stage, puts a marker kernel (``torch.cuda._sleep(0)``) into the
graph.  Ten replays run under the profiler; the device records between two
markers are the stage's:

- forward: camera, face-vertex gather (K5), resolve (K2, or K7 + K8),
  weight planes + NMR forward, flip/pool, loss;
- backward: loss VJP, pool VJP, NMR coordinate gradients, pixel -> face
  scatter (K3), vertex gradient sum (K4), camera VJP; the atlas's
  gradient (K6: everything ``shading._AtlasTaps.backward`` dispatches,
  and the operations of PyTorch's own that follow it into the atlas's
  ``grad``); then the update.

The atlas's step has no stage of its own for its sampler, whose operations
fall into the stages around it.  It prints each stage's device ms and
records per step, and the markers' own time, which the stages leave out.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import bench, scaling, steps

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the function (its qualified name, in the package) whose call dispatches an
# operation -> the stage; the innermost such frame decides
FORWARD = {
    "look_at": "camera", "look": "camera", "perspective": "camera",
    "_GatherFaceVertices.forward": "face-vertex gather (K5)",
    "_ResolveAndGather.forward": "resolve (K2, or K7 + K8)",
    "channel_map_steps": "weight planes + NMR forward",
    "differentiation": "weight planes + NMR forward",
    "_FlipPool.forward": "flip/pool", "finalize_images": "flip/pool",
    "bench_loss": "loss",
    "update": "update",
}
BACKWARD = {
    "_FlipPool.backward": "pool VJP",
    "_Differentiation.backward": "NMR coordinate gradients",
    "_ResolveAndGather.backward": "pixel -> face scatter (K3)",
    "_GatherFaceVertices.backward": "vertex gradient sum (K4)",
    "_AtlasTaps.backward": "atlas gradient (K6)",
}
# a backward operation of PyTorch's own (no function of the package on the
# stack) belongs to its node's stage where the node is named here (the flip
# without anti-aliasing), else to the stage before it, except the first
# ones (the loss's) and those after K4 (the camera's)
BUILTIN_BACKWARD = {"FlipBackward0": "pool VJP"}
LOSS_VJP, CAMERA_VJP = "loss VJP", "camera VJP"
ATLAS_ROW = "atlas 3x1190x1920 256^2 AA, atlas gradients"
ATLAS_STAGE = BACKWARD["_AtlasTaps.backward"]
MARKER = "spin_kernel"
LEVEL_SIZE, BATCH_SIZE = 512, 256
REPLAYS = 10


def _frame_stage(table):
    """The stage of the innermost frame of the package named in ``table``,
    or None."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        stage = table.get(code.co_qualname)
        if stage is not None and code.co_filename.startswith(PACKAGE):
            return stage
        frame = frame.f_back
    return None


class Stages(TorchDispatchMode):
    """Names the stage of every operation dispatched while it is on
    (``counts``: operations per stage, in order of first use).  While a
    CUDA graph is being captured it records the stages in order
    (``captured``) and puts a marker kernel into the graph before the first
    operation of each."""

    def __init__(self):
        super().__init__()
        self.stage, self.backward_seen, self.capturing = None, False, False
        self.counts = collections.Counter()
        self.captured = []

    def _stage(self):
        node = torch._C._current_autograd_node()
        if node is None:
            stage = _frame_stage(FORWARD)
            if stage is None:
                return self.stage
            if stage != FORWARD["update"]:
                self.backward_seen = False      # the next step's forward
            return stage
        stage = _frame_stage(BACKWARD) or BUILTIN_BACKWARD.get(node.name())
        if stage is not None:
            self.backward_seen = True
            return stage
        if not self.backward_seen:
            return LOSS_VJP
        if self.stage == BACKWARD["_GatherFaceVertices.backward"]:
            return CAMERA_VJP
        return self.stage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        if capturing and not self.capturing:
            self.stage = None                   # the capture's first stage gets a marker
        self.capturing = capturing
        stage = self._stage()
        if stage != self.stage:
            self.stage = stage
            if capturing:
                self.captured.append(stage)
                torch.cuda._sleep(0)
        self.counts[stage] += 1
        return func(*args, **(kwargs or {}))


def stage_ops(case):
    """The stages of one eager whole step of ``case`` (on any device) and
    the operations dispatched in each: {stage: count}, in order."""
    leaves = [v.clone().requires_grad_(True) for v in case.values]
    tagger = Stages()
    with tagger:
        steps.whole_step(case, leaves)
    return dict(tagger.counts)


def stage_times(case, n):
    """The whole step of ``case`` captured under :class:`Stages` and ``n``
    replays profiled: {stage: {ms, records, kernels: {record name: ms}}}
    per step, the markers' ms per step, and whether every marker kept its
    record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tagger = Stages()
    with tagger:
        whole = steps.CallerGraph(case)
    labels = tagger.captured
    whole.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            whole.graph.replay()
        torch.cuda.synchronize()
    records = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    ms, count = collections.Counter(), collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    markers, marker_us, k = 0, 0.0, -1
    for e in records:
        us = e.time_range.end - e.time_range.start
        if MARKER in e.name:
            markers, marker_us, k = markers + 1, marker_us + us, k + 1
        elif k >= 0:
            stage = labels[k % len(labels)]
            ms[stage] += us / 1e3 / n
            count[stage] += 1 / n
            kernels[stage][e.name] += us / 1e3 / n
    stages = {s: dict(ms=ms[s], records=count[s], kernels=dict(kernels[s]))
              for s in dict.fromkeys(labels)}
    return dict(stages=stages, total_ms=sum(ms.values()), marker_ms=marker_us / 1e3 / n,
                every_marker_kept=markers == n * len(labels), launches=whole.launches)


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
        print(f"[prof] {label}: device {t['total_ms']:.6f} ms per step in its stages "
              f"(markers {t['marker_ms']:.6f} ms, left out; every marker kept: "
              f"{t['every_marker_kept']})  ({name}, {power_limit})", flush=True)
        for stage, s in t["stages"].items():
            print("  %-34s %10.6f ms %8.1f records" % (stage, s["ms"], s["records"]), flush=True)
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
