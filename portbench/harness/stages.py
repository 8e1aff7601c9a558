"""Where the device time of a captured step goes, stage by stage: while a
step is captured, :class:`Stages` names the stage of each operation from
the innermost function on the Python stack that its tables know, and at
each change of stage puts a marker kernel (``torch.cuda._sleep(0)``) into
the graph.  In a profile of replays the device records between two
markers are the stage's (:func:`stage_ms`).

The tables name the port's functions by qualified name.  A stage whose
function is renamed or fused away gets no operation; its metric then
reads as not measured (None), never 0.
"""

from __future__ import annotations

import collections
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

MARKER = "spin_kernel"
# the program's functions (qualified names) -> stage; the innermost one on
# the stack decides
FORWARD = {
    "look_at": "camera", "look": "camera", "perspective": "camera",
    "_GatherFaceVertices.forward": "face-vertex gather (K5)",
    "_ResolveAndGather.forward": "resolve (K2, or K7 + K8)",
    "channel_map_steps": "weight planes + NMR forward",
    "differentiation": "weight planes + NMR forward",
    "_FlipPool.forward": "flip/pool", "finalize_images": "flip/pool",
}
BACKWARD = {
    "_FlipPool.backward": "pool VJP",
    "_Differentiation.backward": "NMR coordinate gradients",
    "_ResolveAndGather.backward": "pixel -> face scatter (K3)",
    "_GatherFaceVertices.backward": "vertex gradient sum (K4)",
}
# the benchmark's own functions around the program's, by the names that
# every task gives them (``tasks/__init__.py``)
HARNESS = {"views": "camera", "loss": "loss", "count_nonfinite": "loss"}
# a backward operation of PyTorch's own (no known function on the stack)
# belongs to its node's stage where the node is named here, else to the
# stage before it: the loss's VJP first, the camera's after K4
BUILTIN_BACKWARD = {"FlipBackward0": "pool VJP"}
LOSS_VJP, CAMERA_VJP = "loss VJP", "camera VJP"
UPDATE = "update"
K4 = BACKWARD["_GatherFaceVertices.backward"]

# the stages that each per-layer metric reads
CAMERA = ("camera", CAMERA_VJP)
NMR = ("weight planes + NMR forward", "NMR coordinate gradients", "flip/pool", "pool VJP")
RESOLVE = FORWARD["_ResolveAndGather.forward"]

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_dir():
    import neural_renderer_v2_pytorch_tpu_torch as nr

    return os.path.dirname(os.path.abspath(nr.__file__))


def _frame_stage(tables):
    """The stage of the innermost frame that ``tables`` ({directory:
    {qualname: stage}}) name, or None."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        for directory, table in tables:
            stage = table.get(code.co_qualname)
            if stage is not None and code.co_filename.startswith(directory):
                return stage
        frame = frame.f_back
    return None


class Stages(TorchDispatchMode):
    """Names the stage of every operation dispatched while it is on; while
    a CUDA graph is captured, records the stages in order (``captured``)
    and puts a marker kernel into the graph before each."""

    def __init__(self):
        super().__init__()
        port = _port_dir()
        self.forward_tables = ((port, FORWARD), (HERE, HARNESS))
        self.backward_tables = ((port, BACKWARD),)
        self.stage, self.backward_seen, self.capturing = None, False, False
        self.captured = []

    def _stage(self):
        node = torch._C._current_autograd_node()
        if node is None:
            stage = _frame_stage(self.forward_tables)
            if stage is None:
                return self.stage
            self.backward_seen = False
            return stage
        stage = _frame_stage(self.backward_tables) or BUILTIN_BACKWARD.get(node.name())
        if stage is not None:
            self.backward_seen = True
            return stage
        if not self.backward_seen:
            return LOSS_VJP
        if self.stage == K4:
            return CAMERA_VJP
        return self.stage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        if capturing and not self.capturing:
            self.stage = None
        self.capturing = capturing
        stage = self._stage()
        if stage != self.stage:
            self.stage = stage
            if capturing:
                self.captured.append(stage)
                torch.cuda._sleep(0)
        return func(*args, **(kwargs or {}))


def stage_ms(records, labels, steps):
    """{stage: device ms per step} from the device records [(name, start
    us, end us)] of ``steps`` steps, each marked in ``labels``' order (one
    marker before each stage); None where a marker was dropped."""
    records = sorted(records, key=lambda r: r[1])
    markers = sum(1 for r in records if MARKER in r[0])
    if markers != steps * len(labels):
        return None
    ms = collections.Counter()
    k = -1
    for name, start, end in records:
        if MARKER in name:
            k += 1
        elif k >= 0:
            ms[labels[k % len(labels)]] += (end - start) / 1e3 / steps
    return {s: ms[s] for s in dict.fromkeys(labels)}
