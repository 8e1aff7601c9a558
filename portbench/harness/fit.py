"""The program's side of a single-device cell: the fit step of the
configuration's task (``tasks/<reference>.py``: its images through the
port's facade and its loss) and the port's ``utils.optim.Adam`` over the
task's leaves, in the form the traffic names:

- ``whole``: the caller captures camera, render, loss and backward in one
  CUDA graph and replays it each step; the update runs after the replay.
  The port's Adam keeps its step count on the host, fills its bias
  corrections from host numbers and rebinds its moments each step, so a
  graph cannot hold it: it runs as a user runs it, op by op;
- ``sharded``: one rank of several (``harness.sharded``): the task's
  images through the port's sharded entry over the traffic's (data, tile,
  face) mesh, which replays the rank's own forward and backward graphs
  with its collectives inside; loss, camera VJP and update op by op.  A
  task whose ``FORMS`` lack it raises.

On the CPU (the tests) every form runs op by op with the port's plain
kernels.

``fault`` breaks the timed path underneath, for the tests that see the
comparison catch it (never set by a run): "frozen" (the update returns
the state unchanged), "half_batch" (half of the images left out, the loss
the mean over the rest), "altered" (the first image inverted, 1 - x,
where it is produced), "no_exchange" (the sharded step's gradient
all-reduce left out; ranks on the CPU).
"""

from __future__ import annotations

import contextlib
import time

import torch

from . import spec


def count_nonfinite(counter, loss):
    """Add 1 to ``counter`` (on the device) when ``loss`` is not finite."""
    counter += (~torch.isfinite(loss)).to(torch.int32)


def port():
    """The program: the PyTorch + CUDA port's package, its sharded entry
    (``parallel``, a subpackage the package does not import) loaded."""
    import neural_renderer_v2_pytorch_tpu_torch as nr
    import neural_renderer_v2_pytorch_tpu_torch.parallel  # noqa: F401

    return nr


class Fit:
    """One fit on one device: the task's leaves (each a float32 tensor [O,
    ...], each object its rows), the renderer, the optimiser and the step
    in ``form``.  ``stages``: a dispatch mode
    (``harness.stages.Stages``) held over the capture, for the traced
    run.  ``task``: the cell's task module (``spec.cell``), by default the
    one ``cfg`` names (``spec.task``)."""

    def __init__(self, inputs, cfg, form, stages=None, mesh=None, fault=None, task=None):
        # (phase, perf_counter at its end) of the fit's set-up
        self.setup_seconds = [("start", time.perf_counter())]
        nr = port()
        self.task = task if task is not None else spec.task(cfg)
        if form not in self.task.FORMS:
            raise ValueError(f"the task {cfg['reference']!r} runs the forms "
                             f"{self.task.FORMS}, not {form!r}")
        self.nr, self.inputs, self.form, self.fault = nr, inputs, form, fault
        if fault == "no_exchange":
            # the eager sharded step's one all-reduce (ranks on the CPU)
            nr.parallel.render.all_reduce_sum = lambda t, group, kind: t
        self.leaves = {n: t.clone().requires_grad_(True) for n, t in inputs["leaves"].items()}
        self.device = next(iter(self.leaves.values())).device
        r = nr.Renderer(self.device)
        r.image_size = inputs["image_size"]
        r.anti_aliasing = inputs["anti_aliasing"]
        r.viewing_angle = inputs["viewing_angle"]
        r.viewpoints = inputs["eyes"]
        self.renderer = r
        self.faces = inputs["faces"]
        self.targets = inputs["targets"]
        self.optimizer = cfg["optimizer"]
        self.adam = self._adam()
        self.setup_seconds.append(("renderer and optimiser", time.perf_counter()))
        self.nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        self.graph, self.loss, self.mesh = None, None, None
        if form == "sharded":
            self.mesh = nr.parallel.make_mesh(mesh["data"], mesh["tile"], mesh["face"])
            self.hp = nr.RasterizeHyperparam(image_size=inputs["image_size"],
                                             anti_aliasing=inputs["anti_aliasing"])
        elif form == "whole" and self.device.type == "cuda":
            with stages if stages is not None else contextlib.nullcontext():
                self._capture()
        elif form != "whole":
            raise ValueError(f"unknown form {form!r}")

    def _adam(self):
        """The port's Adam over the leaves, as the configuration sets it."""
        opt = self.optimizer
        return self.nr.Adam(list(self.leaves.values()), lr=opt["lr"], beta1=opt["beta1"],
                            beta2=opt["beta2"], eps=opt["eps"])

    def images(self, leaves):
        """The task's images of ``leaves`` through the facade."""
        images = self.task.images(self, leaves)
        if self.fault == "altered":
            images = torch.cat([1.0 - images[:1], images[1:]])
        return images

    def collective_kinds(self):
        """The collectives that each graph this rank keeps holds, forward
        then backward."""
        return [g.inline["forward"] + g.inline["backward"]
                for g in self.nr.ops.graphs.kept_graphs(self.faces) if hasattr(g, "inline")]

    def forward_loss(self):
        images, targets = self.images(self.leaves), self.targets
        if self.fault == "half_batch":
            half = images.shape[0] // 2
            images, targets = images[:half], targets[:half]
        loss = self.task.loss(images, targets)
        count_nonfinite(self.nonfinite, loss)
        return loss

    def zero_grad(self):
        for leaf in self.leaves.values():
            leaf.grad = None

    def _capture(self):
        graphs = self.nr.ops.graphs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # warm-up on a side stream, op by op: builds what the port keeps
        # per faces tensor (K4's slot table, the binned route's bin totals)
        with torch.cuda.stream(side), graphs.eager():
            for k in range(2):
                self.zero_grad()
                self.forward_loss().backward()
                torch.cuda.synchronize()
                self.setup_seconds.append((f"eager step {k + 1}", time.perf_counter()))
        torch.cuda.current_stream().wait_stream(side)
        self.zero_grad()
        self.nonfinite.zero_()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss = self.forward_loss()
            self.loss.backward()
        self.setup_seconds.append(("capture", time.perf_counter()))

    def backward(self):
        """Camera, render, loss and backward: each leaf's ``grad`` and
        ``loss``."""
        if self.graph is not None:
            self.graph.replay()
            return
        self.zero_grad()
        self.loss = self.forward_loss()
        self.loss.backward()

    def update(self):
        if self.fault != "frozen":
            self.adam.step()

    def step(self):
        self.backward()
        self.update()

    def parts(self):
        """The step's host calls in order, for timing each on an idle
        device."""
        return [self.backward, self.update]

    def _moment(self, leaf):
        # an optimiser that took no step holds no moment: zero
        state = self.adam.state.get(leaf, {})
        return state["m"].detach().clone() if "m" in state else torch.zeros_like(leaf)

    def first_steps(self, n=3):
        """``n`` steps from the seed's state through the step the window
        runs: dict(params0, losses [n] (device), m1 (Adam's first moment
        after step 1), params (after step n)), each but the losses a dict
        of one tensor a leaf."""
        params0 = {name: leaf.detach().clone() for name, leaf in self.leaves.items()}
        losses, m1 = [], None
        for k in range(n):
            self.step()
            losses.append(self.loss.detach().clone())
            if k == 0:
                m1 = {name: self._moment(leaf) for name, leaf in self.leaves.items()}
        return dict(params0=params0, losses=torch.stack(losses), m1=m1,
                    params={name: leaf.detach().clone() for name, leaf in self.leaves.items()})

    def reset(self, inputs):
        """Start again from ``inputs`` (another seed's, the same sizes)
        through the same step: the leaves and every tensor of the inputs
        copied into the tensors the step holds, a fresh optimiser."""
        with torch.no_grad():
            for name, leaf in self.leaves.items():
                leaf.copy_(inputs["leaves"][name])
            for key, held in self.inputs.items():
                if isinstance(held, torch.Tensor):
                    held.copy_(inputs[key])
        if self.graph is None:
            self.zero_grad()
        self.adam = self._adam()
        self.nonfinite.zero_()

    def drop(self):
        """Free the program's state (graph, leaves, optimiser)."""
        self.graph = self.loss = None
        self.adam = self.leaves = self.renderer = None
