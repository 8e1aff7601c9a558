"""The program's side of a single-device cell: the fit step through the
port's facade (``Renderer.render_silhouettes``: camera, render, NMR
backward), the benchmark's 1 - IoU loss and the port's ``utils.optim.Adam``,
in the form the traffic names:

- ``whole``: the caller captures camera, render, loss and backward in one
  CUDA graph and replays it each step; the update runs after the replay.
  The port's Adam keeps its step count on the host, fills its bias
  corrections from host numbers and rebinds its moments each step, so a
  graph cannot hold it: it runs as a user runs it, op by op;
- ``sharded``: one rank of several (``harness.sharded``): the facade's
  camera, then the port's sharded entry over the traffic's (data, tile,
  face) mesh, which replays the rank's own forward and backward graphs
  with its collectives inside; loss, camera VJP and update op by op.

On the CPU (the tests) every form runs op by op with the port's plain
kernels.

``fault`` breaks the timed path underneath, for the tests that see the
comparison catch it (never set by a run): "frozen" (the update returns
the state unchanged), "half_batch" (half of the images left out, the loss
the mean over the rest), "altered" (the first image's silhouette inverted
where it is produced), "no_exchange" (the sharded step's gradient
all-reduce left out; ranks on the CPU).
"""

from __future__ import annotations

import contextlib
import time

import torch

IOU_EPS = 1e-6


def iou_loss(images, targets):
    """mean over images of 1 - sum(s t) / (sum(s + t - s t) + eps)."""
    inter = torch.sum(images * targets, dim=(1, 2))
    union = torch.sum(images + targets - images * targets, dim=(1, 2))
    return torch.mean(1.0 - inter / (union + IOU_EPS))


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
    """One fit on one device: ``params`` [O, nv, 3] (one leaf; each object
    its rows), the renderer, the optimiser and the step in ``form``.
    ``stages``: a dispatch mode (``harness.stages.Stages``) held over the
    capture, for the traced run."""

    def __init__(self, inputs, cfg, form, stages=None, mesh=None, fault=None):
        # (phase, perf_counter at its end) of the fit's set-up
        self.setup_seconds = [("start", time.perf_counter())]
        nr = port()
        self.nr, self.inputs, self.form, self.fault = nr, inputs, form, fault
        if fault == "no_exchange":
            # the eager sharded step's one all-reduce (ranks on the CPU)
            nr.parallel.render.all_reduce_sum = lambda t, group, kind: t
        self.device = inputs["params"].device
        self.leaf = inputs["params"].clone().requires_grad_(True)
        r = nr.Renderer(self.device)
        r.image_size = inputs["image_size"]
        r.anti_aliasing = inputs["anti_aliasing"]
        r.viewing_angle = inputs["viewing_angle"]
        r.viewpoints = inputs["eyes"]
        self.renderer = r
        self.faces = inputs["faces"]
        self.targets = inputs["targets"]
        opt = cfg["optimizer"]
        self.adam = nr.Adam([self.leaf], lr=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"],
                            eps=opt["eps"])
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

    def _views(self, params):
        o, nv = params.shape[:2]
        per = self.inputs["views"]
        return params[:, None].expand(o, per, nv, 3).reshape(o * per, nv, 3)

    def images(self, params):
        """The silhouettes [B, S, S] of ``params`` through the facade (the
        sharded entry behind the facade's camera on a mesh)."""
        if self.mesh is None:
            images = self.renderer.render_silhouettes(self._views(params), self.faces)
        else:
            ndc = self.renderer.transform_vertices(self._views(params))
            images = self.nr.parallel.rasterize_silhouettes_sharded(ndc, self.faces, None,
                                                                    self.hp, mesh=self.mesh)
        if self.fault == "altered":
            images = torch.cat([1.0 - images[:1], images[1:]])
        return images

    def collective_kinds(self):
        """The collectives that each graph this rank keeps holds, forward
        then backward."""
        return [g.inline["forward"] + g.inline["backward"]
                for g in self.nr.ops.graphs.kept_graphs(self.faces) if hasattr(g, "inline")]

    def forward_loss(self):
        images, targets = self.images(self.leaf), self.targets
        if self.fault == "half_batch":
            half = images.shape[0] // 2
            images, targets = images[:half], targets[:half]
        loss = iou_loss(images, targets)
        count_nonfinite(self.nonfinite, loss)
        return loss

    def _capture(self):
        graphs = self.nr.ops.graphs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # warm-up on a side stream, op by op: builds what the port keeps
        # per faces tensor (K4's slot table, the binned route's bin totals)
        with torch.cuda.stream(side), graphs.eager():
            for k in range(2):
                self.leaf.grad = None
                self.forward_loss().backward()
                torch.cuda.synchronize()
                self.setup_seconds.append((f"eager step {k + 1}", time.perf_counter()))
        torch.cuda.current_stream().wait_stream(side)
        self.leaf.grad = None
        self.nonfinite.zero_()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss = self.forward_loss()
            self.loss.backward()
        self.setup_seconds.append(("capture", time.perf_counter()))

    def backward(self):
        """Camera, render, loss and backward: ``leaf.grad`` and ``loss``."""
        if self.graph is not None:
            self.graph.replay()
            return
        self.leaf.grad = None
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

    def first_steps(self, n=3):
        """``n`` steps from the seed's state through the step the window
        runs: dict(params0, losses [n] (device), m1 (Adam's first moment
        after step 1), params (after step n))."""
        params0 = self.leaf.detach().clone()
        losses, m1 = [], None
        for k in range(n):
            self.step()
            losses.append(self.loss.detach().clone())
            if k == 0:
                # an optimiser that took no step holds no moment: zero
                state = self.adam.state.get(self.leaf, {})
                m1 = state["m"].detach().clone() if "m" in state else torch.zeros_like(self.leaf)
        return dict(params0=params0, losses=torch.stack(losses), m1=m1,
                    params=self.leaf.detach().clone())

    def reset(self, inputs):
        """Start again from ``inputs`` (another seed's, the same sizes)
        through the same step: the parameters, cameras and targets copied
        into the tensors the step holds, a fresh optimiser."""
        with torch.no_grad():
            self.leaf.copy_(inputs["params"])
            self.renderer.viewpoints.copy_(inputs["eyes"])
            self.targets.copy_(inputs["targets"])
        if self.graph is None:
            self.leaf.grad = None
        opt = self.adam.defaults
        self.adam = self.nr.Adam([self.leaf], lr=opt["lr"], beta1=opt["beta1"],
                                 beta2=opt["beta2"], eps=opt["eps"])
        self.nonfinite.zero_()

    def drop(self):
        """Free the program's state (graph, leaf, optimiser)."""
        self.graph = self.loss = None
        self.adam = self.leaf = self.renderer = None
