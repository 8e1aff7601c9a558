"""The measured step and its three forms, and the readings every benchmark
module takes (the port's counterpart of what ``bench.py`` and the JAX
package's ``benchmarks/`` share: a jitted step, ``lax.scan`` chains and
``block_until_ready``).

A step is camera, render through a public entry point, ``bench.py``'s
loss and the backward (:class:`GraphCase`).  It runs in three forms:

- eager: under ``nr.eager()``, op by op;
- the graphed core: each render replays its CUDA graph
  (``ops/graphs.py``), camera, loss and backward's rest eager;
- whole: the caller captures camera, render, loss, backward and
  ``bench.py``'s update ``v -= 1e-6 * grad`` in one ``torch.cuda.graph``
  (:class:`CallerGraph`), the counterpart of ``bench.py``'s jitted step.

:func:`time_forms` times and profiles the three forms of a step in turns.

:func:`chained_ms` replays the whole step N and 2N times, each replay
feeding the next, and differences the two CUDA-event times, as
``bench.py`` differences its ``lax.scan`` chains.  :func:`run_chain` is the
same chain run eagerly, on the CPU too.  :func:`profile_device` reads the
profiler's device records of a few calls.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import graphs
from ..ops import resolve_cuda as rc
from ..ops.camera import look_at, perspective
from ..ops.rasterize import RasterizeHyperparam, rasterize_silhouettes
from ..utils import cuda_build, trace
from ..utils.helpers import get_points_from_angles
from ..utils.obj_io import load_obj
from ..utils.scenes import write_torus_obj

UPDATE = 1e-6          # bench.py's update: vertices - 1e-6 * grad
# time_forms: the forms' turns, and each turn's steps after its warm-up
TURNS = ("eager", "core", "whole", "whole", "core", "eager")
FORM_STEPS, FORM_WARMUP = 20, 3
# gradients of a form against the eager step's: K3 and K6 sum with atomics
# in run-dependent order, within the JAX backward's bound
GRAD_RTOL = 1e-4
# the exit status of a module's main() without a card
NO_CARD = 2
# bench.py's camera: distance, elevation, azimuth
DISTANCE, ELEVATION = 2.732, 30.0
VIEWING_ANGLE = 30.0


def bench_loss(images):
    """The headline bench's IoU-style scalar (bench.py), so the full NMR
    backward runs."""
    with trace.span("loss", images):
        loss = torch.sum(images * images) / (torch.sum(images) + 1.0)
    trace.vjp("loss.vjp", loss, images)
    return loss


def update(leaves):
    """bench.py's update of each leaf, in place: ``t -= UPDATE * t.grad``."""
    with torch.no_grad(), trace.span("update"):
        for t in leaves:
            t.sub_(UPDATE * t.grad)


def check_close(name, got, want, rtol=GRAD_RTOL):
    """``got`` within ``rtol`` of ``want``'s largest magnitude; returns the
    largest error."""
    err = float((got - want).abs().max())
    bound = rtol * float(want.abs().max())
    if not err <= bound:
        raise AssertionError(f"{name}: max abs err {err} > {bound} ({rtol} of max)")
    return err


def check_equal(name, got, want):
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} of {got.numel()} elements differ")
    return 0.0


def check_against(label, got, want):
    """Images bit-equal, each gradient within GRAD_RTOL of the largest
    magnitude of its eager counterpart; returns the largest error."""
    (images, grads), (want_images, want_grads) = got, want
    check_equal(f"{label} images", images, want_images)
    errs = [check_close(f"{label} gradient {i}", g, w)
            for i, (g, w) in enumerate(zip(grads, want_grads))]
    return max(errs)


class GraphCase:
    """One step: ``forward(*leaves)`` -> images through the user's entry
    point over ``faces``, for leaves made from ``values`` (the tensors that
    take gradients), under bench.py's loss."""

    def __init__(self, label, renderer, faces, forward, values):
        self.label, self.renderer, self.faces = label, renderer, faces
        self.forward, self.values = forward, values

    def step(self, values=None):
        """Camera + render + loss + backward of fresh leaves: (images,
        [gradient of each value])."""
        leaves = [v.clone().requires_grad_(True) for v in (values or self.values)]
        images = self.forward(*leaves)
        bench_loss(images).backward()
        return images.detach(), [t.grad for t in leaves]


def whole_step(case, leaves):
    """The whole step on ``leaves`` (their grads None): camera, render, loss,
    backward and bench.py's update in place.  Returns (images, loss)."""
    images = case.forward(*leaves)
    loss = bench_loss(images)
    loss.backward()
    update(leaves)
    return images, loss


def run_chain(case, n):
    """``n`` whole steps run eagerly from ``case.values``, each on the
    previous one's updated leaves (the chain that :func:`chained_ms` replays
    on the card): (the leaves' values after, [each step's loss], [each
    step's gradient of each leaf])."""
    leaves = [v.clone().requires_grad_(True) for v in case.values]
    losses, grads = [], []
    for _ in range(n):
        for t in leaves:
            t.grad = None
        _, loss = whole_step(case, leaves)
        losses.append(float(loss.detach()))
        grads.append([t.grad for t in leaves])
    return [t.detach() for t in leaves], losses, grads


class CallerGraph:
    """A GraphCase's whole step captured by its caller in one
    torch.cuda.graph (the counterpart of bench.py's jitted step):
    :func:`whole_step`, the render's ops straight into this graph.
    ``launches``: the kernels it holds."""

    def __init__(self, case):
        self.case = case
        self.leaves = [v.clone().requires_grad_(True) for v in case.values]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # warm-up: builds what the step keeps per faces tensor, eagerly (no
        # graph of the core that the whole step would not use)
        with torch.cuda.stream(side), graphs.eager():
            for _ in range(2):
                for t in self.leaves:
                    t.grad = None
                whole_step(case, self.leaves)
        torch.cuda.current_stream().wait_stream(side)
        for t in self.leaves:
            t.grad = None
        self.graph = torch.cuda.CUDAGraph()
        before = dict(rc.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.images, self.loss = whole_step(case, self.leaves)
        self.seconds = time.perf_counter() - t0
        self.launches = {k: n - before[k] for k, n in rc.LAUNCHES.items() if n > before[k]}

    def reset(self, values=None):
        """The leaves back to ``values`` (the case's by default)."""
        with torch.no_grad():
            for t, v in zip(self.leaves, values or self.case.values):
                t.copy_(v)

    def __call__(self, values=None):
        self.reset(values)
        self.graph.replay()
        return self.images, [t.grad for t in self.leaves]


def _replays_ms(whole, n):
    """``n`` chained replays from the case's values: (their CUDA-event ms,
    the host's ms to enqueue them)."""
    whole.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        whole.graph.replay()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def chained_ms(whole, iters, cycles):
    """bench.py's protocol on the card: each cycle times ``iters`` and
    ``2 * iters`` chained replays of the whole step and takes their
    difference, which cancels the chain's fixed cost; where it drowns in
    noise (under a fifth of the long chain) the long chain's half stands in
    (bench.py:108-115).  Returns (each cycle's ms per step, each cycle's
    host ms per step to enqueue the long chain's replays: where it nears
    the first, the host's graph launches, not the card, set the pace)."""
    _replays_ms(whole, iters)                   # warm
    out, host = [], []
    for _ in range(cycles):
        (t1, _), (t2, h2) = _replays_ms(whole, iters), _replays_ms(whole, 2 * iters)
        d = t2 - t1
        if d < 0.2 * t2:
            d = t2 / 2.0
        out.append(d / iters)
        host.append(h2 / (2 * iters))
    return out, host


def case_graph(case):
    """The one graph kept over ``case.faces``."""
    kept = graphs.kept_graphs(case.faces)
    if len(kept) != 1:
        raise AssertionError(f"{case.label}: {len(kept)} graphs over its faces, want 1")
    return kept[0]


def median_ms(fn, reps, warmup=2):
    """The median CUDA-event ms of ``reps`` calls of ``fn`` after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


class EagerOps(TorchDispatchMode):
    """The operations dispatched while it is on that read or write a
    tensor on a device of ``device_type`` ("cuda" by default), by name:
    ``ops`` those that do work, ``views`` those that only alias their
    input.  In a step whose graphs replay, what stays eager (a replay
    dispatches nothing)."""

    def __init__(self, device_type="cuda"):
        super().__init__()
        self.device_type = device_type
        self.ops, self.views = collections.Counter(), collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in (*args, *(kwargs or {}).values(),
                               *(out if isinstance(out, (tuple, list)) else (out,)))
                   if isinstance(t, torch.Tensor)]
        if any(t.device.type == self.device_type for t in tensors):
            kind = self.views if func.is_view else self.ops
            kind[func.overloadpacket.__name__] += 1
        return out


@functools.cache
def port_kernel_pattern():
    """A regex that matches the profiler names of the port's kernels: the
    ``__global__`` functions of ``csrc/*.cu``, each in an anonymous
    namespace.  Group 2 is the function's name."""
    csrc = cuda_build.CSRC_DIR
    names = set()
    for source in sorted(os.listdir(csrc)):
        if source.endswith(".cu"):
            with open(os.path.join(csrc, source)) as fh:
                names.update(re.findall(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s*(\w+)",
                                        fh.read()))
    if not names:
        raise AssertionError(f"no __global__ kernels found under {csrc}")
    return re.compile(r"^(void )?\(anonymous namespace\)::(" + "|".join(sorted(names)) + r")\b")


Profile = collections.namedtuple(
    "Profile",
    "wall busy complete dropped port_records port_launches per_launch top launched ops "
    "records")


def profile_device(step, n=10, launched=None):
    """Profile ``n`` calls of ``step`` once under torch.profiler.

    The profiler sometimes drops device records (once half of a long
    kernel's, while CUDA events and the host clock agreed), so what it
    returns says what was measured:

    - ``busy``: the kept records' device ms per call, a lower bound of the
      device's busy time, and equal to it when ``complete``: every kernel
      name holds a multiple of ``n`` records (every call launches the same
      ops) and the port's kernels hold as many as ``resolve_cuda.LAUNCHES``
      counted (``port_launches``, all three of K7's kernels);
    - ``per_launch``: each port kernel name's mean record, in ms;
    - ``launched``: the wrappers' launches per call, counted by LAUNCHES,
      or as given (a replayed graph's: ``Graph.launches`` or
      ``CallerGraph.launches``, which LAUNCHES counted at its capture and
      does not count at a replay);
    - ``top``: the six longest kernel names' kept ms per call;
    - ``ops``: the kept device records (kernels, fills, copies) per call;
    - ``dropped``: (name, count, kept ms per call) of each name whose count
      is not a multiple of n;
    - ``records``: each device name's (kept records per call, mean record
      ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    before = dict(rc.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    if launched is None:
        launched = {k: (rc.LAUNCHES[k] - before[k]) / n for k in before
                    if rc.LAUNCHES[k] > before[k]}
    # device-side events only (kernels, copies, fills): a CPU op's entry
    # also carries the device time of what it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kept = {e.key: e.self_device_time_total / n / 1e3 for e in events}
    per_launch, port_records = {}, 0
    for e in events:
        if port_kernel_pattern().match(e.key):
            per_launch[e.key] = e.self_device_time_total / e.count / 1e3
            port_records += e.count
    # K7's one counted launch runs three kernels (count + scan, fill, order)
    port_launches = sum(launched.values()) + 2 * launched.get("bin_faces", 0.0)
    dropped = [(e.key[:50], e.count, round(kept[e.key], 6)) for e in events if e.count % n]
    complete = bool(events) and not dropped and port_records == round(port_launches * n)
    top = sorted(kept.items(), key=lambda kv: -kv[1])[:6]
    return Profile(wall, sum(kept.values()), complete, dropped, port_records / n,
                   port_launches, per_launch, [(k[:60], t) for k, t in top], launched,
                   sum(e.count for e in events) / n,
                   {e.key: (e.count / n, e.self_device_time_total / e.count / 1e3)
                    for e in events})


def kernel_device_ms(prof, name):
    """The device ms per call of wrapper ``name``'s own kernel(s) in a
    profile of calls to it: each of its kernel names' mean record times
    its launches per call as LAUNCHES counted them (K7 has three names, its
    count, fill and order passes, and one count); None when a name has no
    record at all."""
    expected = 3 if name == "bin_faces" else 1
    if len(prof.per_launch) != expected or name not in prof.launched:
        return None
    return sum(prof.per_launch.values()) * prof.launched[name]


def call_device_ms(prof):
    """The device ms per call of every record a profiled call leaves (its
    kernels, fills and copies): each record name's mean record times its
    records per call rounded (at least 1), so that a dropped record does not
    count as time saved; None (not measured) when the profile kept no
    record at all."""
    if not prof.records:
        return None
    return sum(ms * max(1, round(per_call)) for per_call, ms in prof.records.values())


def core_launches(case):
    """The kernels that the graphs kept over ``case.faces`` hold, forward
    and backward, by wrapper."""
    graph = case_graph(case)
    held = collections.Counter(graph.launches["forward"])
    held.update(graph.launches.get("backward", {}))
    return dict(held)


def time_forms(case, whole, reps=FORM_STEPS, warmup=FORM_WARMUP):
    """``case``'s step in its three forms: eager (under ``graphs.eager()``),
    the graphed core (``case.step``, which captures its graph in the first
    turn unless it has been captured before) and ``whole`` (its :class:`CallerGraph`).  Each form is timed in TURNS, a
    turn the :func:`median_ms` of ``reps`` steps after ``warmup``, then
    profiled (:func:`profile_device`, the core's and the whole step's
    kernels as their graphs hold them).  Returns {form: dict(turns_ms, ms
    (the turns' median), busy_ms, busy_share, ops, complete)}."""
    def eager_step():
        with graphs.eager():
            return case.step()

    calls = {"eager": eager_step, "core": case.step, "whole": whole}
    turns = {name: [] for name in calls}
    for name in TURNS:
        turns[name].append(median_ms(calls[name], reps, warmup))
    launched = {"eager": None, "core": core_launches(case), "whole": whole.launches}
    out = {}
    for name, call in calls.items():
        prof = profile_device(call, launched=launched[name])
        ms = float(np.median(turns[name]))
        out[name] = dict(turns_ms=turns[name], ms=ms, busy_ms=prof.busy,
                         busy_share=prof.busy / ms if prof.busy else None, ops=prof.ops,
                         complete=prof.complete)
    return out


def card():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, power_limit = (part.strip() for part in out.rsplit(",", 1))
    return name, power_limit


def needs_card(prog):
    """True, after one line saying so, when no CUDA card is available."""
    if torch.cuda.is_available():
        return False
    print(f"{prog}: needs a CUDA card and none is available; nothing was timed", flush=True)
    return True


def build_kernels():
    """Build (or find) and load the kernel library; returns the build's
    seconds (0 for a cached build)."""
    _, seconds, _ = cuda_build.build()
    cuda_build.load()
    return seconds


def emit(result):
    """Print ``result`` as one JSON line."""
    print(json.dumps(result), flush=True)


def bench_mesh(obj=None):
    """(vertices f32 [nv, 3], faces i32 [nf, 3]) as numpy: the OBJ at
    ``obj`` through ``load_obj``, or, without one, the ``torus(40, 32)``
    OBJ of quads that ``scenes.write_example_data`` writes (2,560 faces
    once fan-triangulated, for the reference teapot's 2,464, which the
    repository does not ship)."""
    if obj is not None:
        v, f = load_obj(obj, device="cpu")
        return v.numpy(), f.numpy()
    with tempfile.TemporaryDirectory() as directory:
        path = os.path.join(directory, "torus.obj")
        write_torus_obj(path, 40, 32)
        v, f = load_obj(path, device="cpu")
    return v.numpy(), f.numpy()


def eyes(azimuths):
    """bench.py's cameras at ``azimuths`` (degrees): [len, 3] float32."""
    return np.array([get_points_from_angles(DISTANCE, ELEVATION, float(a)) for a in azimuths],
                    np.float32)


class Silhouettes:
    """A silhouette step's inputs on ``device``: ``vertices`` [nv, 3]
    repeated over ``batch`` images, ``faces``, the camera of bench.py
    (one eye for every image, as bench.py places it) or one at each of
    ``azimuths``, and the hyperparameters.  ``forward(x)`` is bench.py's:
    ``look_at`` + ``perspective(angle=30)`` + ``rasterize_silhouettes``."""

    def __init__(self, vertices, faces, image_size, anti_aliasing=True, batch=1, azimuths=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.values = [torch.tensor(np.tile(np.asarray(vertices, np.float32)[None],
                                            (batch, 1, 1)), device=device)]
        self.faces = torch.tensor(np.asarray(faces, np.int32), device=device)
        self.eye = torch.tensor(eyes([0.0] if azimuths is None else azimuths)[
            0 if azimuths is None else slice(None)], device=device)
        self.hp = RasterizeHyperparam(image_size=image_size, anti_aliasing=anti_aliasing)
        self.size = image_size * (2 if anti_aliasing else 1)

    def camera(self, x):
        return perspective(look_at(x, self.eye), angle=VIEWING_ANGLE)

    def forward(self, x):
        return rasterize_silhouettes(self.camera(x), self.faces, None, self.hp)

    def case(self, label):
        return GraphCase(label, None, self.faces, self.forward, self.values)
