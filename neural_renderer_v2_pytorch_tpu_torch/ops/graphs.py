"""The compiled core: each ``rasterize_*`` call on the card replays a CUDA
graph captured for its hyperparameters and input signature (the
counterpart of the JAX package's ``_jitted_core``, ``ops/rasterize.py``
there, an ``lru_cache`` of ``jax.jit(rasterize_core)`` per hyperparameter
set).

A render is captured where its step makes no host sync: on the card, on
the tiled resolve route (``resolve_cuda.resolve_route``, which reads the
shapes only).  The first call of a signature runs eagerly, so a shape
seen once (a last partial batch) or a mesh rendered once captures
nothing; its second call warms the step up on a side stream, captures a
forward graph and, when an input takes gradients, a backward graph in the
same memory pool, and logs the capture's wall time, the counterpart of
JAX's compile time.  Every later call copies its tensors into the graph's
inputs, replays, and returns copies of the graph's outputs, so each call
gives fresh tensors as a JAX call does.  A render whose graph still waits
on an earlier render's backward (two views of one mesh under one loss)
replays another graph of the signature, captured for it, up to
``MAX_INSTANCES``.

The rest runs eagerly: the same kernels in the same order, not a
fallback.  That is the binned route (K7 reads its pair total back to the
host), the sharded entry (its collectives), ``compute_face_index_map``,
CPU tensors, :func:`eager` and ``resolve_cuda.plain_versions``.  Inside a
capture of the caller's own (a whole optimisation step in a
``torch.cuda.graph``), a render runs its ops straight into that graph, as
a ``jit`` inside a ``jit`` inlines.  A capture or replay that fails
raises; nothing reruns eagerly in its place.

Connectivity (``faces``) is a constant of a graph, as in the JAX package,
whose ``_run`` reads concrete faces: the graphs are kept per faces tensor
(:func:`faces_record`) and leave with it, or with an in-place edit of it.
A fresh faces tensor at every call (``faces.int()`` in the loop) makes
every call a first call, which runs eagerly: hand a fit the same faces
tensor every step.  At most ``MAX_ENTRIES`` signatures over all faces are
kept, least recently used first out; evicting one frees its graphs'
memory pools.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import time
import weakref

import numpy as np
import torch

from . import resolve_cuda

log = logging.getLogger(__name__)

# signatures kept (each with its graphs), over all faces: a few per fit
MAX_ENTRIES = 8
# graphs of one signature: renders whose backwards are pending at once
MAX_INSTANCES = 4

# a module flag and not a ContextVar, as resolve_cuda's routes: autograd
# runs the backward of CUDA tensors on threads of its own
_state = {"eager": False}


@contextlib.contextmanager
def eager():
    """Run every ``rasterize_*`` call eagerly, op by op, as before the
    compiled core (the counterpart of ``jax.disable_jit``): to time the
    eager step, to count a step's kernel launches, or to step through the
    pipeline in a debugger."""
    saved = _state["eager"]
    _state["eager"] = True
    try:
        yield
    finally:
        _state["eager"] = saved


def capturing():
    """True inside a CUDA graph capture on the current stream."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def constant(values, device):
    """Host numbers ``values`` (a sequence, an array or a number) as a
    float32 tensor on ``device``: one copy from the host, or, inside a
    capture (which copies nothing from the host), a fill per number that
    the graph keeps.  Both round each number to float32 as
    ``torch.as_tensor`` does."""
    if not capturing():
        return torch.as_tensor(values, dtype=torch.float32, device=device)
    host = np.asarray(values, dtype=np.float64)
    out = torch.empty(host.shape, dtype=torch.float32, device=device)
    for target, value in zip(out.view(-1), host.ravel().tolist()):
        target.fill_(value)
    return out


def _stamp(t):
    """What tells an in-place edit or another storage of ``t`` apart."""
    return t._version, t.data_ptr(), t.device


class FacesRecord:
    """What the rasterizer keeps for one faces tensor of a caller: its int32
    copy.  Every path renders from it, so K4 builds one vertex -> slot
    table for it, whatever the caller's dtype, and the graphs over it are
    keyed by it."""

    __slots__ = ("ref", "stamp", "faces")

    def __init__(self, ref, stamp, faces):
        self.ref, self.stamp, self.faces = ref, stamp, faces


# id(faces) -> FacesRecord; a record leaves with its tensor
_records = {}
# (FacesRecord, signature) -> [Graph], least recently used first; a
# signature's first call makes its entry with no graph
_entries = collections.OrderedDict()


def faces_record(faces):
    """The :class:`FacesRecord` of ``faces`` [nf, 3] (any integer dtype),
    made anew for another tensor, after an in-place edit or for other
    storage.  A record leaves with its tensor, or with an edit of it, and
    its graphs go with it."""
    key = id(faces)
    stamp = _stamp(faces)
    record = _records.get(key)
    if record is not None and record.ref() is faces:
        if record.stamp == stamp:
            return record
        _drop(record)                        # edited in place, or moved

    def gone(ref, key=key):
        record = _records.get(key)
        if record is not None and record.ref is ref:
            del _records[key]
            _drop(record)

    # a copy and never the caller's tensor, which the record must not keep
    # alive
    copy = faces.detach().to(torch.int32, memory_format=torch.contiguous_format, copy=True)
    record = _records[key] = FacesRecord(weakref.ref(faces, gone), stamp, copy)
    return record


def _drop(record):
    """Forget the graphs over ``record`` (a graph whose backward is still
    to run keeps what it reads until then)."""
    for key in [k for k in _entries if k[0] is record]:
        del _entries[key]


def graph_count():
    """The graphs kept, over all faces."""
    return sum(len(kept) for kept in _entries.values())


def kept_graphs(faces):
    """The graphs kept over ``faces``, oldest signature first."""
    record = faces_record(faces)
    return [g for (r, _), kept in _entries.items() if r is record for g in kept]


@functools.lru_cache(maxsize=256)
def note_eager(reason, *detail):
    """Log once for each (reason, detail) that a render runs eagerly."""
    log.info("eager, %s: %s", reason, " ".join(map(str, detail)))


def route(vertices, faces, hp):
    """How a render of ``vertices`` [bs, nv, 3] over ``faces`` [nf, 3]
    with the hyperparameters ``hp`` runs: "graph" (replay a captured
    graph), "eager", or "inline" (ops into the caller's capture).  Graphs
    only on the card, outside :func:`eager` and ``plain_versions``, and
    where the shapes take the tiled route (:func:`graphable`)."""
    if _state["eager"] or not vertices.is_cuda or resolve_cuda._route["plain"]:
        return "eager"
    if capturing():
        return "inline"
    bs, nf = vertices.shape[0], faces.shape[0]
    if not graphable(bs, nf, hp):
        note_eager("binned route (K7 reads its pair total back to the host)", hp,
                   f"bs={bs} nf={nf}")
        return "eager"
    return "graph"


def graphable(bs, nf, hp):
    """True where ``resolve_cuda.resolve_route`` sends ``bs`` images of
    ``hp`` over ``nf`` faces down the tiled route, whose step makes no host
    sync."""
    size = hp.image_size * (2 if hp.anti_aliasing else 1)
    return resolve_cuda.resolve_route(bs, size, size, nf) == "tiled"


def cached_graph(record, signature, capture, label=""):
    """The graph to replay for ``signature`` over ``record``'s faces: a
    kept one that no pending backward waits on, else one that
    ``capture()`` makes.  None where the call runs eagerly instead, logged
    with ``label``: the signature's first call, or ``MAX_INSTANCES`` kept
    graphs that all wait on a backward."""
    key = (record, signature)
    kept = _entries.get(key)
    if kept is None:
        _entries[key] = []
        while len(_entries) > MAX_ENTRIES:
            _entries.popitem(last=False)
        note_eager("the first call of a signature over a faces tensor (its next call "
                   "over the same tensor captures)", label)
        return None
    _entries.move_to_end(key)
    for graph in kept:
        if not graph.pending():
            return graph
    if len(kept) == MAX_INSTANCES:
        note_eager(f"{MAX_INSTANCES} renders of a signature wait on their backward", label)
        return None
    kept.append(capture())
    return kept[-1]


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graph, *inputs):
        ctx.graph = graph
        ctx.token = graph.waiting = _Pending()
        ctx.generation = graph.replay_forward(inputs)
        return graph.output.clone()

    @staticmethod
    def backward(ctx, grad):
        return (None,) + ctx.graph.replay_backward(grad, ctx.generation, ctx.token)


class _Pending:
    """Held by the autograd node of a replay whose backward has not run."""


class Graph:
    """One captured render: ``fn(*inputs)`` -> one tensor, its forward
    graph and, when ``grad`` and an input requires grad, its backward graph
    in the same pool.  ``inputs`` may hold None (absent inputs); the graph
    keeps its own copies of the others (static buffers, with the callers'
    ``requires_grad``), and keeps ``fn``, which holds what the graph reads
    and nothing else may keep alive (the faces record, and so K4's table).
    ``launches`` counts the kernels each graph holds
    (``resolve_cuda.LAUNCHES`` counted them as they were captured);
    ``seconds`` is the capture's wall time, warm-up included."""

    def __init__(self, fn, inputs, grad, label):
        dev = next(t for t in inputs if t is not None).device
        self.fn = fn
        self.static = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
                       for t in inputs]
        self._targets = [None if t is None else t.detach() for t in self.static]
        self.needs = [i for i, t in enumerate(self.static)
                      if grad and t is not None and t.requires_grad]
        self.generation = 0
        # the _Pending of the replay whose backward is still to run, weakly
        self._waiting = None
        self.launches = {}
        wanted = [self.static[i] for i in self.needs]
        t0 = time.perf_counter()
        # the inputs' card current and a stream of its own, also when
        # another card is current: the kernels launch on the current
        # stream of the card they run on
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # the warm-up builds what the step keeps (K4's table, the
                # pixel grids, the latch limits, the loaded kernels)
                # outside capture
                out = fn(*self.static)
                if wanted:
                    torch.autograd.grad(out, wanted, torch.ones_like(out), allow_unused=True)
            torch.cuda.current_stream().wait_stream(side)
            del out
            self.forward = torch.cuda.CUDAGraph()
            before = dict(resolve_cuda.LAUNCHES)
            with torch.cuda.graph(self.forward, stream=side):
                self.output = fn(*self.static)
            self.launches["forward"] = _since(before)
            self.backward, self.grads = None, ()
            if wanted:
                self.grad_output = torch.empty_like(self.output)
                self.backward = torch.cuda.CUDAGraph()
                before = dict(resolve_cuda.LAUNCHES)
                with torch.cuda.graph(self.backward, pool=self.forward.pool(), stream=side):
                    self.grads = torch.autograd.grad(self.output, wanted, self.grad_output,
                                                     allow_unused=True)
                self.launches["backward"] = _since(before)
        self.seconds = time.perf_counter() - t0
        resolve_cuda.GRAPHS["captures"] += 1
        log.info("captured %s in %.6f s: %s", label, self.seconds,
                 " ".join(f"{k} {v}" for k, v in self.launches.items()))

    @property
    def waiting(self):
        return None if self._waiting is None else self._waiting()

    @waiting.setter
    def waiting(self, token):
        self._waiting = None if token is None else weakref.ref(token)

    def pending(self):
        """True while a replay's saved tensors wait in the graph's buffers
        for a backward that may still run."""
        return self.waiting is not None

    def __call__(self, *inputs):
        """Replay on ``inputs`` (the capture's structure); a fresh output,
        differentiable where the graph has a backward."""
        if self.backward is None:
            self.replay_forward(inputs)
            return self.output.clone()
        return _Replay.apply(self, *inputs)

    def replay_forward(self, inputs):
        with torch.no_grad():
            for target, t in zip(self._targets, inputs):
                if target is not None:
                    target.copy_(t)
        self.forward.replay()
        resolve_cuda.GRAPHS["forward_replays"] += 1
        self.generation += 1
        return self.generation

    def replay_backward(self, grad, generation, token):
        if generation != self.generation:
            raise RuntimeError(
                "rasterize: this render's graph was replayed by a later call after this "
                "render's first backward, and a second backward (retain_graph) would read "
                "the later call's saved tensors; render under "
                "neural_renderer_v2_pytorch_tpu_torch.eager() to take several backwards")
        if self.waiting is token:
            self.waiting = None
        self.grad_output.copy_(grad)
        self.backward.replay()
        resolve_cuda.GRAPHS["backward_replays"] += 1
        out = [None] * len(self.static)
        for i, g in zip(self.needs, self.grads):
            # fresh tensors: AccumulateGrad may adopt one as .grad
            out[i] = None if g is None else g.clone()
        return tuple(out)


def _since(before):
    """The LAUNCHES added since ``before``, by kernel."""
    return {k: n - before[k] for k, n in resolve_cuda.LAUNCHES.items() if n > before[k]}
