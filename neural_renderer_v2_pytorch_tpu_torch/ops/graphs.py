"""The compiled core: each ``rasterize_*`` call on the card replays a CUDA
graph captured for its hyperparameters and input signature (the
counterpart of the JAX package's ``_jitted_core``, ``ops/rasterize.py``
there, an ``lru_cache`` of ``jax.jit(rasterize_core)`` per hyperparameter
set).

A render is captured on the card, on either resolve route.  The first
call of a signature runs eagerly, so a shape
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

The binned route (``resolve_cuda.resolve_route``: large meshes, large
canvases, many views) sizes K7's bins on the card.  Eagerly K7 reads its
pair total back to the host; a capture cannot, so it takes K7's capped
form (:func:`bin_faces`), whose capacity is fixed when the graph is
captured: twice the total of the same binning's last eager run (the
warm-up's), rounded up to a power of two.  A bin that does not fit is an
overflow bin, which K8 resolves over every face to the same bits, only
slower.  A replay leaves its overflow count on the card; the graph's next
call reads it where that replay has finished (no sync), and a graph whose
replay overflowed is dropped, logged and captured anew at twice the
capacity (``resolve_cuda.GRAPHS["overflow_recaptures"]``).

Two more entries replay graphs.  ``compute_face_index_map`` (the
JAX package jits it with its sizes, clip planes, rows and ``return_depth``
static) is a forward graph per signature, its binned capacity from the
signature's last eager call (kept on :data:`INDEX_MAPS`).  The sharded
entry (``_jitted_sharded`` there) is a :class:`Chain` per signature and
mesh.  With one rank per card (NCCL) its collectives are captured with
the rest: a rank's step is one forward and one backward graph, the
counterpart of one ``_jitted_sharded`` program.  gloo's go through the
host and cannot be captured (ranks that share a card), so there each
stretch of the rank's work between two of them is a graph of its own,
and a replay runs the graphs in turn with each collective run eagerly
between two.

CPU tensors, :func:`eager` and ``resolve_cuda.plain_versions`` run
eagerly: the same kernels in the same order, not a fallback.  Inside a
capture of the caller's own (a whole optimisation step in a
``torch.cuda.graph``), and inside a graph's own warm-up and capture, a
render runs its ops straight into that graph, as a ``jit`` inside a
``jit`` inlines; a binned render there takes its capacity from the last
eager render of the same faces tensor, image size and rows (the caller's
warm-up), and raises without one.  A capture or replay that fails
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
# the render being run (its FacesRecord) and, while a graph warms up and is
# captured, that Graph; set around a render by rendering()
_render = {"record": None, "graph": None}
# the fewest pair slots a capped binning gets
CAPACITY_FLOOR = 4096
# a capacity that overrides bin_capacity's (tests and chip_smoke.py only)
_forced = {"capacity": None}


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
    copy, and the pair total of each binning of its last eager render on
    the binned route (``bin_totals``, :func:`bin_faces`).
    Every path renders from the copy, so K4 builds one vertex -> slot table
    for it, whatever the caller's dtype, and the graphs over it are keyed
    by it."""

    __slots__ = ("ref", "stamp", "faces", "bin_totals")

    def __init__(self, ref, stamp, faces):
        self.ref, self.stamp, self.faces = ref, stamp, faces
        self.bin_totals = {}


# id(faces) -> FacesRecord; a record leaves with its tensor
_records = {}
# the record of what runs outside a render, so over no faces tensor:
# compute_face_index_map's graphs (its input is face vertices) and the
# totals of the binnings that no render runs
INDEX_MAPS = FacesRecord(None, None, None)
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
    with the hyperparameters ``hp`` runs (or ``compute_face_index_map`` of
    face vertices ``vertices``): "graph" (replay a captured graph),
    "eager", or "inline" (ops into the capture, or the warm-up, that runs
    it: the caller's, or a graph's of this module).  Graphs only on the
    card, outside :func:`eager` and ``plain_versions``, on either resolve
    route."""
    if _state["eager"] or not vertices.is_cuda or resolve_cuda._route["plain"]:
        return "eager"
    if capturing() or _render["graph"] is not None:
        return "inline"
    return "graph"


@contextlib.contextmanager
def rendering(record, graph=None):
    """Run a render over ``record``'s faces (and warm up or capture
    ``graph``): what :func:`bin_faces` keeps and reads."""
    saved = dict(_render)
    _render.update(record=record, graph=graph)
    try:
        yield
    finally:
        _render.update(saved)


@contextlib.contextmanager
def forced_capacity(capacity):
    """Capture every capped binning with ``capacity`` pair slots instead of
    :func:`bin_capacity`'s (``chip_smoke.py`` and the tests only, to make
    overflow bins); a graph recaptured after an overflow still gets at
    least twice its old capacity."""
    saved = _forced["capacity"]
    _forced["capacity"] = capacity
    try:
        yield
    finally:
        _forced["capacity"] = saved


def bin_capacity(total):
    """The pair slots of a capped binning whose last eager run made
    ``total`` pairs: twice that, rounded up to a power of two, at least
    :data:`CAPACITY_FLOOR` (8 bytes a slot: K7's ids and its unsorted fill,
    4 bytes each), so that a mesh that moves a little still fits."""
    if _forced["capacity"] is not None:
        return _forced["capacity"]
    return max(CAPACITY_FLOOR, 1 << (2 * total - 1).bit_length())


def bin_faces(fvp, draw_backside, image_size, row_start=0, num_rows=None):
    """K7's bins (cnt, offsets, ids) for a binned resolve of the render
    being run (:func:`rendering`).  Outside a capture, the exact form,
    which reads its pair total back; the total is kept on the render's
    faces record.  Inside one, the capped form, which reads nothing back,
    at :func:`bin_capacity` of that total (for a graph of the compiled
    core, at least its ``min_capacity``), and the graph keeps the overflow
    word; in a caller's capture K7 still adds its overflow bins to
    :func:`bin_counters`.  Outside a render (``compute_face_index_map``) the totals are
    kept on :data:`INDEX_MAPS`.  Raises inside a capture where no eager run
    of the same binning was kept: a step captured without its warm-up."""
    record, graph = _render["record"] or INDEX_MAPS, _render["graph"]
    # which binning of a render over one faces tensor: the batch and face
    # count, the size and rows (the render's AA and row window), the kill rule
    key = (tuple(fvp.shape), int(image_size), int(row_start), num_rows, bool(draw_backside))
    if not capturing():
        bins = resolve_cuda.bin_faces(fvp, draw_backside, image_size, row_start, num_rows)
        record.bin_totals[key] = bins[2].shape[0]
        return bins
    total = record.bin_totals.get(key)
    if total is None:
        raise RuntimeError(
            "rasterize: a render on the binned route inside a CUDA graph capture sizes its "
            "face bins from an eager run of the same render (faces tensor, batch, image size "
            "and rows), and none was kept: run the step once before capturing it (the "
            "warm-up that torch.cuda.graph needs anyway)")
    capacity = bin_capacity(total)
    if graph is not None:
        capacity = max(capacity, graph.min_capacity)
    *bins, overflow = resolve_cuda.bin_faces(fvp, draw_backside, image_size, row_start,
                                             num_rows, capacity=capacity)
    if graph is not None:
        graph.capacities.append(capacity)
        graph.overflow_words.append(overflow)
    return tuple(bins)


def bin_counters():
    """K7's capped binnings since the start (or ``resolve_cuda.
    reset_launches``), summed over the devices: dict(binnings, pairs (the
    pair totals), slots (the capacities), overflow_bins).  Counted on the
    card by K7 itself at every replay of a graph that holds one, the
    port's graphs and a caller's capture alike, with no sync; this read
    copies the counts to the host once a device: read it after a fit, not
    each step.  Overflow bins > 0 mean a graph's bins outgrew the capacity
    it was captured with: its images stay exact, and K8 resolves each
    overflow bin over every face, slower.  The port recaptures its own
    graphs then; a caller's graph keeps overflowing until the caller
    captures it anew."""
    totals = dict.fromkeys(resolve_cuda.BIN_COUNT_FIELDS, 0)
    for counts in resolve_cuda.BIN_COUNTS.values():
        for field, n in zip(resolve_cuda.BIN_COUNT_FIELDS, counts.tolist()):
            totals[field] += n
    return totals


def cached_graph(record, signature, capture, label=""):
    """The graph to replay for ``signature`` over ``record``'s faces: a
    kept one that no pending backward waits on, else one that
    ``capture(min_capacity=0)`` makes.  None where the call runs eagerly
    instead, logged with ``label``: the signature's first call, or
    ``MAX_INSTANCES`` kept graphs that all wait on a backward.  A kept
    graph whose finished replay had overflow bins is dropped and captured
    anew with twice its capacity."""
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
    for i, graph in enumerate(kept):
        if graph.pending():
            continue
        overflow = graph.overflowed()
        if not overflow:
            return graph
        resolve_cuda.GRAPHS["overflow_recaptures"] += 1
        log.info("%s: its last replay had %d overflow bins at %s pair slots; capturing "
                 "anew at twice that", label, overflow, max(graph.capacities))
        kept[i] = capture(min_capacity=2 * max(graph.capacities))
        return kept[i]
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


def _fresh(output):
    """Copies of a graph's output (a tensor or a tuple of them)."""
    if isinstance(output, tuple):
        return tuple(t.clone() for t in output)
    return output.clone()


class Graph:
    """One captured render: ``fn(*inputs)`` -> one tensor (a tuple of them
    where no backward is captured), its forward graph and, when ``grad``
    and an input requires grad, its backward graph in the same pool.
    ``inputs`` may hold None (absent inputs); the graph
    keeps its own copies of the others (static buffers, with the callers'
    ``requires_grad``), and keeps ``fn``, which holds what the graph reads
    and nothing else may keep alive (the faces record, and so K4's table).
    ``fn`` renders over ``record``'s faces (:func:`rendering`); each binned
    resolve it captures takes K7's capped form with at least
    ``min_capacity`` pair slots (``capacities``), and its overflow word
    (``overflow_words``) is copied to the host after each replay.
    ``launches`` counts the kernels each graph holds
    (``resolve_cuda.LAUNCHES`` counted them as they were captured);
    ``seconds`` is the capture's wall time, warm-up included."""

    def __init__(self, fn, inputs, grad, label, record=None, min_capacity=0):
        dev = next(t for t in inputs if t is not None).device
        self.fn = fn
        self.min_capacity = min_capacity
        self.capacities, self.overflow_words = [], []
        self.static = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
                       for t in inputs]
        self._targets = [None if t is None else t.detach() for t in self.static]
        self.needs = [i for i, t in enumerate(self.static)
                      if grad and t is not None and t.requires_grad]
        self.generation = 0
        # the _Pending of the replay whose backward is still to run, weakly
        self._waiting = None
        self.launches = {}
        self.backward, self.grads = None, ()
        wanted = [self.static[i] for i in self.needs]
        t0 = time.perf_counter()
        # the inputs' card current and a stream of its own, also when
        # another card is current: the kernels launch on the current
        # stream of the card they run on
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            self._capture(side, record, wanted)
        # the replays' overflow counts, on the host once a replay has finished
        self.overflow_host = self.replayed = None
        if self.overflow_words:
            self.overflow_host = torch.zeros(len(self.overflow_words), dtype=torch.int32,
                                             pin_memory=True)
            self.replayed = torch.cuda.Event()
        self.seconds = time.perf_counter() - t0
        resolve_cuda.GRAPHS["captures"] += 1
        log.info("captured %s in %.6f s: %s%s", label, self.seconds,
                 " ".join(f"{k} {v}" for k, v in self.launches.items()),
                 f"; K7 capped at {self.capacities} pair slots" if self.capacities else "")

    def _capture(self, side, record, wanted):
        fn = self.fn
        with torch.cuda.stream(side), rendering(record, self):
            # the warm-up builds what the step keeps (K4's table, the
            # pixel grids, the latch limits, the loaded kernels, the
            # bins' totals) outside capture
            out = fn(*self.static)
            if wanted:
                torch.autograd.grad(out, wanted, torch.ones_like(out), allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        del out
        self.forward = torch.cuda.CUDAGraph()
        before = dict(resolve_cuda.LAUNCHES)
        with torch.cuda.graph(self.forward, stream=side), rendering(record, self):
            self.output = fn(*self.static)
        self.launches["forward"] = _since(before)
        if wanted:
            self.grad_output = torch.empty_like(self.output)
            self.backward = torch.cuda.CUDAGraph()
            before = dict(resolve_cuda.LAUNCHES)
            with torch.cuda.graph(self.backward, pool=self.forward.pool(), stream=side):
                self.grads = torch.autograd.grad(self.output, wanted, self.grad_output,
                                                 allow_unused=True)
            self.launches["backward"] = _since(before)

    def _replay(self, kind):
        """Replay the forward or the backward graph."""
        getattr(self, kind).replay()

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

    def overflowed(self):
        """The overflow bins of the last replay where it has finished (an
        event query and a read of host memory: no sync), else 0.  Its
        result was exact all the same: an overflow bin is only slower."""
        if not self.overflow_words or not self.generation or not self.replayed.query():
            return 0
        return int(self.overflow_host.sum())

    def __call__(self, *inputs):
        """Replay on ``inputs`` (the capture's structure); a fresh output,
        differentiable where the graph has a backward."""
        if self.backward is None:
            self.replay_forward(inputs)
            return _fresh(self.output)
        return _Replay.apply(self, *inputs)

    def replay_forward(self, inputs):
        with torch.no_grad():
            for target, t in zip(self._targets, inputs):
                if target is not None:
                    target.copy_(t)
        self._replay("forward")
        if self.overflow_words:
            for i, word in enumerate(self.overflow_words):
                self.overflow_host[i:i + 1].copy_(word, non_blocking=True)
            self.replayed.record()
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
        self._replay("backward")
        resolve_cuda.GRAPHS["backward_replays"] += 1
        out = [None] * len(self.static)
        for i, g in zip(self.needs, self.grads):
            # fresh tensors: AccumulateGrad may adopt one as .grad
            out[i] = None if g is None else g.clone()
        return tuple(out)


def drive(steps, gather, segment=None, inline=None):
    """Run ``steps`` to its end: a generator that yields the collectives
    its work waits on, each time a list of requests (tensor, process group,
    kind), and is sent their results (``parallel.collectives``).  A list
    over groups of one rank each gets its results at once
    (``collectives.local``, no collective); a list that ``inline(requests)``
    accepts gets ``gather(requests)`` within the stretch of work (a capture
    holds it); any other ends a stretch: ``segment(i)`` (a context, none by
    default) is entered around stretch i, and ``gather(requests)`` gives the
    results between two.  Returns (the generator's value, [(requests,
    results)] of each collective between two stretches)."""
    from ..parallel.collectives import crosses, local

    cuts, results = [], None
    while True:
        with segment(len(cuts)) if segment else contextlib.nullcontext():
            while True:
                try:
                    requests = steps.send(results)
                except StopIteration as stop:
                    return stop.value, cuts
                if not crosses(requests):
                    results = [local(r) for r in requests]
                elif inline is not None and inline(requests):
                    results = gather(requests)
                else:
                    break
        results = gather(requests)
        cuts.append((requests, results))


class Chain(Graph):
    """One captured render whose work waits on collectives (a rank's step
    of the sharded entry, the counterpart of one ``_jitted_sharded``
    program).  ``fn`` is a plan: ``fn.forward(*inputs)`` is a generator
    (:func:`drive`) that returns (output, frame), and ``fn.backward(frame,
    output, grad_output, wanted)`` one that returns the gradients of
    ``wanted``.  The collectives that ``collectives.capturable`` accepts
    (NCCL, one rank per card) are captured where they come (``inline``:
    the kinds each direction holds, counted at each replay), so such a plan
    is one forward and one backward graph.  Any other collective (gloo,
    ranks that share a card) cuts its direction: each stretch between two
    is one CUDA graph (``segments``), all in one memory pool, and a replay
    runs them in turn and each collective eagerly between two, from the
    earlier graph's buffer into a buffer the later graph reads (``cuts``).

    Its warm-up stands zeros in for what each collective would return: a
    rank captures on its own (after an overflow, say), and its warm-up
    must reach no other rank; its capture issues the captured collectives
    without running them, so it reaches none either, and the replay that
    follows runs them as the other ranks' replays do.  The rest is
    :class:`Graph`'s: one output, copied; a backward captured when an input
    takes gradients; K7 capped in any segment."""

    def _capture(self, side, record, wanted):
        from ..parallel.collectives import capturable, stand_ins

        plan = self.fn
        with torch.cuda.stream(side), rendering(record, self):
            (out, frame), _ = drive(plan.forward(*self.static), stand_ins)
            if wanted:
                drive(plan.backward(frame, out, torch.ones_like(out), wanted), stand_ins)
        torch.cuda.current_stream().wait_stream(side)
        del out, frame
        self.pool = torch.cuda.graph_pool_handle()
        self.segments = {"forward": [], "backward": []}
        self.cuts, self.inline = {}, {"forward": [], "backward": []}
        # the kernels of each segment, in order
        self.segment_launches = {"forward": [], "backward": []}
        before = dict(resolve_cuda.LAUNCHES)
        with rendering(record, self):
            (self.output, frame), self.cuts["forward"] = drive(
                plan.forward(*self.static), self._collectives("forward"),
                self._segment("forward", side), capturable)
        self.launches["forward"] = _since(before)
        if wanted:
            self.grad_output = torch.empty_like(self.output)
            before = dict(resolve_cuda.LAUNCHES)
            self.grads, self.cuts["backward"] = drive(
                plan.backward(frame, self.output, self.grad_output, wanted),
                self._collectives("backward"), self._segment("backward", side), capturable)
            self.launches["backward"] = _since(before)
            self.backward = self.segments["backward"]

    def _collectives(self, kind):
        """What :func:`drive` gathers with while ``kind`` is captured: the
        collectives issued into the capture where it holds them, else the
        buffers that a replay's eager collectives fill."""
        from ..parallel.collectives import capturable, captured, gathered_buffers

        def gather(requests):
            if not capturable(requests):
                return gathered_buffers(requests)
            self.inline[kind] += [k for _, _, k in requests]
            return captured(requests)
        return gather

    def _segment(self, kind, side):
        """The context that captures stretch i of ``kind`` into a graph of
        its own in the pool; it counts the kernels it holds."""
        @contextlib.contextmanager
        def segment(i):
            graph = torch.cuda.CUDAGraph()
            before = dict(resolve_cuda.LAUNCHES)
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                yield
            self.segments[kind].append(graph)
            self.segment_launches[kind].append(_since(before))
        return segment

    def _replay(self, kind):
        from ..parallel.collectives import all_gather, count

        cuts = self.cuts[kind]
        for i, graph in enumerate(self.segments[kind]):
            graph.replay()
            if i < len(cuts):
                requests, buffers = cuts[i]
                for (t, group, what), out in zip(requests, buffers):
                    all_gather(t, group, what, out=out)
        count(self.inline[kind])


def _since(before):
    """The LAUNCHES added since ``before``, by kernel."""
    return {k: n - before[k] for k, n in resolve_cuda.LAUNCHES.items() if n > before[k]}
