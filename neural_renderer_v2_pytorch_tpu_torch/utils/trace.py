"""Spans and counters inside the port: where a step's time goes, named by
the port itself at the boundaries of its layers.

    from neural_renderer_v2_pytorch_tpu_torch.utils import trace

    trace.enable()
    ...                  # steps (eager, the port's graphs, a caller's graph)
    trace.sample()       # after each replay whose captured spans are to be read
    out = trace.collect()

Tracing is off by default.  Off, :func:`span` returns one shared null
context and :func:`vjp` returns at once: nothing is recorded or allocated,
and a CUDA graph captured then holds exactly the kernels it would hold
without this module.

On, each span records its name, its parent (the innermost span open when
it began), its step and its host start and end as Unix-epoch nanoseconds
(``time.time_ns``), the clock of the profiler's events (Kineto converts
its approximate clock to the epoch), so a span can be laid over a
``torch.profiler`` trace.  A span over CUDA tensors also puts a device
mark at its entry and exit into the current stream: an external timing
event (``torch.cuda.Event(enable_timing=True, external=True)``), which a
CUDA graph being captured records as a node and which launches no kernel.
A span recorded eagerly is read once, by :func:`collect`; a span captured
in a graph is read by the next :func:`sample` after each replay of its
graph, as that replay left it, and not again until the graph replays
(nor ever, once the graph is dropped).  Each span's device ms a step is
the time between its own two marks (its kernels and the gaps between
them), read by its name, never from the order of other marks.

The spans (layer in brackets):

- ``camera`` and ``camera.vjp`` (``ops/camera.py``: look_at, look,
  perspective; camera);
- ``gather`` (K5) and ``gather.vjp`` (K4); ``resolve`` (K2, or K7 + K8)
  and ``resolve.vjp`` (K3) (resolve route);
- ``planes`` (the weight planes, the maps and the NMR forward) and
  ``planes.vjp`` (the maps' backward down to the resolve's outputs),
  ``nmr.grad`` (the NMR backward's coordinate gradients) with its two
  passes ``nmr.grad.y`` and ``nmr.grad.x``, ``pool`` and ``pool.vjp``
  (pipeline and NMR);
- ``sample`` (the texture sampler: the loaded atlas's or the
  ``create_textures`` texel patch's) and ``sample.vjp`` (its backward from
  the RGB down to the texel coordinates, depths and atlas), which holds
  ``atlas.vjp`` (K6 and its zero fill) (texture sampler), inside
  ``planes`` and ``planes.vjp``;
- ``lights`` and ``lights.vjp``, each two intervals: the smoothed vertex
  normals (``face_vertex_normals``: cross products and the segment sum,
  before the resolve) and, inside ``planes``, the light table and the
  per-pixel normals, colour weight and shading (``shade_planes``: K15, and
  K16 in ``lights.vjp``) (lights);
- on the host only: ``update`` (``utils/optim.py``'s ``Adam.step``).

A backward span that no autograd Function of the port holds (``camera.vjp``,
``planes.vjp``, ``pool.vjp``, ``sample.vjp``, ``lights.vjp``) is opened
and closed by autograd hooks (:func:`vjp`): opened when the backward of
the node that made the forward's output begins, closed when the
gradients of its inputs are ready.  An input's gradient is marked ready
when autograd runs the node that made the input, which it reaches in
the reverse of the order the forward made its nodes; so a span's inputs
are the tensors it makes first from its arguments (views), and the
span closes as its own backward ends.  Spans that begin at one node
open outermost first: the one registered last, as an enclosing forward
registers its span after those of the forwards inside it (``planes.vjp``
before ``lights.vjp`` where the lit RGB is the whole image).  The hooks
go with the forward's graph: once no node of it is left, the hooks on its
inputs are removed (a leaf, such as a fitted parameter, keeps none from
one step to the next).  A hook dispatches no operation in the forward,
so a dispatch mode sees the same operations whether tracing is on or
off.

The step of a span: the count of ``update`` spans finished when it began
(Adam's step count); of a captured span's reading, the number of the
:func:`sample` that read it (one per replay read).

:func:`counters` gathers the port's counters, which are always on:
``resolve_cuda.LAUNCHES``, ``GRAPHS``, ``SLOT_TABLE_BUILDS``, K7's capped
binnings (``graphs.bin_counters``, kept on the card) and, where the
sharded entry is loaded, ``parallel.collectives.COLLECTIVES``.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
import weakref

import torch

UPDATE = "update"
# the spans of each layer whose device ms the stage metrics sum
CAMERA = ("camera", "camera.vjp")
NMR = ("planes", "planes.vjp", "nmr.grad", "pool", "pool.vjp")
RESOLVE = ("resolve",)
SAMPLE = ("sample", "sample.vjp")
LIGHTS = ("lights", "lights.vjp")
# the key of a node's ``metadata`` that holds the begin hooks of the
# backward spans that open at it, in the order they were registered
_BEGIN = "trace.vjp"

# a module dict and not a ContextVar, as resolve_cuda's routes: autograd
# runs the backward of CUDA tensors (and so the backward spans) on threads
# of its own
_state = {"on": False, "step": 0, "samples": 0}
# the open spans, oldest first (a backward span closes out of order)
_open = []
# finished spans (dicts), in the order they finished
_spans = []
# (record, start event, end event, device) of spans marked outside a
# capture, unread
_eager = []
# (record, start event, end event, device) of spans marked inside a capture: read at
# each sample(); kept as long as the module is (a graph's event nodes need
# their events), those of graphs captured before the last enable() unread
_captured = []
_retired = []
# per CUDA device, a plain timing event recorded once the card had run all
# it was given (by sample(), or before the first span marked there): a
# captured span that began before it has not replayed since, and is not read
_since = {}
# (name, parent, step key, device ms) of every device reading
_readings = []

_NULL = contextlib.nullcontext()


def enable():
    """Switch tracing on, from an empty record (the spans of graphs
    captured before this call are not read again)."""
    clear()
    _retired.extend(_captured)
    _captured.clear()
    _since.clear()
    _state["on"] = True


def disable():
    """Switch tracing off; what was recorded stays for :func:`collect`."""
    _state["on"] = False


def clear():
    """Drop what was recorded (spans, readings); spans captured in graphs
    stay to be read by the next :func:`sample`."""
    _open.clear()
    _spans.clear()
    _eager.clear()
    _readings.clear()
    _state["step"] = _state["samples"] = 0


def _cuda_device(like):
    """The CUDA device of ``like`` (a tensor or a device), else None."""
    if isinstance(like, torch.Tensor):
        return like.device if like.is_cuda else None
    if like is not None and torch.device(like).type == "cuda":
        return torch.device(like)
    return None


def _mark(device, external=True):
    """A timing event recorded now on ``device``'s current stream: an
    external one is a node of the graph being captured there, if any."""
    event = torch.cuda.Event(enable_timing=True, external=external)
    event.record(torch.cuda.current_stream(device))
    return event


def _begin(name, like=None, step=None):
    record = dict(name=name, parent=_open[-1]["name"] if _open else None,
                  step=_state["step"] if step is None else step, start_ns=time.time_ns(),
                  end_ns=None, captured=False)
    device = _cuda_device(like)
    if device is not None:
        record["captured"] = torch.cuda.is_current_stream_capturing()
        if device not in _since and not record["captured"]:
            _since[device] = _mark(device, external=False)
        record["_device"] = device
        record["_start"] = _mark(device)
    _open.append(record)
    return record


def _end(record):
    device = record.pop("_device", None)
    if device is not None:
        marks = (record, record.pop("_start"), _mark(device), device)
        (_captured if record["captured"] else _eager).append(marks)
    record["end_ns"] = time.time_ns()
    for i, r in enumerate(_open):
        if r is record:
            del _open[i]
            break
    _spans.append(record)
    if record["name"] == UPDATE:
        _state["step"] = record["step"] + 1


class _Span:
    __slots__ = ("name", "like", "step", "record")

    def __init__(self, name, like, step):
        self.name, self.like, self.step = name, like, step

    def __enter__(self):
        self.record = _begin(self.name, self.like, self.step)
        return self.record

    def __exit__(self, *exc):
        _end(self.record)
        return False


def span(name, like=None, step=None):
    """A context that records the span ``name`` while tracing is on (else
    the shared null context).  ``like``: a tensor or device; on CUDA the
    span also marks the device at its entry and exit.  ``step``: the
    span's step, where the caller counts them (an ``update`` span sets
    the next spans' step to one past it)."""
    if not _state["on"]:
        return _NULL
    return _Span(name, like, step)


def _grad_tensors(tensors):
    return [t for t in tensors if isinstance(t, torch.Tensor) and t.requires_grad]


def _first(grads):
    return next((g for g in grads if g is not None), None)


def _on_node(tensors, hook):
    """``hook(grads)`` before the backward of each node that made one of
    ``tensors``: one node pre-hook a node, which runs after every tensor
    hook on that node's gradients (so a span that ends at a tensor closes
    before one that begins there opens) and calls the node's hooks last
    registered first.  Dispatches nothing."""
    for node in {id(t.grad_fn): t.grad_fn for t in tensors if t.grad_fn is not None}.values():
        hooks = node.metadata.get(_BEGIN)
        if hooks is None:
            hooks = node.metadata[_BEGIN] = []
            node.register_prehook(functools.partial(_begin_all, hooks))
        hooks.append(hook)


def _begin_all(hooks, grads):
    for hook in reversed(hooks):
        hook(grads)


def vjp(name, outputs, inputs):
    """The backward span ``name`` from the gradient of ``outputs`` to the
    gradients of ``inputs`` (each a tensor or a sequence): the VJP of the
    forward between them, opened when the backward of the first node that
    made an output begins and closed when every input's gradient is
    ready.  Nothing while tracing is off,
    or where no input or no output takes gradients."""
    if not _state["on"]:
        return
    outputs = _grad_tensors(outputs if isinstance(outputs, (list, tuple)) else [outputs])
    inputs = _grad_tensors(inputs if isinstance(inputs, (list, tuple)) else [inputs])
    if not outputs or not inputs:
        return
    # this forward's span in the backward that runs now
    now = {"record": None, "left": 0}
    count = len(inputs)

    def begin(grads):
        if now["record"] is None:
            now["record"], now["left"] = _begin(name, _first(grads)), count

    def end(grad):
        if now["record"] is not None:
            now["left"] -= 1
            if now["left"] == 0:
                _end(now["record"])
                now["record"] = None

    _on_node(outputs, begin)
    handles = [t.register_hook(end) for t in inputs]
    # only the nodes of the forward's graph hold ``begin``: once they are
    # gone, so are the inputs' hooks
    weakref.finalize(begin, _remove, handles)


def _remove(handles):
    for handle in handles:
        handle.remove()


def _synchronize(marks):
    for device in {m[3] for m in marks}:
        torch.cuda.synchronize(device)


def sample(origin=None):
    """Read each span captured in a graph that has replayed since the last
    call (waits for the card): call it after each replay to be counted,
    while tracing is on (off, it reads nothing).  A span whose graph has
    not replayed since (a graph replaced, dropped or not replayed in this
    step) is not read again.  ``origin``: a timing event that the caller
    recorded on the card before the replays; each reading then also keeps
    its start and end in ms after it.  Returns the readings: dicts of
    name, parent, ms (and start_ms, end_ms after ``origin``)."""
    if not _state["on"] or not _captured:
        return []
    _synchronize(_captured)
    _state["samples"] += 1
    read = []
    for record, start, end, device in _captured:
        try:
            ms = start.elapsed_time(end)
        except RuntimeError:                     # captured, never replayed
            continue
        since = _since.get(device)
        if since is not None and since.elapsed_time(start) < 0:
            continue                             # not replayed since
        _readings.append((record["name"], record["parent"], ("replay", _state["samples"]), ms))
        reading = dict(name=record["name"], parent=record["parent"], ms=ms)
        if origin is not None:
            reading.update(start_ms=origin.elapsed_time(start), end_ms=origin.elapsed_time(end))
        read.append(reading)
    for device in {m[3] for m in _captured}:
        _since[device] = _mark(device, external=False)
    return read


def _read_eager():
    if not _eager:
        return
    _synchronize(_eager)
    for record, start, end, _ in _eager:
        _readings.append((record["name"], record["parent"], ("step", record["step"]),
                          start.elapsed_time(end)))
    _eager.clear()


def device_ms(outermost=False):
    """{span name: device ms a step}: each name's readings summed and
    divided by the steps (replays read, or eager steps) in which it ran;
    with ``outermost``, the spans read outside any other only.  A span's
    device ms is the time between its marks: its kernels and the gaps
    between them.  Reads the eager spans' marks (waits for the card)."""
    _read_eager()
    total, steps = {}, {}
    for name, parent, key, ms in _readings:
        if outermost and parent is not None:
            continue
        total[name] = total.get(name, 0.0) + ms
        steps.setdefault(name, set()).add(key)
    return {name: total[name] / len(steps[name]) for name in total}


def counters():
    """The port's counters: kernel launches, graphs, K4's slot tables,
    K7's capped binnings (one read of the card) and, where the sharded
    entry is loaded, its collectives by kind."""
    from ..ops import graphs, resolve_cuda

    out = dict(launches=dict(resolve_cuda.LAUNCHES), graphs=dict(resolve_cuda.GRAPHS),
               slot_table_builds=resolve_cuda.SLOT_TABLE_BUILDS, bins=graphs.bin_counters())
    collectives = sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.parallel.collectives")
    if collectives is not None:
        out["collectives"] = dict(collectives.COLLECTIVES)
    return out


def spans(name=None):
    """The finished spans (dicts: name, parent, step, start_ns, end_ns,
    captured), oldest first; only those named ``name`` if given."""
    return [dict(r) for r in _spans if name is None or r["name"] == name]


def collect():
    """dict(spans, device_ms, counters) of what was recorded since
    :func:`enable`: the finished spans, each span's device ms a step
    (:func:`device_ms`: the replays that :func:`sample` read, and the
    spans recorded eagerly) and :func:`counters`."""
    return dict(spans=spans(), device_ms=device_ms(), counters=counters())
