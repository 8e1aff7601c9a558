"""The collectives of the sharded path, counted by kind.

``COLLECTIVES[kind]`` counts the collectives that reached other ranks (a
group of one rank makes none): each one run eagerly, and each replay of one
that a CUDA graph holds (the graph runs it again without passing through
Python, so the chain that replays it counts it: :func:`count`).
``COLLECTIVE_SECONDS[kind]`` sums the host time of the eager ones.  They
are module dicts, like ``resolve_cuda.LAUNCHES``: autograd runs the
backward of CUDA tensors, and so the gradient all-reduce, on threads of
its own.

gloo takes CUDA tensors for some collectives only, and stages those through
host memory itself.  Here every collective of a CUDA tensor on a gloo group
is staged explicitly: the device's queued work is waited for (so the time
counted is the collective's), the tensor is copied to the host, the
collective runs there, and the result is copied back.  That is the only way
to run several ranks on one card (NCCL refuses two ranks on one device).

NCCL groups (one rank per card) take CUDA tensors as they are, and a CUDA
graph can hold their collectives (:func:`capturable`, :func:`captured`):
an all-gather writes straight into a buffer the graph owns and the
all-reduce sums one in place, so that a rank's step of the sharded entry
is one forward and one backward graph with its collectives inside
(``ops.graphs.Chain``).  The host time counted of an eager NCCL collective
is its enqueue's only; :func:`device_timing` collects CUDA events around
each (a captured one's device time is the profiler's ``nccl`` kernel
record).

NCCL may create a group's communicator at its first collective, and no
communicator can be created inside a capture.  So a capture takes
collectives only on groups that have run one eagerly (:func:`captured`
raises otherwise): the first call of a signature runs eagerly, through the
same collectives, so every group of a chain's plan has.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# per step of a sharded render: the face fold's two all-gathers (face > 1),
# the finished images' all-gather (more than one (data, tile) cell), the NMR
# backward's halo rows (tile > 1) and the one gradient all-reduce
KINDS = ("face_all_gather", "image_all_gather", "halo_exchange", "grad_all_reduce")
# the kind whose requests are all-reduces (sums); every other kind's are
# all-gathers
REDUCE = "grad_all_reduce"
COLLECTIVES = dict.fromkeys(KINDS, 0)
COLLECTIVE_SECONDS = dict.fromkeys(KINDS, 0.0)
# id(group) -> group, for every group that has run a collective eagerly
_connected = {}
# the (kind, start, end) CUDA events of each eager NCCL collective while
# device_timing() collects them
_timing = {"records": None}


def reset_collectives():
    for kind in KINDS:
        COLLECTIVES[kind] = 0
        COLLECTIVE_SECONDS[kind] = 0.0


def count(kinds):
    """Count one run of the collectives of ``kinds`` that a graph holds (a
    replay)."""
    for kind in kinds:
        COLLECTIVES[kind] += 1


@contextlib.contextmanager
def device_timing():
    """Collect CUDA events around each eager collective of a CUDA tensor
    on an NCCL group run in the block (the wait for the slowest rank
    included); yields the list that :func:`device_ms` reads."""
    saved = _timing["records"]
    _timing["records"] = records = []
    try:
        yield records
    finally:
        _timing["records"] = saved


def device_ms(records):
    """{kind: device ms summed} of :func:`device_timing`'s ``records``
    (synchronises)."""
    torch.cuda.synchronize()
    out = dict.fromkeys(KINDS, 0.0)
    for kind, start, end in records:
        out[kind] += start.elapsed_time(end)
    return out


@contextlib.contextmanager
def _eager(kind, group, on_card):
    """Count and time one eager collective of ``kind`` on ``group``;
    ``on_card``: with CUDA events where :func:`device_timing` collects."""
    records = _timing["records"] if on_card else None
    if records is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    yield
    COLLECTIVE_SECONDS[kind] += time.perf_counter() - t0
    COLLECTIVES[kind] += 1
    _connected[id(group)] = group
    if records is not None:
        end.record()
        records.append((kind, start, end))


def _host_staged(t, group):
    """Whether a collective of ``t`` on ``group`` goes through host memory;
    waits for the device's queued work if so."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    return staged


def _gather_flat(t, group, out):
    """``t`` of every rank into ``out`` [n, *t.shape] through its flat view
    [n * t.shape[0], *t.shape[1:]] (the one layout gloo also takes): one
    collective straight into the buffer, no parts, no stack, no host copy."""
    n = dist.get_world_size(group)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out.view(n * t.shape[0], *t.shape[1:]), t.contiguous(), group=group)
    return out


def all_gather(t, group, kind, out=None):
    """``t`` of every rank of ``group``, stacked in group rank order:
    [n, *t.shape] (written into ``out`` when given, a buffer of that shape
    that a compiled core's graph reads).  Every rank passes a tensor of the
    same shape."""
    n = dist.get_world_size(group)
    if n == 1:
        return t[None]
    staged = _host_staged(t, group)
    with _eager(kind, group, t.is_cuda and not staged):
        if not staged:
            return _gather_flat(t, group, t.new_empty((n,) + tuple(t.shape)) if out is None
                                else out)
        parts = [torch.empty_like(t, device="cpu") for _ in range(n)]
        dist.all_gather(parts, t.cpu(), group=group)
        stacked = torch.stack(parts)
        if out is None:
            return stacked.to(t.device)
        return out.copy_(stacked)


def all_reduce_sum(t, group, kind):
    """The sum of ``t`` over the ranks of ``group`` (a new tensor)."""
    if dist.get_world_size(group) == 1:
        return t
    staged = _host_staged(t, group)
    with _eager(kind, group, t.is_cuda and not staged):
        buf = t.cpu() if staged else t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def crosses(requests):
    """Whether any collective of ``requests`` [(tensor, group, kind)]
    reaches another rank."""
    return any(dist.get_world_size(group) > 1 for _, group, _ in requests)


def capturable(requests):
    """Whether a CUDA graph can hold every collective of ``requests`` that
    reaches another rank: a CUDA tensor on an NCCL group."""
    return all(t.is_cuda and dist.get_backend(group) == "nccl"
               for t, group, _ in requests if dist.get_world_size(group) > 1)


def local(request):
    """The result of a collective ``request`` over a group of one rank."""
    t, _, kind = request
    return t if kind == REDUCE else t[None]


def gather_all(requests):
    """The collectives of ``requests`` [(tensor, group, kind)] run eagerly,
    in order: all-gathers, and the all-reduce of :data:`REDUCE`."""
    return [all_reduce_sum(t, group, kind) if kind == REDUCE else all_gather(t, group, kind)
            for t, group, kind in requests]


def captured(requests):
    """The collectives of ``requests`` issued into the capture being made
    (run at each replay, counted there: nothing is counted here), each on a
    group that has run a collective eagerly; their results, buffers of the
    graph's pool."""
    out = []
    for t, group, kind in requests:
        if dist.get_world_size(group) == 1:
            out.append(local((t, group, kind)))
            continue
        if id(group) not in _connected:
            raise RuntimeError(
                f"parallel: a capture holds a {kind} on a process group that has run no "
                f"collective yet, and its communicator cannot be created inside a capture: "
                f"run the step once eagerly before capturing it")
        if kind == REDUCE:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            out.append(t)
        else:
            out.append(_gather_flat(t, group, t.new_empty((dist.get_world_size(group),)
                                                          + tuple(t.shape))))
    return out


def run(steps):
    """The value of ``steps``, a generator that yields the collectives its
    work waits on (``ops.graphs.drive``), each run here as it comes."""
    from ..ops.graphs import drive

    return drive(steps, gather_all)[0]


def _result_shape(t, group, kind):
    return tuple(t.shape) if kind == REDUCE else (dist.get_world_size(group),) + tuple(t.shape)


def gathered_buffers(requests):
    """Buffers for the results of ``requests`` ([n, *t.shape] of an
    all-gather), which a captured graph reads and each replay's collective
    fills."""
    return [r[0].new_empty(_result_shape(*r)) for r in requests]


def stand_ins(requests):
    """Zeros in the place of the results of ``requests``: a graph's warm-up
    runs its work without reaching the other ranks."""
    return [r[0].new_zeros(_result_shape(*r)) for r in requests]
