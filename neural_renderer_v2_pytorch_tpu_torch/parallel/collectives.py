"""The collectives of the sharded path, counted by kind.

``COLLECTIVES[kind]`` counts the calls that reached other ranks (a group of
one rank makes none) and ``COLLECTIVE_SECONDS[kind]`` sums the host time in
them.  They are module dicts, like ``resolve_cuda.LAUNCHES``: autograd runs
the backward of CUDA tensors, and so the gradient all-reduce, on threads of
its own.

gloo takes CUDA tensors for some collectives only, and stages those through
host memory itself.  Here every collective of a CUDA tensor on a gloo group
is staged explicitly: the device's queued work is waited for (so the time
counted is the collective's), the tensor is copied to the host, the
collective runs there, and the result is copied back.  That is the only way
to run several ranks on one card (NCCL refuses two ranks on one device).
NCCL groups take CUDA tensors as they are; their time counted is the host's
enqueue time only.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# per step of a sharded render: the face fold's two all-gathers (face > 1),
# the finished images' all-gather (more than one (data, tile) cell), the NMR
# backward's halo rows (tile > 1) and the one gradient all-reduce
KINDS = ("face_all_gather", "image_all_gather", "halo_exchange", "grad_all_reduce")
COLLECTIVES = dict.fromkeys(KINDS, 0)
COLLECTIVE_SECONDS = dict.fromkeys(KINDS, 0.0)


def reset_collectives():
    for kind in KINDS:
        COLLECTIVES[kind] = 0
        COLLECTIVE_SECONDS[kind] = 0.0


def _host_staged(t, group):
    """Whether a collective of ``t`` on ``group`` goes through host memory;
    waits for the device's queued work if so."""
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    return staged


def all_gather(t, group, kind, out=None):
    """``t`` of every rank of ``group``, stacked in group rank order:
    [n, *t.shape] (written into ``out`` when given, a buffer of that shape
    that a compiled core's graph reads).  Every rank passes a tensor of the
    same shape."""
    if dist.get_world_size(group) == 1:
        return t[None]
    staged = _host_staged(t, group)
    t0 = time.perf_counter()
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    stacked = torch.stack(parts)
    if out is not None:
        out.copy_(stacked)
    else:
        out = stacked.to(t.device) if staged else stacked
    COLLECTIVE_SECONDS[kind] += time.perf_counter() - t0
    COLLECTIVES[kind] += 1
    return out


def crosses(requests):
    """Whether any all-gather of ``requests`` [(tensor, group, kind)]
    reaches another rank."""
    return any(dist.get_world_size(group) > 1 for _, group, _ in requests)


def gather_all(requests):
    """The all-gathers of ``requests`` [(tensor, group, kind)], in order."""
    return [all_gather(t, group, kind) for t, group, kind in requests]


def run(steps):
    """The value of ``steps``, a generator that yields the all-gathers its
    work waits on (``ops.graphs.drive``), each run here as it comes."""
    from ..ops.graphs import drive

    return drive(steps, gather_all)[0]


def gathered_buffers(requests):
    """Buffers [n, *t.shape] for the results of ``requests``, which a
    captured graph reads and each replay's all-gather fills."""
    return [t.new_empty((dist.get_world_size(group),) + tuple(t.shape))
            for t, group, _ in requests]


def stand_ins(requests):
    """Zeros in the place of the results of ``requests``: a graph's warm-up
    runs its work without reaching the other ranks."""
    return [t.new_zeros((dist.get_world_size(group),) + tuple(t.shape))
            for t, group, _ in requests]


def all_reduce_sum(t, group, kind):
    """The sum of ``t`` over the ranks of ``group`` (a new tensor)."""
    if dist.get_world_size(group) == 1:
        return t
    staged = _host_staged(t, group)
    t0 = time.perf_counter()
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        buf = buf.to(t.device)
    COLLECTIVE_SECONDS[kind] += time.perf_counter() - t0
    COLLECTIVES[kind] += 1
    return buf
