"""A cell whose traffic shards the step over cards: one rank per card over
NCCL (``parallel.run_ranks``: a file store under ``TMPDIR``), each rank
driving the port's sharded entry (``parallel.rasterize_silhouettes_sharded``
over the traffic's (data, tile, face) mesh) behind the facade's camera,
the benchmark's loss on the gathered images and the port's Adam.  The
port replays each rank's render as one forward and one backward CUDA
graph with the image gather and the gradient all-reduce inside.

Every rank runs the same number of steps: set-up times a few steps and
the ranks agree on a first count (the largest any rank asks for) that
fills half of ``--seconds``; after it, on the count of further steps that
the host's clock over the first says fills the rest.  Each rank returns
its readings; the parent takes the slowest rank at each step, the
longest window, the fullest card, and compares every rank's first steps
with the reference.  The window runs in
the ranks, so each rank reports the modules of JAX or the JAX package it
holds once its window has closed; where any rank holds one, the parent
raises ``runner.ForbiddenLoaded`` and makes no result.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from . import check, clocks, runner, trace
from .fit import Fit, port
from .scene import make_inputs

# steps run before the sizing (the first replays after a capture are
# slower than the window's), steps timed to size the window, and the
# fewest steps a window takes
SETTLE_STEPS, SIZING_STEPS, MIN_STEPS = 10, 30, 20
# steps of the traced window on every rank
TRACED_STEPS = 50
# seconds the ranks may take, set-up, window, trace and all
RANK_TIMEOUT = 300.0


def _agree(n, device):
    """The largest ``n`` over the ranks."""
    import torch.distributed as dist

    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def planned(first, seconds, device):
    """The sharded window's ``go``: ``first`` steps, then as many more as
    the host's clock over them says fill ``seconds`` (the largest count
    any rank asks for, so every rank takes the same steps)."""
    total = [first]

    def go(n, elapsed):
        if n == first:
            rest = math.ceil(first * (seconds - elapsed) / elapsed) if elapsed < seconds else 0
            total[0] = first + _agree(rest, device)
        return n < total[0]

    return go


def broadcast_leaves(inputs):
    """Every rank starts from rank 0's leaves, bit for bit."""
    import torch.distributed as dist

    for leaf in inputs["leaves"].values():
        dist.broadcast(leaf, 0)


def rank_main(name, seed, seconds, trace_on, overrides=None, fault=None, started=None,
              guard=runner.FORBIDDEN, workload=None):
    """One rank's run; returns its readings (host objects), with the loaded
    modules whose top-level name is in ``guard`` once the window has
    closed."""
    import torch.distributed as dist

    rank = dist.get_rank()
    phases = [("start", started or time.time()), ("rank up", time.time())]
    cell = runner.cell_with(name, overrides, workload)
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = dist.get_backend() == "nccl"
    if cuda:
        port().utils.cuda_build.load()
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    inputs = make_inputs(cfg, seed, device, cell["task"])
    broadcast_leaves(inputs)
    fit = Fit(inputs, cfg, "sharded", mesh=traffic["mesh"], fault=fault, task=cell["task"])
    # the signature's first call runs eagerly, its second captures the
    # rank's chain, its third replays it
    phases.append(("inputs", time.time()))
    for _ in range(3):
        fit.backward()
    fit.zero_grad()
    fit.nonfinite.zero_()
    phases.append(("eager call, capture, replay", time.time()))
    first = fit.first_steps(runner.FIRST_STEPS)
    phases.append(("first steps", time.time()))
    runner.time_steps(fit.step, SETTLE_STEPS, device)
    step_s = runner.time_steps(fit.step, SIZING_STEPS, device)
    phases.append(("sizing steps", time.time()))
    if rank == 0:
        runner.log_phases(phases)
    out = dict(rank=rank)
    if rank == 0 and cuda:
        clocks.log("before window")
    if not trace_on:
        opening = _agree(max(MIN_STEPS, math.ceil(0.5 * seconds / step_s)), device)
        dist.barrier()
        out["window"] = runner.window(fit.step, device, planned(opening, seconds, device))
        out["attempted"] = out["window"]["steps"]
    else:
        dist.barrier()
        prof = trace.traced(fit.step, TRACED_STEPS, device)
        t = trace.read(prof)
        busy_us, window_us = trace.busy(t)
        out.update(busy_us=busy_us, window_us=window_us, attempted=TRACED_STEPS,
                   nccl_ms=trace.nccl_ms(t, TRACED_STEPS),
                   host_ms=trace.host_ms(fit.parts(), runner.HOST_STEPS, device),
                   breakdown=trace.breakdown(t) if rank == 0 else None)
    if rank == 0 and cuda:
        clocks.log("after window")
    out["failed"] = int(fit.nonfinite)
    out["peak"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    out["first"] = runner.program_readings(first)
    out["kinds"] = fit.collective_kinds()
    fit.drop()
    del fit
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["forbidden"] = runner.forbidden_modules(guard)
    return out


def run(name, seed, seconds, trace_on, started, device="cuda", overrides=None, fault=None,
        guard=runner.FORBIDDEN, workload=None):
    """The parent's side: the ranks, then the metrics and the comparison
    on card 0 once every rank has ended.  Raises ``runner.ForbiddenLoaded``
    where a rank holds a module whose top-level name is in ``guard``.
    ``device``, ``overrides``, ``fault`` and ``workload`` (``spec.cell``):
    the tests' runs, ranks on the CPU over gloo."""
    cell = runner.cell_with(name, overrides, workload)
    cfg, traffic = cell["config"], cell["traffic"]
    shape = traffic["mesh"]
    world = shape["data"] * shape["tile"] * shape["face"]
    parallel = port().parallel
    device = torch.device(device)
    ranks = parallel.run_ranks(rank_main, world, (name, seed, seconds, trace_on, overrides,
                                                  fault, started, guard, workload),
                               device=device.type, timeout=RANK_TIMEOUT)
    loaded = sorted({m for r in ranks for m in r["forbidden"]})
    if loaded:
        raise runner.ForbiddenLoaded(loaded)
    runner.log(f"[collectives] kinds of each rank's step: {ranks[0]['kinds']}")
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    inputs = make_inputs(cfg, seed, device, cell["task"])
    peak = max(r["peak"] for r in ranks)
    failed = max(r["failed"] for r in ranks)
    attempted = ranks[0]["attempted"]
    if not trace_on:
        metrics = runner.end_to_end(cell, inputs, [r["window"] for r in ranks], started, peak)
        traced = None
    else:
        ctx = dict(kind=runner.device_kind(device),
                   busy_us=[r["busy_us"] for r in ranks],
                   window_us=[r["window_us"] for r in ranks],
                   host_ms=[r["host_ms"] for r in ranks],
                   nccl_ms=[r["nccl_ms"] for r in ranks], step_ms=None, work=None,
                   stages=None, counters=None, spans=None)
        runner.log(f"[collectives] NCCL device ms per step by rank: {ctx['nccl_ms']}")
        metrics = runner.metric_values(cell["per_layer"], ctx)
        n = len(ranks)
        traced = dict(busy_us=sum(ctx["busy_us"]) / n, window_us=sum(ctx["window_us"]) / n,
                      breakdown=ranks[0]["breakdown"])
    firsts = [r["first"] for r in ranks]
    ref = runner.reference_run(cell, inputs, firsts[0]["params0"])
    numbers = ranks_readings(firsts, ref, cfg["optimizer"]["beta1"])
    return runner.finish(cell, numbers, attempted, failed, metrics, world, peak, traced,
                         device)


def ranks_readings(firsts, ref, beta1):
    """The numbers compared over ranks: each the worst rank's (NaN where
    any rank's is), and ``rank_gap`` (``firsts``: each rank's first steps,
    rank 0's first)."""
    per_rank = [check.readings(prog, ref, beta1) for prog in firsts]
    numbers = {k: check.worst(r[k] for r in per_rank) for k in per_rank[0]}
    numbers["rank_gap"] = check.rank_gap([p["params"] for p in firsts], firsts[0]["params0"])
    return numbers
