"""A traced window: ``torch.profiler`` over a few steps, read into device
records, the busy union, the window, the top device operations and the
longest idle gaps with what the host was doing in each."""

from __future__ import annotations

import collections
import time

import torch

from ..yardstick import timeline
from .stages import MARKER

WINDOW = "portbench.window"
STEP = "portbench.step"
TOP = 10


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced(fit_step, steps, device):
    """Profile ``steps`` calls of ``fit_step`` (each under a host range
    named STEP) inside one range named WINDOW that ends in a synchronize.
    On a card, its activity only (its operations and the CUDA runtime
    calls that launched or waited for them): recording every host
    operation would slow the host-paced part of a step.  On the CPU (the
    tests) the host's.  Returns the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                with record_function(STEP):
                    fit_step()
            _sync(device)
    return prof


def read(prof):
    """dict(records [(name, start us, end us)] of the device's operations
    (kernels, copies, fills; not the host ranges that the profiler also
    draws on the device's timeline), window (start us, end us) of the
    WINDOW range (where the profile kept it, else from the first device
    record's start to the last one's end), host [(name, start, end)] of
    the host's ranges and runtime calls)."""
    from torch.autograd import DeviceType

    records, host, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in (WINDOW, STEP):
                records.append((e.name, start, end))
        else:
            if e.name == WINDOW:
                window = (start, end)
            host.append((e.name, start, end))
    if window is None and records:
        window = (min(r[1] for r in records), max(r[2] for r in records))
    return dict(records=records, window=window, host=host)


def busy(trace):
    """(busy us, window us): the union of the device records but the
    stage markers, inside the WINDOW range."""
    lo, hi = trace["window"]
    intervals = [(s, e) for n, s, e in trace["records"] if MARKER not in n]
    return timeline.union_length(timeline.clipped(intervals, lo, hi)), hi - lo


def breakdown(trace):
    """The device operations that took most time (name, seconds) and the
    longest idle gaps, each named by the innermost host range or operation
    running at its middle (name, seconds)."""
    per_name = collections.Counter()
    for n, s, e in trace["records"]:
        if MARKER not in n:
            per_name[n[:120]] += (e - s) / 1e6
    lo, hi = trace["window"]
    intervals = [(s, e) for n, s, e in trace["records"] if MARKER not in n]
    idle = sorted(timeline.gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for s, e in idle:
        mid = (s + e) / 2
        covering = [(he - hs, n) for n, hs, he in trace["host"]
                    if hs <= mid <= he and n != WINDOW]
        what = min(covering)[1] if covering else "no host range"
        named.append([f"idle during {what[:100]}", (e - s) / 1e6])
    return dict(device_ops=[[n, t] for n, t in per_name.most_common(TOP)], idle_gaps=named)


def nccl_ms(trace, steps):
    """Device ms per step of the NCCL kernels in the trace."""
    total = sum(e - s for n, s, e in trace["records"] if "nccl" in n.lower())
    return total / 1e3 / steps


def host_ms(parts, steps, device):
    """Host ms per step of each call of ``parts`` (a step's calls in
    order), each made on an idle device: the host's own cost of the step,
    without the waits that a call which synchronises would add."""
    total = 0.0
    for _ in range(steps):
        for part in parts:
            _sync(device)
            t0 = time.perf_counter()
            part()
            total += time.perf_counter() - t0
    _sync(device)
    return total * 1e3 / steps


def bin_counts(ctx):
    """K7's capped binnings (dict(binnings, pairs, slots, overflow_bins),
    kept on the card by K7 itself at every replay of a graph that holds
    one, a caller's capture too): ``ctx["counters"]["bins"]``, the port's
    counters copied right after the traced window, so that no later
    binning (the span fit's) reaches them; in a context without
    ``counters``, the port's counts since the process started
    (``ops.graphs.bin_counters``).  None where the port keeps no such
    counts or made no capped binning (the tiled route)."""
    if "counters" in ctx:
        counts = (ctx["counters"] or {}).get("bins")
    else:
        from .fit import port

        read = getattr(port().ops.graphs, "bin_counters", None)
        counts = read() if read is not None else None
    return counts if counts and counts.get("binnings") else None
