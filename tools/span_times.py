#!/usr/bin/env python3
"""Read the port's spans and counters (``utils/trace.py``) in a cell of the
benchmark (``portbench/``) on one CUDA card, beside the benchmark's own
stage table, and what tracing costs.

    python3 tools/span_times.py --workload <cell> [--seed N] [--steps N] [--out FILE]

Four fits of the cell's configuration and traffic, each set up as
``portbench/harness/runner.py`` sets one up, all kept on the card:

- ``table``: the port's spans off, the harness's stage markers in the
  captured step (``harness.stages``);
- ``spans``: the spans on and the stage markers in one graph;
- ``plain``: spans off, no marker (the benchmark's untraced step);
- ``clock``: spans on, no marker.

Then, in turns (a, b, b, a): traced windows as the benchmark's ``--trace
1`` takes them of ``table`` and ``spans`` (each its stages' device ms a
step, device operations a step and ms a step), and untraced windows of
``plain`` and ``clock`` (ms a step), with tracing on throughout, so that
every fit's update records its host span and the pairs differ by the
device marks alone.  Each span's device ms a step of
``spans`` and of ``clock``, read by ``trace.sample`` after each of
``--steps`` further steps, beside the table's stages.  Last, a traced
window of ``clock`` whose profile keeps the CUDA runtime calls, laid over
the port's ``update`` spans on the profiler's clock: the share of the
update's runtime calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``) that
fall inside an ``update`` span and the distances of those outside; the
share of the window in which the card ran nothing while the host was
inside ``update``; the update's device ms a step (the records those calls
launched).

Then the share of the card's busy time that the port covers: ``--steps``
steps of ``clock`` under the profiler, each after an anchor (a spin
kernel, then a timing event the next ``trace.sample`` measures the spans
from), so that the outermost device spans land on the profiler's clock
at the anchor kernel's end.  A step's busy time is the union of its
device records (the anchor's left out); the covered part is the busy
time inside the union of the outermost spans and the update's records,
so the share cannot pass 100%.  A span's first mark should lie just
before the step's first record: the distances are kept as the check of
that placement.

The kernels each fit's set-up launched and captured
(``resolve_cuda.LAUNCHES``) and the port's counters (``trace.counters``,
K7's capped binnings since the last fit's set-up among them) close the
line.  The last line of the output is one JSON object, also written to
FILE when given.  Without CUDA the script fails.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from portbench.harness import runner, stages as table  # noqa: E402
from portbench.harness.fit import Fit, port  # noqa: E402
from portbench.harness.scene import make_inputs  # noqa: E402
from portbench.yardstick import timeline  # noqa: E402

UNTRACED_SECONDS = 3.0
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync")
ANCHOR_CYCLES = 20000                          # ~10 us of spinning


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def fit_of(cell, seed, marked, launches):
    """A fit set up as the benchmark sets one up (with the stage markers
    where ``marked``), its first steps taken; the kernels its set-up
    launched and captured go into ``launches``."""
    rc = port().ops.resolve_cuda
    rc.reset_launches()
    inputs = make_inputs(cell["config"], seed, torch.device("cuda", 0))
    stages = table.Stages() if marked else None
    fit = Fit(inputs, cell["config"], cell["traffic"]["form"], stages)
    launches.append({k: n for k, n in rc.LAUNCHES.items() if n})
    fit.first_steps(runner.FIRST_STEPS)
    return fit, stages


def untraced_ms(fit):
    w = runner.window(fit.step, torch.device("cuda", 0),
                      lambda n, elapsed: elapsed < UNTRACED_SECONDS)
    return 1e3 * w["seconds"] / w["steps"]


def table_window(fit, stages):
    """The benchmark's traced window over a fit captured under ``stages``:
    its stages' device ms a step and its ms a step."""
    w = runner.traced_window(fit, runner.time_steps(fit.step, 5, torch.device("cuda", 0)),
                             True)
    labels = stages.captured + [table.UPDATE]
    ops = sum(1 for r in w["trace"]["records"] if table.MARKER not in r[0])
    return dict(steps=w["steps"], step_ms=w["step_ms"], busy_us=w["busy_us"],
                window_us=w["window_us"], device_ops_per_step=ops / w["steps"],
                stages=table.stage_ms(w["trace"]["records"], labels, w["steps"]))


def layer_sums(stages, spans, trace):
    """The benchmark's three stage metrics from its table beside the same
    sums of the port's spans, and the texture sampler's and the lights'
    spans (RGB cells)."""
    out = {}
    if stages:
        out["camera_dev_ms"] = sum(stages[s] for s in table.CAMERA)
        out["nmr_dev_ms"] = sum(stages[s] for s in table.NMR)
        out["resolve_dev_ms"] = stages[table.RESOLVE]
    out["camera_span_ms"] = sum(spans.get(s, 0.0) for s in trace.CAMERA)
    out["nmr_span_ms"] = sum(spans.get(s, 0.0) for s in trace.NMR)
    out["resolve_span_ms"] = sum(spans.get(s, 0.0) for s in trace.RESOLVE)
    out["sample_span_ms"] = sum(spans.get(s, 0.0) for s in trace.SAMPLE)
    out["lights_span_ms"] = sum(spans.get(s, 0.0) for s in trace.LIGHTS)
    return out


def device_records(prof):
    """The profile's events and its device records (no annotation)."""
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()]
    return events, device


def update_records(events, device, updates, t0, t1):
    """The runtime calls of the window [t0, t1] (ns), the distance of each
    to the nearest ``update`` span (0 inside one), and the device records
    that the calls inside the spans launched."""
    runtime = [e for e in events if e.name() in RUNTIME_CALLS and t0 <= e.start_ns() <= t1]
    distance = [min(max(s - e.start_ns(), e.end_ns() - t, 0) for s, t in updates)
                for e in runtime]
    inside = [e for e, d in zip(runtime, distance) if d == 0]
    launched = ({e.correlation_id() for e in inside}
                | {e.linked_correlation_id() for e in inside}) - {0}
    records = [(e.start_ns(), e.end_ns()) for e in device
               if e.correlation_id() in launched or e.linked_correlation_id() in launched]
    return runtime, distance, records


def clock_window(fit, steps, trace):
    """A traced window (the runtime calls kept) laid over the ``update``
    spans: see the module's docstring."""
    from torch.profiler import ProfilerActivity, profile

    trace.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for _ in range(steps):
            fit.step()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    events, device = device_records(prof)
    updates = [(s["start_ns"], s["end_ns"]) for s in trace.spans(trace.UPDATE)]
    runtime, distance, update_dev = update_records(events, device, updates, t0, t1)
    intervals = [(e.start_ns(), e.end_ns()) for e in device]
    idle = timeline.gaps(intervals, t0, t1)
    idle_in_update = sum(timeline.union_length(timeline.clipped(updates, s, e)) for s, e in idle)
    busy = timeline.union_length(timeline.clipped(intervals, t0, t1))
    inside = sum(1 for d in distance if d == 0)
    return dict(steps=steps, window_ms=(t1 - t0) / 1e6, busy_ms=busy / 1e6,
                runtime_calls=len(runtime), inside_update=inside,
                outside_ns=sorted(d for d in distance if d > 0)[-10:],
                inside_share=inside / max(1, len(runtime)),
                update_idle_pct=100.0 * idle_in_update / (t1 - t0),
                device_idle_pct=100.0 * (1 - busy / (t1 - t0)),
                update_device_ms=timeline.union_length(update_dev) / 1e6 / steps,
                update_host_ms=sum(t - s for s, t in updates) / 1e6 / steps,
                busy_ms_per_step=busy / 1e6 / steps)


def covered(fit, steps, trace):
    """The share of the card's busy time a step inside the outermost device
    spans or the update's records: see the module's docstring."""
    from torch.profiler import ProfilerActivity, profile

    trace.clear()
    torch.cuda.synchronize()
    readings = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for _ in range(steps):
            torch.cuda._sleep(ANCHOR_CYCLES)
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            fit.step()
            readings.append([r for r in trace.sample(origin) if r["parent"] is None])
        t1 = time.time_ns()
    events, device = device_records(prof)
    updates = [(s["start_ns"], s["end_ns"]) for s in trace.spans(trace.UPDATE)]
    update_dev = update_records(events, device, updates, t0, t1)[2]
    anchors = sorted((e.start_ns(), e.end_ns()) for e in device if table.MARKER in e.name())
    records = sorted((e.start_ns(), e.end_ns()) for e in device if table.MARKER not in e.name())
    # the profile may miss its first records: the anchors kept are the
    # last steps' (the leads below show a step read against another's)
    readings = readings[len(readings) - len(anchors):]
    busy = cover = 0.0
    leads = []
    ends = [a[0] for a in anchors[1:]] + [max(e for _, e in records)]
    for (_, lo), hi, spans in zip(anchors, ends, readings):
        step = timeline.clipped(records, lo, hi)
        marked = [(lo + 1e6 * r["start_ms"], lo + 1e6 * r["end_ms"]) for r in spans]
        within = marked + timeline.clipped(update_dev, lo, hi)
        busy += timeline.union_length(step)
        cover += sum(timeline.union_length(timeline.clipped(step, s, e))
                     for s, e in merged(within))
        if marked and step:
            leads.append(min(s for s, _ in step) - min(s for s, _ in marked))
    leads.sort()
    return dict(steps=steps, anchors=len(anchors), busy_ms_per_step=busy / 1e6 / len(anchors),
                covered_ms_per_step=cover / 1e6 / len(anchors),
                covered_pct=100.0 * cover / busy if busy else None,
                first_mark_lead_ns=dict(least=leads[0], median=leads[len(leads) // 2],
                                        most=leads[-1]) if leads else None,
                last_step=placed(device, anchors[-1][1], ends[-1], readings[-1]))


def placed(device, lo, hi, spans):
    """One step laid out from its anchor's end (µs): each outermost span
    with the first device record at or after its start mark, and the
    step's first records."""
    named = sorted((e.start_ns(), e.end_ns(), e.name()) for e in device
                   if table.MARKER not in e.name() and lo <= e.start_ns() <= hi)
    out = dict(spans=[], first_records=[(n[:40], (s - lo) / 1e3, (e - lo) / 1e3)
                                        for s, e, n in named[:8]])
    for r in sorted(spans, key=lambda r: r["start_ms"]):
        first = next(((s, n) for s, _, n in named if s >= lo + 1e6 * r["start_ms"]), None)
        out["spans"].append(dict(name=r["name"], start_us=1e3 * r["start_ms"],
                                 end_us=1e3 * r["end_ms"],
                                 first_record=None if first is None else first[1][:40],
                                 first_record_us=None if first is None else (first[0] - lo) / 1e3))
    return out


def merged(intervals):
    """``intervals`` merged where they overlap, in time order."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def turns(a, b, measure):
    """``measure(fit)`` of fits ``a`` and ``b`` in turns a, b, b, a.
    Returns ([a's two], [b's two])."""
    out = ([], [])
    for k in (0, 1, 1, 0):
        out[k].append(measure((a, b)[k]))
    return out


def sampled(fit, steps):
    """Each span's device ms a step over ``steps`` steps of ``fit``, each
    read by ``trace.sample``; and the outermost spans' sum."""
    trace = port().utils.trace
    trace.clear()
    for _ in range(steps):
        fit.step()
        trace.sample()
    return trace.device_ms(), sum(trace.device_ms(outermost=True).values())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=2147483901)
    parser.add_argument("--steps", type=int, default=50,
                        help="steps sampled, clock steps and covered steps")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_times: CUDA is not available", file=sys.stderr)
        return 1
    runner.build_kernels()
    nr = port()
    cell = runner.cell_with(args.workload)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = dict(workload=args.workload, seed=args.seed, smi=smi, torch=torch.__version__)
    # the kernels each fit's set-up launched and captured: table, plain,
    # spans, clock
    out["launches"] = launches = []
    table_fit, table_stages = fit_of(cell, args.seed, True, launches)
    plain_fit, _ = fit_of(cell, args.seed, False, launches)

    # on from here: the fits captured before hold no device mark, and each
    # fit's update records its host span
    trace = nr.utils.trace
    trace.enable()
    spans_fit, spans_stages = fit_of(cell, args.seed, True, launches)
    tables, spanned = turns(table_fit, spans_fit,
                            lambda fit: table_window(fit, table_stages if fit is table_fit
                                                     else spans_stages))
    out["table"], out["spans"] = tables, spanned
    out["spans_ms"], out["spans_outermost_ms"] = sampled(spans_fit, args.steps)
    out["sums"] = [layer_sums(t["stages"], out["spans_ms"], trace) for t in tables + spanned]
    log(f"[spans] {json.dumps(out)}")
    del table_fit, spans_fit

    trace.enable()                               # the spans' graph retired
    clock_fit, _ = fit_of(cell, args.seed, False, launches)
    out["clock_ms"], out["clock_outermost_ms"] = sampled(clock_fit, args.steps)
    plain, clock = turns(plain_fit, clock_fit, untraced_ms)
    out["untraced_step_ms"] = dict(plain=plain, clock=clock)
    out["clock"] = clock_window(clock_fit, args.steps, trace)
    log(f"[clock] {json.dumps(out['clock'])}")
    out["covered"] = covered(clock_fit, args.steps, trace)
    trace.disable()
    log(f"[covered] {json.dumps(out['covered'])}")
    out["counters"] = trace.counters()
    return emit(out, args.out)


def emit(out, path):
    line = json.dumps(out)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
