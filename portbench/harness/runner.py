"""One run of a cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.  What the
configuration's fit makes and does comes from its task and reference
(``spec.task``, ``spec.reference``).  A traced run hands its per-layer
readers (``metrics/``) a context: the profile's readings, the port's
counters copied right after the window (``counters``) and, from a second
fit captured with the port's tracing on once the window's fit is dropped,
each span's device ms a step (``spans``).

Single-device cells run here; a cell whose traffic shards the step over
cards runs one rank per card (``harness.sharded``) and comes back here for
its metrics and its comparison.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from ..yardstick import timeline
from . import check, clocks, spec, trace
from .fit import Fit, port
from .scene import make_inputs
from .stages import UPDATE, Stages, stage_ms

FIRST_STEPS = 3
# a traced window lasts about this long, within these step counts
TRACE_SECONDS, TRACE_MIN, TRACE_MAX = 1.0, 20, 200
# steps timed on an idle device for host_enqueue_ms
HOST_STEPS = 20
# replays of the span fit, each read by the port's trace.sample()
SPAN_STEPS = 50
FORBIDDEN = ("jax", "jaxlib", "flax", "neural_renderer_v2_pytorch_tpu")
MIB = 2 ** 20


class ForbiddenLoaded(RuntimeError):
    """A process that ran the window holds modules of JAX or the JAX
    package (``modules``)."""

    def __init__(self, modules):
        super().__init__(f"modules of JAX or the JAX package are loaded: {modules}")
        self.modules = modules


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=FORBIDDEN):
    """Loaded modules whose top-level name, compared whole, is one of
    ``names`` (JAX's and the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)


def build_kernels():
    """Build (only the first run in a checkout compiles) and load the
    port's kernel library."""
    cuda_build = port().utils.cuda_build
    cuda_build.build()
    cuda_build.load()


def traced_steps(step_s):
    return int(min(TRACE_MAX, max(TRACE_MIN, round(TRACE_SECONDS / step_s))))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(step, n, device):
    """Seconds per step of ``n`` steps, synchronised."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    sync(device)
    return (time.perf_counter() - t0) / n


def window(step, device, go):
    """The measured window: steps while ``go(steps taken, host seconds
    since the start)`` holds, a CUDA event at the end of each, then a
    synchronize.  Returns dict(steps, seconds, step_ms [each step's gap
    between consecutive step-end events], start (epoch seconds)).  On the
    CPU (the tests) the host clock stands in for the events."""
    cuda = device.type == "cuda"
    sync(device)
    epoch, t0 = time.time(), time.perf_counter()
    if cuda:
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
    else:
        marks = [t0]
    while go(len(marks) - 1, time.perf_counter() - t0):
        step()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
    sync(device)
    elapsed = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return dict(steps=len(marks) - 1, seconds=elapsed, step_ms=step_ms, start=epoch)


def traced_window(fit, step_s, marked):
    """A traced window of the fit's steps (a marker kernel before the
    update where the graph holds stage markers).  Returns the readings
    the per-layer metrics take, per card."""
    steps = traced_steps(step_s)

    def step():
        fit.backward()
        if marked:
            torch.cuda._sleep(0)
        fit.update()

    prof = trace.traced(step, steps, fit.device)
    t = trace.read(prof)
    busy_us, window_us = trace.busy(t)
    return dict(steps=steps, trace=t, busy_us=busy_us, window_us=window_us,
                step_ms=window_us / 1e3 / steps, nccl_ms=trace.nccl_ms(t, steps))


def program_readings(first):
    """The program's first steps on the host, for the comparison."""
    return {k: ({n: t.detach().cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.detach().cpu()) for k, v in first.items()}


def reference_run(cell, inputs, params0, steps=FIRST_STEPS, dtype=torch.float32, fault=None):
    """The first steps of the cell's reference from the same inputs, its
    leaves the seed's ``params0`` (one tensor a leaf) and its optimiser
    the configuration's (``inputs["optimizer"]``: lr, beta1, beta2,
    eps)."""
    device = inputs["faces"].device
    ref_inputs = dict(inputs, leaves={n: t.to(device) for n, t in params0.items()},
                      optimizer=cell["config"]["optimizer"])
    return cell["reference"].run(ref_inputs, steps, dtype=dtype, fault=fault)


def span_ms(inputs, cell):
    """{span: device ms a step} of the port's spans (``utils/trace.py``)
    over SPAN_STEPS steps of a second fit, captured with tracing on and
    each replay read by ``trace.sample()``; tracing is off again and the
    fit dropped on return.  The spans of its set-up (eager warm-up, first
    steps) are not read."""
    trace_port = port().utils.trace
    trace_port.enable()
    fit = None
    try:
        fit = Fit(inputs, cell["config"], cell["traffic"]["form"], task=cell["task"])
        for _ in range(FIRST_STEPS):            # as the window's fit, before it
            fit.step()
        trace_port.clear()
        for _ in range(SPAN_STEPS):
            fit.step()
            trace_port.sample()
        return trace_port.device_ms()
    finally:
        trace_port.disable()
        if fit is not None:
            fit.drop()


def metric_values(entries, ctx):
    out = {}
    for m in entries:
        value = spec.reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = dict(value=value, unit=m["unit"])
        else:
            log(f"[metric] {m['name']}: not measured in this run")
    return out


def log_phases(phases):
    """Print the seconds of each set-up phase."""
    log("[setup] " + ", ".join(f"{name} {b - a:.3f} s"
                               for (_, a), (name, b) in zip(phases, phases[1:])))


def cell_with(name, overrides=None, workload=None, home=None):
    """The cell (``spec.cell``), its configuration updated with
    ``overrides`` (the tests' smaller sizes)."""
    cell = spec.cell(name, workload, home)
    cell["config"].update(overrides or {})
    return cell


def single(name, seed, seconds, trace_on, started, device="cuda", overrides=None, fault=None,
           workload=None, home=None):
    """One run of a single-device cell; returns the result line (a dict).
    ``device``, ``overrides``, ``fault``, ``workload`` and ``home``
    (``spec.cell``): the tests' CPU runs."""
    cell = cell_with(name, overrides, workload, home)
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    phases = [("start", started), ("imports", time.time())]
    if cuda:
        build_kernels()
        device = torch.device("cuda", 0)
        torch.cuda.init()
    phases.append(("kernels", time.time()))
    inputs = make_inputs(cfg, seed, device, cell["task"])
    phases.append(("inputs", time.time()))
    stages = Stages() if trace_on and traffic["form"] == "whole" and cuda else None
    fit = Fit(inputs, cfg, traffic["form"], stages, fault=fault, task=cell["task"])
    phases.append(("capture", time.time()))
    marks = fit.setup_seconds
    log("[capture] " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:])))
    first = fit.first_steps(FIRST_STEPS)
    phases.append(("first steps", time.time()))
    log_phases(phases)
    if cuda:
        clocks.log("before window")
    if not trace_on:
        w = window(fit.step, device, lambda n, elapsed: elapsed < seconds)
    else:
        w = traced_window(fit, time_steps(fit.step, 5, device), stages is not None)
        counters = port().utils.trace.counters()
    if cuda:
        clocks.log("after window")
    attempted, failed = w["steps"], int(fit.nonfinite)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    host_ms = trace.host_ms(fit.parts(), HOST_STEPS, device) if trace_on else None
    labels = stages.captured + [UPDATE] if stages is not None else None
    program = program_readings(first)
    fit.drop()
    del fit
    free(device)

    traced = None
    if not trace_on:
        metrics = end_to_end(cell, inputs, [w], started, peak)
    else:
        spans = span_ms(inputs, cell)
        free(device)
        log(f"[spans] device ms a step of the port's spans: {spans}")
        work = cell["task"].step_work(cfg, inputs, program["params0"])
        ctx = dict(kind=device_kind(device), busy_us=[w["busy_us"]],
                   window_us=[w["window_us"]], host_ms=[host_ms], nccl_ms=[w["nccl_ms"]],
                   step_ms=w["step_ms"], work=work, stages=None, counters=counters,
                   spans=spans)
        if labels is not None:
            ctx["stages"] = stage_ms(w["trace"]["records"], labels, w["steps"])
            log(f"[stages] ms per step: {ctx['stages']}")
        log(f"[work] bytes, operations of each function a step: {ctx['work']}")
        metrics = metric_values(cell["per_layer"], ctx)
        traced = dict(busy_us=w["busy_us"], window_us=w["window_us"],
                      breakdown=trace.breakdown(w["trace"]))
    ref = reference_run(cell, inputs, program["params0"])
    numbers = check.readings(program, ref, cfg["optimizer"]["beta1"])
    return finish(cell, numbers, attempted, failed, metrics, 1, peak, traced, device)


def free(device):
    """Collect what was dropped and hand the cached blocks back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def device_kind(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def end_to_end(cell, inputs, windows, started, peak):
    """The end-to-end metrics from the windows of the cards (each a dict of
    :func:`window`): output pixels over the longest window, the 95th
    percentile of each step's slowest card, the peak, the set-up."""
    steps = windows[0]["steps"]
    per_step = [max(ms) for ms in zip(*(w["step_ms"] for w in windows))]
    seconds = max(w["seconds"] for w in windows)
    pixels = steps * inputs["batch"] * inputs["image_size"] ** 2
    rate, p95 = pixels / seconds, timeline.percentile(per_step, 95.0)
    values = dict(pixels_per_s=rate, step_ms_p95=p95, peak_mem_mib=peak / MIB,
                  setup_s=windows[0]["start"] - started)
    log(f"[steps] {steps} steps in {seconds:.6f} s, step ms median "
        f"{timeline.percentile(per_step, 50.0):.6f} p95 {p95:.6f} "
        f"max {max(per_step):.6f}")
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in cell["end_to_end"]}


def finish(cell, numbers, attempted, failed, metrics, count, peak, traced, device):
    """The result line, the numbers compared beside their limits last."""
    limits = cell["limits"]["limits"]
    correct, checks = check.judge(numbers, limits)
    correct = correct and failed == 0
    for k, c in checks.items():
        log(f"[check] {k} {c['value']!r} limit {c['limit']!r}")
    platform = "gpu" if device.type == "cuda" else "cpu"
    info = dict(platform=platform, kind=device_kind(device), count=count,
                memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics,
                  device=info)
    if traced is not None:
        info.update(busy_s=traced["busy_us"] / 1e6, window_s=traced["window_us"] / 1e6)
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result
