"""What one step of ``bench`` dispatches, in each of its forms (the port's
counterpart of the JAX package's ``benchmarks/kernel_census.py``, which
lists the compiled step's kernels).

    python -m neural_renderer_v2_pytorch_tpu_torch.benchmarks.kernel_census

For ``bench.py``'s step on the card, in its three forms (eager, the
graphed core, the whole step captured by its caller): the device
operations by name and records per step (the profiler over STEPS (10)
steps), the port's kernels by ``resolve_cuda.LAUNCHES`` (counted as the
eager step runs them, and for a graph at its capture) and the operations
that reach the dispatcher with a tensor on the card (``steps.EagerOps``):
in the graphed core, what stays eager around the replays; a replayed whole
step dispatches none.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch

from ..ops import graphs
from ..ops import resolve_cuda as rc
from . import bench, steps

NAME_CHARS = 90
STEPS = 10


def dispatched(step, device_type):
    """(the launches of the port's kernels, the operations dispatched with a
    tensor of ``device_type``: {name: count}, the views among them) in one
    call of ``step``."""
    rc.reset_launches()
    watch = steps.EagerOps(device_type)
    with watch:
        step()
    return ({k: n for k, n in rc.LAUNCHES.items() if n}, dict(watch.ops), dict(watch.views))


def eager_form(case, device_type):
    """The eager form's launches and dispatched operations (on any device),
    in a step after a first one, which makes what is kept per faces tensor
    (its int32 copy, K4's table)."""
    def eager_step():
        with graphs.eager():
            return case.step()

    eager_step()
    launches, ops, views = dispatched(eager_step, device_type)
    return eager_step, dict(launches=launches, dispatched=ops, views=views)


def device_ops(fn, n, launched=None):
    """{name: records per step} of ``fn``'s device operations (the
    profiler's), their total and whether every record was kept."""
    prof = steps.profile_device(fn, n, launched=launched)
    ops = collections.Counter()
    for name, (per_call, _) in prof.records.items():
        ops[name[:NAME_CHARS]] += per_call
    return dict(device_ops=dict(ops.most_common()), device_op_total=prof.ops,
                every_record_kept=prof.complete)


def census(case, n):
    """The three forms' census of ``case`` on the card."""
    eager_step, eager = eager_form(case, "cuda")
    eager.update(device_ops(eager_step, n))
    for _ in range(3):                          # eager, capture, replay
        case.step()
    graph = steps.case_graph(case)
    held = collections.Counter(graph.launches["forward"])
    held.update(graph.launches.get("backward", {}))
    _, left, views = dispatched(case.step, "cuda")
    core = dict(launches=dict(held), dispatched=left, views=views,
                **device_ops(case.step, n, launched=dict(held)))
    whole = steps.CallerGraph(case)
    _, replayed, _ = dispatched(whole.graph.replay, "cuda")
    if replayed:
        raise AssertionError(f"a replayed whole step dispatched {replayed}")
    return {"eager": eager, "core": core,
            "whole": dict(launches=whole.launches, dispatched={},
                          **device_ops(whole, n, launched=whole.launches))}


def run(device, n=STEPS):
    name, power_limit = steps.card()
    forms = census(bench.scene(device).case("bench"), n)
    for form, c in forms.items():
        print(f"[census] bench {form}: {c['device_op_total']:.1f} device operations per step "
              f"({'every record kept' if c['every_record_kept'] else 'records dropped'}), "
              f"launches {c['launches']}, {sum(c['dispatched'].values())} operations dispatched "
              f"with a tensor on the card  ({name}, {power_limit})", flush=True)
        for op, count in c["device_ops"].items():
            print("  %6.1f  %s" % (count, op), flush=True)
    return dict(module="kernel_census", device=name, power_limit=power_limit, replays=n,
                forms=forms)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if steps.needs_card("kernel_census"):
        return steps.NO_CARD
    steps.build_kernels()
    steps.emit(run(torch.device("cuda:0")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
