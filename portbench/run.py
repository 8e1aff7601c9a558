"""Benchmark of the PyTorch + CUDA port (``neural_renderer_v2_pytorch_tpu_torch``).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(kernels built or loaded, inputs made from the seed, the step captured and
warmed, its first three steps taken), then a window of ``--seconds`` of
steps in a closed loop (``--trace 0``: the end-to-end metrics) or a short
profiled window (``--trace 1``: the per-layer metrics, with the port's
spans read over a second fit once the window's is dropped), then the
first steps compared with the plain reference.  The last line of standard output
is one JSON object; the numbers compared, beside their limits, are the last
lines of standard error and the result's last key.

Exits 3, printing no result, without as many CUDA cards as the cell asks
for; 4 when a module of JAX or the JAX package is loaded once the window has
closed, in this process or in any rank that ran the window.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NO_CARD, FORBIDDEN_LOADED = 3, 4


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import runner, sharded, spec

    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available; "
              "nothing was run", file=sys.stderr)
        return NO_CARD
    from portbench.harness.fit import port

    port()                      # the program: a checkout without it has no run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    how = sharded.run if cell["traffic"]["form"] == "sharded" else runner.single
    return report(how, args.workload, args.seed, args.seconds, bool(args.trace), STARTED)


def report(how, *args, **kwargs):
    """``how(*args, **kwargs)``, then its result line; no result, and the
    exit code 4, where this process or a rank that ran the window holds a
    module of JAX or the JAX package."""
    from portbench.harness import runner

    try:
        result = how(*args, **kwargs)
        bad = runner.forbidden_modules()
    except runner.ForbiddenLoaded as e:
        bad = e.modules
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
