#!/usr/bin/env python3
"""Time the texture-atlas gradient (K6 and what runs around it) and the
steps beside it, of a checkout of the port on one CUDA card.

    python3 tools/atlas_grad_times.py [--root DIR] [--out FILE]

``--root`` names the checkout whose package is imported (default: the one
that holds this script), so that a change and its parent, unpacked under
``tmp/``, can be timed in turns on one card, each in a process of its own
(parent, change, change, parent).  That checkout's package must have the
``benchmarks`` subpackage.  Measured with its own modules:

- ``scaling``'s rows "atlas 3x1190x1920 256^2 AA, atlas gradients", "atlas
  3x1190x1920 256^2 AA" (the vertices' step), "silhouette 256^2 AA bs=1"
  and "silhouette 512^2 level 3": each step's three forms in turns
  (``scaling.time_row``: ms, busy share, device operations);
- ``prof``'s stages of the atlas's gradient step, captured whole by its
  caller and replayed under the profiler, named by the port's spans
  (``utils/trace.py``): K6's is the span ``atlas.vjp`` (K6 and its zero
  fill), its device ms;
- the device ms per step of each of the port's kernels in that step
  replayed under the profiler (``roofline.kernels_device_ms``): K6's own
  time.

The last line of the output is one JSON object, also written to FILE when
given.  Without CUDA the script fails.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATLAS_ROW = "atlas 3x1190x1920 256^2 AA, atlas gradients"
ROWS = (ATLAS_ROW, "atlas 3x1190x1920 256^2 AA", "silhouette 256^2 AA bs=1",
        "silhouette 512^2 level 3")
REPLAYS = 10


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose package is timed")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("atlas_grad_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import neural_renderer_v2_pytorch_tpu_torch as nr
    from neural_renderer_v2_pytorch_tpu_torch.benchmarks import prof, roofline, scaling, steps

    if not os.path.abspath(nr.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {nr.__file__}, not the package under {root}")
    dev = torch.device("cuda:0")
    steps.build_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = steps.card()
    result = dict(root=os.path.relpath(root, HERE), smi=smi, torch=torch.__version__)
    rows = {r.label: r for r in scaling.ROWS}
    result["rows"] = [scaling.time_row(rows[label], dev, card) for label in ROWS]
    case = scaling.case(rows[ATLAS_ROW], dev)
    times = prof.stage_times(case, REPLAYS)
    k6_ms = times["stages"][prof.ATLAS_STAGE]
    whole = steps.CallerGraph(case)
    kernels = roofline.kernels_device_ms(
        steps.profile_device(whole, REPLAYS, launched=whole.launches))
    result["stages"] = times
    result["k6_stage"] = dict(ms=k6_ms, port_kernels_ms=kernels)
    print(f"[atlas grad] {result['root']}: K6's stage {k6_ms:.6f} ms, whole step "
          f"{times['total_ms']:.6f} ms in its stages (every stage read: "
          f"{times['every_span_read']}); port kernels {json.dumps(kernels)}  ({smi})",
          flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
