#!/usr/bin/env python3
"""Time the sharded phase of a checkout of the port on one CUDA card:
that checkout's own ``chip_smoke.sharded_runs``, which holds every sharded
run to the single-device step and times each rank's steps and their
collectives, on ranks that share the card through gloo.

    python3 tools/sharded_times.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``chip_smoke.py`` and package are
imported (default: the one that holds this script), so that a change and
its parent, unpacked under ``tmp/``, can be timed in turns on one card,
each in a process of its own (parent, change, change, parent).  Each
checkout builds its kernels into its own ``build/``.

The last line of the output is one JSON object: the card's name and power
limit and, for each sharded run, its mesh and each rank's step and
collective ms (medians of the run's timed steps, and every step; by kind
where the checkout's ``chip_smoke`` records them; the eager step's, and
the graphed core's where the checkout has one, timed in turns); the
single-device steps' ms are in the ``[time]`` lines above it.  It is also written to FILE when given.  Without CUDA the
script fails.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout to time")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # first on the path, so that the spawned ranks (which inherit it) import
    # the same chip_smoke and package
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sharded_times: CUDA is not available", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise RuntimeError(f"imported {cs.__file__}, not the checkout at {root}")
    cs.cuda_build.build()
    cs.cuda_build.load()          # built once here; the ranks only load it
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    runs, _ = cs.sharded_runs(torch.device("cuda:0"), smi)
    out = {"root": os.path.relpath(root, HERE), "card": smi, "runs": {
        name: {"mesh": list(cs.SHARDED[name]), "ranks": [
            dict({"step_ms": float(np.median(r["ms"])),
                  "collective_ms": float(np.median(r["coll_ms"])),
                  "steps_ms": r["ms"], "collectives_ms": r["coll_ms"],
                  "collective_ms_by_kind": r.get("kind_ms")},
                 **({} if "graphed_ms" not in r else {
                     "graphed_step_ms": float(np.median(r["graphed_ms"])),
                     "graphed_collective_ms": float(np.median(r["graphed_coll_ms"])),
                     "graphed_steps_ms": r["graphed_ms"],
                     "graphed_collectives_ms": r["graphed_coll_ms"],
                     "graphed_collective_ms_by_kind": r["graphed_kind_ms"]}))
            for r in ranks]}
        for name, ranks in runs.items()}}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
