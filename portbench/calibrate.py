"""The readings that a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <name> --seeds <n> --first-seed <s> \\
        [--controls <n>] [--out <file>]

Everything of the configuration's own comes from its task and reference
(``tasks/<reference>.py``, ``reference/<reference>.py``, found by
``spec``), so a configuration added as files alone is calibrated by this
script as it stands:

- the program: ``--seeds`` seeds, each through the step the window runs
  (one capture, the inputs of each seed copied into it), its first three
  steps against the reference's;
- the control: the reference computed in the precision below the
  configuration's (bfloat16 for float32) put in the program's place, on ``--controls`` seeds, against the float32 reference;
- the faults, planted in the reference put in the program's place, on the
  same seeds: half of the images left out (the loss the mean over the
  rest), the first image inverted where it is produced.  A state left
  unchanged reads 1 by the comparison's measure and is not run.

A sharded cell's program readings come from its ranks (one per card);
its control and faults are its configuration's, read on card 0.  Prints
one JSON line per reading and writes them all to ``--out``.
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

FAULTS = ("half_batch", "altered")


def emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def program_seeds(name, seeds, device):
    """(seed, the program's first steps) of each seed, through one Fit."""
    import torch

    from portbench.harness import runner
    from portbench.harness.fit import Fit
    from portbench.harness.scene import make_inputs

    cell = runner.cell_with(name)
    cfg = cell["config"]
    fit = None
    out = []
    for seed in seeds:
        inputs = make_inputs(cfg, seed, device, cell["task"])
        if fit is None:
            fit = Fit(inputs, cfg, cell["traffic"]["form"], task=cell["task"])
        else:
            fit.reset(inputs)
        out.append((seed, runner.program_readings(fit.first_steps(runner.FIRST_STEPS))))
    fit.drop()
    torch.cuda.empty_cache()
    return out


def rank_seeds(name, seeds):
    """One rank's program readings of each seed, through its sharded step."""
    import torch

    from portbench.harness import runner, sharded
    from portbench.harness.fit import Fit, port
    from portbench.harness.scene import make_inputs

    cell = runner.cell_with(name)
    cfg = cell["config"]
    port().utils.cuda_build.load()
    device = torch.device("cuda", torch.cuda.current_device())
    fit, out = None, []
    for seed in seeds:
        inputs = make_inputs(cfg, seed, device, cell["task"])
        sharded.broadcast_leaves(inputs)
        if fit is None:
            fit = Fit(inputs, cfg, "sharded", mesh=cell["traffic"]["mesh"], task=cell["task"])
            for _ in range(3):
                fit.backward()
        else:
            fit.reset(inputs)
        out.append((seed, runner.program_readings(fit.first_steps(runner.FIRST_STEPS))))
    fit.drop()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args()

    import torch

    from portbench.harness import check, runner, sharded
    from portbench.harness.scene import CONTROLS, make_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = runner.cell_with(args.workload)
    cfg, traffic = cell["config"], cell["traffic"]
    beta1 = cfg["optimizer"]["beta1"]
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    device = torch.device("cuda", 0)
    rows = []
    t0 = time.time()
    if traffic["form"] == "sharded":
        from portbench.harness.fit import port

        mesh = traffic["mesh"]
        world = mesh["data"] * mesh["tile"] * mesh["face"]
        ranks = port().parallel.run_ranks(rank_seeds, world, (args.workload, seeds),
                                          device="cuda", timeout=600.0)
        by_seed = list(zip(*ranks))
        programs = [(r[0][0], [p for _, p in r]) for r in by_seed]
    else:
        runner.build_kernels()
        programs = [(s, [p]) for s, p in program_seeds(args.workload, seeds, device)]
    print(f"[calibrate] program steps of {len(seeds)} seeds in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    for i, (seed, progs) in enumerate(programs):
        inputs = make_inputs(cfg, seed, device, cell["task"])
        params0 = progs[0]["params0"]
        t1 = time.time()
        ref = runner.reference_run(cell, inputs, params0)
        ref_s = time.time() - t1
        if len(progs) > 1:
            numbers = sharded.ranks_readings(progs, ref, beta1)
        else:
            numbers = check.readings(progs[0], ref, beta1)
        emit(rows, dict(kind="program", seed=seed, reference_s=ref_s, losses=ref["losses"],
                        **numbers))
        if i < args.controls:
            runs = [("control", dict(dtype=CONTROLS[cfg["dtype"]]))]
            runs += [(f, dict(fault=f)) for f in FAULTS]
            for kind, how in runs:
                other = runner.reference_run(cell, inputs, params0, **how)
                as_program = dict(params0=params0, losses=torch.tensor(other["losses"]),
                                  m1={n: g.cpu() * (1.0 - beta1)
                                      for n, g in other["grad1"].items()},
                                  params={n: t.cpu() for n, t in other["params"].items()})
                emit(rows, dict(kind=kind, seed=seed,
                                **check.readings(as_program, ref, beta1)))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
