"""Device ms per step of the NMR passes: weight planes + NMR forward,
NMR coordinate gradients, flip/pool and the pool VJP."""

from portbench.harness.stages import NMR


def read(ctx):
    stages = ctx.get("stages")
    if not stages or any(s not in stages for s in NMR):
        return None
    return sum(stages[s] for s in NMR)
