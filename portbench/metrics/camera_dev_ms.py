"""Device ms per step of the camera and its VJP: the records between the
markers of those two stages in a profile of replays."""

from portbench.harness.stages import CAMERA


def read(ctx):
    stages = ctx.get("stages")
    if not stages or any(s not in stages for s in CAMERA):
        return None
    return sum(stages[s] for s in CAMERA)
