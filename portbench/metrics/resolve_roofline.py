"""The resolve's bound (bytes moved once, 30 operations per (pixel, face)
bounding-box test, at the card's HBM and float32 peaks) over the device
ms per step of the resolve's stage, in percent."""

from portbench.harness.stages import RESOLVE
from portbench.yardstick import roofline


def read(ctx):
    stages, work = ctx.get("stages"), ctx.get("work")
    if not stages or not work or not stages.get(RESOLVE):
        return None
    bound, _ = roofline.bound_ms(*work["resolve"], kind=ctx["kind"])
    return 100.0 * bound / stages[RESOLVE]
