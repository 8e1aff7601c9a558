"""The whole step's share of the card's peak: the bounds of the step's
counted functions (face-vertex gather, resolve, pixel -> face scatter,
vertex gradient sum; each the larger of its bytes at the HBM rate and its
operations at the float32 rate) over the traced window's ms per step, in
percent.  It counts functions, not kernels, so a kernel taken off the
path still counts its function's work."""

from portbench.yardstick import roofline


def read(ctx):
    work, step_ms = ctx.get("work"), ctx.get("step_ms")
    if not work or not step_ms:
        return None
    bound = sum(roofline.bound_ms(*w, kind=ctx["kind"])[0] for w in work.values())
    return 100.0 * bound / step_ms
