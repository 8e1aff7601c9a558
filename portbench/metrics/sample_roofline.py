"""The texture sampler's bound (``yardstick/sampler.py``: the bytes of its
covered pixels and of each atlas once, at the card's HBM and float32
peaks) over its device ms per step (``sample_span_ms``), in percent."""

from portbench.metrics.sample_span_ms import read as sample_ms
from portbench.yardstick import roofline


def read(ctx):
    ms, work = sample_ms(ctx), ctx.get("work")
    if not ms or not work or "sample" not in work:
        return None
    bound, _ = roofline.bound_ms(*work["sample"], kind=ctx["kind"])
    return 100.0 * bound / ms
