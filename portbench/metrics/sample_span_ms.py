"""Device ms per step of the texture sampler, forward and backward: the
port's spans ``sample`` and ``sample.vjp`` (which holds K6's
``atlas.vjp``), summed, each read by ``trace.sample()`` after each replay
of a second fit of the cell's task, captured with tracing on once the
traced window's fit is dropped.  None where the port has no such span."""

SPANS = ("sample", "sample.vjp")


def read(ctx):
    spans = ctx.get("spans")
    if not spans or any(s not in spans for s in SPANS):
        return None
    return sum(spans[s] for s in SPANS)
