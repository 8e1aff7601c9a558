"""Device ms per step of the lights, forward and backward: the port's
spans ``lights`` (the smoothed vertex normals, then the per-pixel normals
and the lights' colour weight) and ``lights.vjp``, summed, read as
``sample_span_ms`` reads its spans.  None where the port has no such
span."""

SPANS = ("lights", "lights.vjp")


def read(ctx):
    spans = ctx.get("spans")
    if not spans or any(s not in spans for s in SPANS):
        return None
    return sum(spans[s] for s in SPANS)
