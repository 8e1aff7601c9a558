"""Device ms per step of the pixel -> face scatter (K3): the port's span
``resolve.vjp`` (``utils/trace.py``: the time between its own two marks,
its kernels and the gaps between them), read by ``trace.sample()`` after
each replay of a second fit of the cell's task, captured with tracing
on once the traced window's fit is dropped."""


def read(ctx):
    spans = ctx.get("spans")
    return spans.get("resolve.vjp") if spans else None
