"""Host ms to enqueue one step: each of the step's host calls timed on an
idle device (a replay's launch, the update op by op), summed; averaged
over the cards' ranks."""


def read(ctx):
    values = [v for v in ctx["host_ms"] if v is not None]
    return sum(values) / len(values) if values else None
