"""NCCL device ms per step, summed over the kinds, on the rank that
waited least (a rank's NCCL kernel also waits for its slowest peer, so
the least is nearest the transfers' own time)."""


def read(ctx):
    values = [v for v in ctx.get("nccl_ms") or () if v]
    return min(values) if values else None
