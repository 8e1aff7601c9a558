"""Overflow bins a step on the binned route: the overflow bins that K7's
capped binnings counted (the port's counts, ``harness.trace.bin_counts``:
copied right after the traced window) over the binnings, over the run up
to then (set-up, first steps, window); a cell whose step renders once
bins once a step.  An overflow bin is resolved by K8 over every face:
exact, slower."""

from portbench.harness.trace import bin_counts


def read(ctx):
    counts = bin_counts(ctx)
    return None if counts is None else counts["overflow_bins"] / counts["binnings"]
