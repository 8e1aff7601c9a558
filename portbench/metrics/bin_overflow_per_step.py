"""Overflow bins a step on the binned route: the overflow bins that K7's
capped binnings counted (the port's counts, ``harness.counters``) over
the binnings, over the whole run (set-up, first steps, window); a cell
whose step renders once bins once a step.  An overflow bin is resolved by
K8 over every face: exact, slower."""

from portbench.harness.counters import bin_counts


def read(ctx):
    counts = bin_counts()
    return None if counts is None else counts["overflow_bins"] / counts["binnings"]
