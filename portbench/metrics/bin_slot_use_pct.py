"""Share of the pair slots that K7's capped binnings reserved (their
capacities, fixed at capture) that their pairs used: pairs made over
slots, in percent, over the run up to the traced window's end (the port's
counts, ``harness.trace.bin_counts``).  Above 100% the bins overflow."""

from portbench.harness.trace import bin_counts


def read(ctx):
    counts = bin_counts(ctx)
    return None if counts is None or not counts["slots"] else (
        100.0 * counts["pairs"] / counts["slots"])
