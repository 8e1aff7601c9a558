"""Share of the pair slots that K7's capped binnings reserved (their
capacities, fixed at capture) that their pairs used: pairs made over
slots, in percent, over the whole run (the port's counts,
``harness.counters``).  Above 100% the bins overflow."""

from portbench.harness.counters import bin_counts


def read(ctx):
    counts = bin_counts()
    return None if counts is None or not counts["slots"] else (
        100.0 * counts["pairs"] / counts["slots"])
