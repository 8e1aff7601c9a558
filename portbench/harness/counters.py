"""The program's own counters, read in the process that ran the window."""

from __future__ import annotations


def bin_counts():
    """The port's counts of K7's capped binnings since the process started
    (``ops.graphs.bin_counters``: dict(binnings, pairs, slots,
    overflow_bins), kept on the card by K7 itself at every replay of a
    graph that holds one, a caller's capture too); None where the port
    keeps no such counts or made no capped binning (the tiled route)."""
    from .fit import port

    read = getattr(port().ops.graphs, "bin_counters", None)
    counts = read() if read is not None else None
    return counts if counts and counts.get("binnings") else None
